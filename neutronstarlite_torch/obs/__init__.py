"""Run metrics (the observability plane) — port of ``neutronstarlite_tpu/obs``.

The same typed JSONL stream as the reference, under the same environment
variables, and records that validate under the reference's schema:

- :class:`MetricsRegistry` — counters, gauges, timing summaries and the
  per-run JSONL event stream under ``NTS_METRICS_DIR``
  (``NTS_METRICS_MAX_MB`` rotation);
- :mod:`collectors` — device memory (the CUDA caching allocator),
  first-vs-steady epoch attribution, phase-timer snapshots, the kernel
  build cache;
- :mod:`schema` — the event schema and its validator (copied);
- :mod:`trace` — span tracing (``NTS_TRACE=0`` disables it), with
  ``torch.profiler.record_function`` scopes while an ``NTS_PROFILE_DIR``
  trace records;
- :mod:`hist` — log-bucketed mergeable histograms (copied);
- :mod:`slo` — ``NTS_SLO_SPEC`` objectives as burn rates (copied; the
  trainers tick the ``train`` scope per epoch);
- :mod:`flight` — the flight recorder dumped on fault, breach or SIGUSR2
  (copied);
- :mod:`cost` — ``program_cost`` records counted over one real step
  (``NTS_PROGRAM_COST``);
- :mod:`ledger` — the cross-run perf ledger (``NTS_LEDGER_DIR``);
- :mod:`numerics` — ``NTS_NUMERICS`` tensor stats and the non-finite
  provenance replay;
- :mod:`exporter` — the ``NTS_METRICS_PORT`` scrape endpoint (``/metrics``,
  ``/healthz``, ``/slo``, ``/telemetry``; copied), started by the trainers
  and the serving stack.

Left for later slices: the telemetry hub and its HTTP client (cross-host
serving), the clock-skew join (distributed), the report tools, and the
wire quantization probe.
"""

from neutronstarlite_torch.obs.cost import capture_program_cost
from neutronstarlite_torch.obs.hist import LogHistogram
from neutronstarlite_torch.obs.registry import (
    MetricsRegistry,
    config_fingerprint,
    metrics_dir,
    open_run,
)
from neutronstarlite_torch.obs.schema import SCHEMA_VERSION, validate_event
from neutronstarlite_torch.obs.trace import Tracer

__all__ = [
    "LogHistogram",
    "MetricsRegistry",
    "SCHEMA_VERSION",
    "Tracer",
    "capture_program_cost",
    "config_fingerprint",
    "metrics_dir",
    "open_run",
    "validate_event",
]

