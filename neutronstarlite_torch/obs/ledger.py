"""The cross-run perf ledger: an append-only trajectory of measurements —
port of ``neutronstarlite_tpu/obs/ledger.py``, copied; ``backend_fingerprint``
names the torch and CUDA versions and the card instead of jax's backend.

Every measurement surface before this was pairwise and ephemeral —
``metrics_report --diff`` compares exactly two runs and forgets both.
The ledger turns point measurements into a TRAJECTORY: one JSONL row per
run under ``NTS_LEDGER_DIR``, carrying the scalars a regression gate
actually consults (warm epoch time, wire counters, hist quantiles,
program costs), keyed by what makes two rows comparable:

  graph_digest  — canonical graph content (graph/digest.py); structure
                  changed = different workload, rows never compare
  cfg           — the config fingerprint (obs/registry.config_fingerprint)
  backend       — torch version / CUDA version / device name x count
                  (backend_fingerprint); different silicon or runtime =
                  different baseline

Row kinds: ``run`` (a trainer finished — models/base.finalize_metrics),
``suite`` (one tier-1 suite execution — scripts/ci_tier1.sh), ``probe``
(one bench.py backend-probe attempt, INCLUDING timeouts, so the probe
history is queryable), ``serve``
(one tools/serve_bench execution: tail latency + shed rate keyed by cfg
fingerprint PLUS the load shape — mode/replicas/continuous-batching —
so the sentinel trend-gates serve p99 the way it gates epoch time
without ever comparing a 3-replica open-loop run against a 1-replica
closed-loop one).

Appends are ATOMIC via the checkpoint tmp+replace pattern: the new state
(existing rows + the new row, trimmed to ``NTS_LEDGER_KEEP``) is written
to a tmp file and ``os.replace``d over the ledger, so a crashed writer
can never leave a torn final line under the real name. Two concurrent
writers race last-replace-wins (one row may be lost, never corrupted) —
acceptable for a per-rig measurement log; readers tolerate and warn on
any torn line regardless. The ledger never raises into a run: every
failure path degrades to a warning.

``tools/perf_sentinel.py`` is the consumer: baseline = median of the
last K matching rows with MAD-scaled tolerance — the trend-aware
replacement for pairwise --diff gating.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

LEDGER_SCHEMA_VERSION = 1
LEDGER_FILENAME = "ledger.jsonl"
_DEFAULT_KEEP = 2000


def ledger_dir() -> Optional[str]:
    """``NTS_LEDGER_DIR``, or None (ledger disabled)."""
    return os.environ.get("NTS_LEDGER_DIR") or None


def ledger_keep() -> int:
    """Max retained rows (``NTS_LEDGER_KEEP``, default 2000, min 1) —
    the oldest rows are trimmed at append time, so the file is bounded
    like every other artifact this repo persists."""
    raw = os.environ.get("NTS_LEDGER_KEEP", "")
    if not raw:
        return _DEFAULT_KEEP
    try:
        return max(int(raw), 1)
    except ValueError:
        log.warning("bad NTS_LEDGER_KEEP=%r; using %d", raw, _DEFAULT_KEEP)
        return _DEFAULT_KEEP


def ledger_path(directory: Optional[str] = None) -> Optional[str]:
    d = directory or ledger_dir()
    return os.path.join(d, LEDGER_FILENAME) if d else None


def backend_fingerprint() -> str:
    """What the measurement was taken on: the torch version, the CUDA
    version, the device name and the visible device count, e.g.
    ``torch-2.11.0+cu128/cuda-12.8/NVIDIA H100 80GB HBM3x1`` (``cpux1``
    without a card). Degrades to "unknown": the ledger never raises into a
    run."""
    try:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0)
            count = torch.cuda.device_count()
        else:
            kind, count = "cpu", 1
        return f"torch-{torch.__version__}/cuda-{torch.version.cuda}/{kind}x{count}"
    except Exception as e:
        log.warning("ledger backend fingerprint unavailable: %s", e)
        return "unknown"


def as_number(v) -> Optional[float]:
    """float(v) for real numbers, None otherwise (bools excluded) — the
    one scalar coercer the ledger's consumers (perf_sentinel,
    drift_audit) share so their notions of "a gateable value" can never
    drift apart."""
    return float(v) if isinstance(v, (int, float)) and not isinstance(
        v, bool
    ) else None


def row_key(row: Dict[str, Any]) -> tuple:
    """The comparability key two rows must share to sit on one
    trajectory (kind rides along: a suite row never baselines a run)."""
    return (
        row.get("kind"),
        row.get("graph_digest"),
        row.get("cfg"),
        row.get("backend"),
    )


def read_rows(directory: Optional[str] = None,
              path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All parseable rows, oldest first. Torn/invalid lines are warned
    and skipped (a crashed pre-atomic writer, or a hand-edited file) —
    the sentinel gates on what survives."""
    p = path or ledger_path(directory)
    if not p or not os.path.exists(p):
        return []
    rows: List[Dict[str, Any]] = []
    try:
        with open(p, "r", encoding="utf-8") as fh:
            for ln, raw in enumerate(fh, 1):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as e:
                    log.warning("ledger %s:%d: skipping torn row (%s)",
                                p, ln, e)
                    continue
                if not isinstance(row, dict) or "kind" not in row:
                    log.warning("ledger %s:%d: skipping non-row line", p, ln)
                    continue
                rows.append(row)
    except OSError as e:
        log.warning("ledger %s unreadable (%s)", p, e)
        return []
    return rows


def append_row(row: Dict[str, Any],
               directory: Optional[str] = None) -> Optional[str]:
    """Atomically append one row (tmp+replace over the full trimmed
    state — the checkpoint pattern: a crashed writer can never tear a
    line under the real name); returns the ledger path, or None when the
    ledger is disabled or the write failed (warned, never raised).

    The existing rows are carried over as RAW LINES (no per-append JSON
    re-parse of up to NTS_LEDGER_KEEP multi-KB rows — this runs on every
    finalize and every probe attempt); only the new row is serialized.
    Trimming counts lines, which over-counts by at most the torn lines
    readers already skip."""
    d = directory or ledger_dir()
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, LEDGER_FILENAME)
        lines: List[str] = []
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        lines.append(json.dumps(
            dict(row, ledger_schema=LEDGER_SCHEMA_VERSION), default=str
        ))
        keep = ledger_keep()
        if len(lines) > keep:
            lines = lines[-keep:]
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
        os.replace(tmp, path)  # the commit point: readers see all or nothing
        return path
    except OSError as e:
        log.warning("ledger append to %s failed (%s); row dropped", d, e)
        return None


# ---- rows ---------------------------------------------------------------------


def _hist_quantiles(summary: Dict[str, Any]) -> Dict[str, Any]:
    """{hist name: {count, p50, p95, p99}} from a run_summary's embedded
    histogram snapshots — the quantiles, not the full bucket arrays (the
    ledger is a scalar trajectory, not a second stream)."""
    out: Dict[str, Any] = {}
    hists = summary.get("hists")
    if not isinstance(hists, dict):
        return out
    try:
        from neutronstarlite_torch.obs.hist import LogHistogram

        for name, d in hists.items():
            h = LogHistogram.from_dict(d)
            q = h.quantiles()
            out[name] = {"count": h.count, **q}
    except Exception as e:
        log.warning("ledger hist quantiles unavailable: %s", e)
    return out


def run_row(
    summary: Dict[str, Any],
    graph_digest: Optional[str],
    probes: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """One ``kind=run`` row from a finalized run_summary record. The
    scalars mirror what ``--diff`` gates on (plus the new program
    costs), so the sentinel replaces --diff without losing a metric."""
    counters = summary.get("counters") or {}
    gauges = summary.get("gauges") or {}
    et = summary.get("epoch_time") or {}
    epochs = summary.get("epochs") or 0
    wire = counters.get("wire.bytes_fwd")
    stall = counters.get("sample.stall_ms")
    h2d = counters.get("sample.h2d_bytes")
    return {
        "kind": "run",
        "ts": time.time(),
        "run_id": summary.get("run_id"),
        "algorithm": summary.get("algorithm"),
        "cfg": summary.get("fingerprint"),
        "graph_digest": graph_digest,
        "backend": backend_fingerprint(),
        "epochs": epochs,
        "warm_median_epoch_s": et.get("warm_median_s"),
        "first_epoch_s": et.get("first_s"),
        "avg_epoch_s": summary.get("avg_epoch_s"),
        "wire_bytes_fwd_per_epoch": (
            wire / epochs if wire is not None and epochs > 0 else None
        ),
        "sample_stall_ms_per_epoch": (
            stall / epochs if stall is not None and epochs > 0 else None
        ),
        "sample_h2d_bytes_per_epoch": (
            h2d / epochs if h2d is not None and epochs > 0 else None
        ),
        "edge_hbm_bytes_per_epoch": gauges.get(
            "kernel.edge_hbm_bytes_per_epoch"
        ),
        # numerics plane (obs/numerics): the run's final grad-norm
        # trajectory point (perf_sentinel's ADVISORY two-sided leg — a
        # norm drifting off its own history in either direction is an
        # optimization-health signal, not a perf regression) and the
        # measured wire quantization error (lower-is-better, gated)
        "grad_global_norm": gauges.get("numerics.grad_global_norm"),
        "wire_quant_rel_err": gauges.get("wire.quant_rel_err"),
        "peak_hbm_bytes": (summary.get("memory") or {}).get(
            "peak_bytes_in_use"
        ),
        "final_loss": (summary.get("result") or {}).get("loss"),
        "hist_quantiles": _hist_quantiles(summary),
        "program_costs": summary.get("program_costs") or [],
        "probes": probes or [],
    }


def suite_row(duration_s: float, dots_passed: int, rc: int,
              timeout_s: float) -> Dict[str, Any]:
    """One ``kind=suite`` row: a tier-1 suite execution (ci_tier1.sh).
    Keyed by backend only — the suite is the workload, so cfg/graph
    digests are fixed sentinel strings that make every suite row on one
    rig comparable."""
    return {
        "kind": "suite",
        "ts": time.time(),
        "cfg": "tier1",
        "graph_digest": "tier1",
        "backend": backend_fingerprint(),
        "suite_duration_s": float(duration_s),
        "dots_passed": int(dots_passed),
        "rc": int(rc),
        "timeout_s": float(timeout_s),
    }


def serve_row(
    latency_ms: Dict[str, Any],
    shed_rate: Optional[float],
    throughput_rps: Optional[float],
    requests: int,
    cfg_fingerprint: str,
    graph_digest: Optional[str],
    mode: str,
    replicas: int,
    continuous_batching: bool,
    delta_rate: float = 0.0,
    deltas_applied: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One ``kind=serve`` row from a tools/serve_bench execution. The
    cfg key embeds the LOAD SHAPE (mode, replica count, continuous
    batching) so only like-for-like runs sit on one trajectory; the
    graph digest keys the workload like run rows do. The p50/p95/p99 +
    shed_rate scalars are what perf_sentinel gates (GATED_METRICS)."""
    lat = latency_ms or {}
    return {
        "kind": "serve",
        "ts": time.time(),
        "cfg": (
            f"{cfg_fingerprint}|{mode}|r{int(replicas)}"
            f"|cb{int(bool(continuous_batching))}"
        ),
        "graph_digest": graph_digest or "unknown",
        "backend": backend_fingerprint(),
        "p50_ms": as_number(lat.get("p50")),
        "p95_ms": as_number(lat.get("p95")),
        "p99_ms": as_number(lat.get("p99")),
        "shed_rate": as_number(shed_rate),
        "throughput_rps": as_number(throughput_rps),
        "requests": int(requests),
        "replicas": int(replicas),
        "continuous_batching": bool(continuous_batching),
        "mode": mode,
        "delta_rate": float(delta_rate),
        "deltas_applied": int(deltas_applied),
        **(extra or {}),
    }


def fleet_row(
    targets: int,
    targets_ok: int,
    targets_lost: int,
    polls: int,
    hist_quantiles: Dict[str, Any],
    cfg: Optional[str] = None,
) -> Dict[str, Any]:
    """One ``kind=fleet`` row from a telemetry-hub poll cycle
    (obs/hub.py): the MERGED cross-host latency quantiles (exact under
    the histogram merge law — the same math fleet.close() applies
    in-process) plus the liveness roll-up. Keyed by target count so a
    3-target fleet never baselines a 5-target one; the graph digest is
    a fixed sentinel (the hub aggregates across workloads — its
    trajectory is the fleet's, not one graph's). ``targets_lost`` is the
    gated scalar (GATED_METRICS): a fleet that trends toward losing
    targets is regressing even when the survivors' tails look fine."""
    return {
        "kind": "fleet",
        "ts": time.time(),
        "cfg": cfg or f"hub|t{int(targets)}",
        "graph_digest": "fleet",
        "backend": backend_fingerprint(),
        "targets": int(targets),
        "targets_ok": int(targets_ok),
        "targets_lost": int(targets_lost),
        "polls": int(polls),
        "hist_quantiles": hist_quantiles or {},
    }


def probe_row(attempt: int, outcome: str, seconds: float,
              platform: Optional[str], scale: float = 1.0,
              error: Optional[str] = None) -> Dict[str, Any]:
    """One ``kind=probe`` row per bench.py backend-probe attempt —
    appended EVEN ON TIMEOUT, so the probe-failure history is queryable
    from one file. The backend key is the probe's OWN
    answer (or "unprobed"): bench's supervisor process deliberately never
    initializes the accelerator backend, so the in-process fingerprint
    the run/suite rows use is off-limits here."""
    return {
        "kind": "probe",
        "ts": time.time(),
        "cfg": f"bench_scale_{scale:g}",
        "graph_digest": "probe",
        "backend": platform or "unprobed",
        "attempt": int(attempt),
        "outcome": str(outcome),
        "seconds": float(seconds),
        "platform": platform,
        "error": (str(error)[:300] if error else None),
    }
