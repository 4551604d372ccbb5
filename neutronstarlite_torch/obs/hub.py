"""Cross-host telemetry aggregation: the pull-based fleet hub.

Port of ``neutronstarlite_tpu/obs/hub.py``, copied: only the import paths
differ.

Every observability surface before this was process-local: each rank
(or serve replica) streams its own JSONL and serves its own /metrics,
and the only cross-stream math lived in offline tools (metrics_report
over many files) or in-process (serve/fleet's merged latency view). A
real fleet is N *hosts* — there is no shared filesystem and no shared
process — so this module adds the missing tier: a hub that POLLS each
target's ``/telemetry`` endpoint (obs/exporter — the full-resolution
NDJSON snapshot: native 1.02-growth histogram buckets, gauges/counters,
SLO verdicts, health) and rebuilds the fleet view centrally.

Why /telemetry and not /metrics: the Prometheus ladder is LOSSY (a
fixed ~18-edge histogram; obs/hist.PROM_EDGES_MS) — quantiles
reconstructed from it carry unbounded error on distributions that land
between edges. The /telemetry payload ships the native buckets, so the
hub reconstructs each :class:`~neutronstarlite_torch.obs.hist.LogHistogram`
and merges via the exact bucket-addition merge law — the SAME math
``latest_hists`` applies to multi-rank streams and serve/fleet applies
in-process. Fleet p50/p95/p99 from the hub are therefore exact up to
the histogram's own documented ~1% relative bucket error, never the
ladder's.

The hub is itself an ordinary observability citizen:

- its merged histograms are installed into its own
  :class:`~neutronstarlite_torch.obs.registry.MetricsRegistry` (via
  ``hist_set``), so the stock exporter renders the FLEET view on the
  hub's own /metrics and /healthz (``health_payload`` understands the
  ``hub.*`` gauges: lost targets = degraded-but-ok while any target
  still answers);
- every poll appends typed records to ONE schema-valid merged stream
  under ``NTS_METRICS_DIR`` (a ``telemetry`` record with
  ``source="hub"``, cumulative ``hist`` snapshots, ``target_loss`` /
  ``recovery`` on liveness edges), rendered natively by
  tools/metrics_report and tools/dashboard;
- each poll cycle can append a ``kind=fleet`` row to the perf ledger
  (obs/ledger.fleet_row), putting fleet tail latency and
  ``targets_lost`` on a perf_sentinel-gated trajectory.

Per-target liveness reuses the miss-K pattern from
resilience/elastic.LivenessMonitor: a target that fails
``NTS_HUB_MISS_K`` consecutive polls becomes ONE typed ``target_loss``
record (the cross-host analog of ``rank_loss``) — never an exception;
the hub keeps polling and keeps serving the survivors' merged view with
the lost target's histograms FROZEN at their last-seen snapshot (a
cumulative histogram of real observations remains true after its source
dies; dropping it would deflate fleet counts). A target that answers
again emits a ``recovery`` record (``action="target_rejoin"``) and
resumes live updates.

Knobs: ``NTS_HUB_TARGETS`` (comma-separated target URLs or host:port),
``NTS_HUB_POLL_S`` (default 2.0), ``NTS_HUB_MISS_K`` (default 3).
CLI: tools/telemetry_hub.py; rendering: tools/dashboard.py.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from neutronstarlite_torch.obs import httpc, ledger, registry as obs_registry
from neutronstarlite_torch.obs.hist import LogHistogram, latest_hists
from neutronstarlite_torch.obs.schema import validate_event
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

DEFAULT_POLL_S = 2.0
DEFAULT_MISS_K = 3
FETCH_TIMEOUT_S = 5.0


# ---- knobs ------------------------------------------------------------------


def hub_targets() -> List[str]:
    """``NTS_HUB_TARGETS``: comma-separated /telemetry endpoints."""
    raw = os.environ.get("NTS_HUB_TARGETS", "")
    return [t.strip() for t in raw.split(",") if t.strip()]


def hub_poll_s() -> float:
    raw = os.environ.get("NTS_HUB_POLL_S", "")
    if not raw:
        return DEFAULT_POLL_S
    try:
        return max(float(raw), 0.0)
    except ValueError:
        log.warning("bad NTS_HUB_POLL_S=%r; using %g", raw, DEFAULT_POLL_S)
        return DEFAULT_POLL_S


def hub_miss_k() -> int:
    raw = os.environ.get("NTS_HUB_MISS_K", "")
    if not raw:
        return DEFAULT_MISS_K
    try:
        return max(int(raw), 1)
    except ValueError:
        log.warning("bad NTS_HUB_MISS_K=%r; using %d", raw, DEFAULT_MISS_K)
        return DEFAULT_MISS_K


def normalize_target(target: str) -> str:
    """``host:port`` / bare URLs normalize to a full /telemetry URL (a
    URL already naming a path — e.g. ``...?replica=r1`` — passes
    through untouched)."""
    t = target.strip()
    if not t.startswith("http://") and not t.startswith("https://"):
        t = f"http://{t}"
    scheme, _, rest = t.partition("://")
    if "/" not in rest:
        t = f"{scheme}://{rest}/telemetry"
    return t


def _default_fetch(url: str) -> str:
    """One poll's fetch: the shared retrying client (obs/httpc), so a
    single dropped connection is retried within the poll before it costs
    the target one of its ``miss_k`` misses — retry-then-miss, not
    miss-on-first-blip. The whole retry budget is bounded by the poll
    timeout so a hung target cannot stall the cycle."""
    return httpc.fetch(url, timeout_s=FETCH_TIMEOUT_S,
                       deadline_s=FETCH_TIMEOUT_S * 2)


class _Target:
    """One polled endpoint's liveness + last-known snapshot."""

    def __init__(self, url: str):
        self.url = url
        self.missed = 0
        self.lost = False  # latched at miss_k (one record per loss)
        self.ever_ok = False
        self.last_ok_ts: Optional[float] = None
        self.records: List[Dict[str, Any]] = []  # last VALID snapshot


class TelemetryHub:
    """Poll N ``/telemetry`` targets; merge into one fleet view.

    ``fetch`` is injectable (tests drive the hub without sockets); the
    default is the shared retrying client (obs/httpc: bounded jittered
    backoff under a per-poll deadline). The hub NEVER
    raises out of a poll: a dead target is a liveness fact (miss-K ->
    ``target_loss``), a malformed payload is a warning + a miss (a
    half-written response must not poison the merged view), and ledger
    /stream failures degrade to warnings like every obs writer."""

    def __init__(self, targets: List[str], *,
                 poll_s: Optional[float] = None,
                 miss_k: Optional[int] = None,
                 registry: Optional[obs_registry.MetricsRegistry] = None,
                 ledger_dir: Optional[str] = None,
                 ledger_every: int = 1,
                 fetch: Optional[Callable[[str], str]] = None):
        if not targets:
            raise ValueError("TelemetryHub needs at least one target "
                             "(NTS_HUB_TARGETS or --targets)")
        self.targets = [_Target(normalize_target(t)) for t in targets]
        self.poll_s = hub_poll_s() if poll_s is None else max(
            float(poll_s), 0.0
        )
        self.miss_k = hub_miss_k() if miss_k is None else max(int(miss_k), 1)
        self.registry = registry or obs_registry.open_run("hub")
        self._owns_registry = registry is None
        self.ledger_dir = ledger_dir
        self.ledger_every = max(int(ledger_every), 1)
        self.fetch = fetch or _default_fetch
        self.polls = 0
        self.started_at = time.time()

    # ---- one poll cycle --------------------------------------------------

    def _poll_target(self, t: _Target) -> bool:
        """Fetch + validate one target; True on a good snapshot."""
        try:
            body = self.fetch(t.url)
        except Exception as e:
            log.warning("hub: target %s unreachable (%s)", t.url, e)
            return False
        records: List[Dict[str, Any]] = []
        try:
            for ln, raw in enumerate(body.splitlines(), 1):
                raw = raw.strip()
                if not raw:
                    continue
                rec = json.loads(raw)
                validate_event(rec)
                records.append(rec)
        except ValueError as e:
            # schema-invalid or torn mid-line: treat as a failed poll —
            # a half-written payload must not replace a good snapshot
            log.warning("hub: target %s returned a bad payload at line "
                        "%d (%s)", t.url, ln, e)
            return False
        if not records:
            log.warning("hub: target %s returned an empty payload", t.url)
            return False
        t.records = records
        return True

    def merged_hists(self) -> Dict[str, LogHistogram]:
        """The fleet histograms: every target's last-known cumulative
        ``hist`` records merged by the exact bucket-addition law
        (distinct run_ids merge, latest per run supersedes —
        obs/hist.latest_hists). Lost targets contribute their FROZEN
        last snapshot."""
        pool: List[Dict[str, Any]] = []
        for t in self.targets:
            pool.extend(t.records)
        return latest_hists(pool)

    def slo_rollup(self) -> Dict[str, Any]:
        """The fleet SLO posture: verdict counts over every target's
        last-seen ``slo_status`` records (latest per (run, objective))."""
        latest: Dict[tuple, str] = {}
        for t in self.targets:
            for rec in t.records:
                if rec.get("event") != "slo_status":
                    continue
                key = (rec.get("run_id"), rec.get("objective"))
                latest[key] = str(rec.get("state"))
        states = list(latest.values())
        return {
            "objectives": len(states),
            "breaching": sum(1 for s in states if s == "breach"),
            "worst": ("breach" if any(s == "breach" for s in states)
                      else "ok" if states else "none"),
        }

    def poll_once(self) -> Dict[str, Any]:
        """One poll cycle over every target: liveness accounting, the
        exact histogram merge, the merged-view refresh (own registry
        gauges + cumulative hist records + one ``telemetry`` record),
        and optionally one ``kind=fleet`` ledger row."""
        self.polls += 1
        now = time.time()
        ok = 0
        for t in self.targets:
            if self._poll_target(t):
                ok += 1
                t.missed = 0
                t.last_ok_ts = now
                t.ever_ok = True
                if t.lost:
                    t.lost = False
                    # the cross-host rejoin: same record the elastic
                    # plane uses for every healed state
                    self.registry.event(
                        "recovery", action="target_rejoin", target=t.url,
                    )
                    log.warning("hub: target %s rejoined", t.url)
            else:
                t.missed += 1
                if t.missed >= self.miss_k and not t.lost:
                    t.lost = True
                    self.registry.event(
                        "target_loss", target=t.url,
                        reason=("poll_miss" if t.ever_ok
                                else "never_answered"),
                        missed_polls=int(t.missed),
                        miss_k=int(self.miss_k),
                        last_ok_ts=t.last_ok_ts,
                    )
                    log.warning(
                        "hub: target %s LOST (%d consecutive missed "
                        "poll(s), NTS_HUB_MISS_K=%d) — merged view "
                        "continues on the survivors with its last "
                        "snapshot frozen", t.url, t.missed, self.miss_k,
                    )
        lost = sum(1 for t in self.targets if t.lost)
        merged = self.merged_hists()
        for name, h in sorted(merged.items()):
            self.registry.hist_set(name, h)
        self.registry.gauge_set("hub.targets", len(self.targets))
        self.registry.gauge_set("hub.targets_ok", ok)
        self.registry.gauge_set("hub.targets_lost", lost)
        self.registry.counter_add("hub.polls", 1.0)
        self.registry.emit_hists()
        slo = self.slo_rollup()
        self.registry.event(
            "telemetry", source="hub",
            counters=self.registry.snapshot(include_hists=False)["counters"],
            gauges={
                "hub.targets": len(self.targets),
                "hub.targets_ok": ok,
                "hub.targets_lost": lost,
            },
            slo=slo,
            targets=len(self.targets), targets_ok=ok, targets_lost=lost,
            uptime_s=round(now - self.started_at, 3),
        )
        if self.ledger_dir and self.polls % self.ledger_every == 0:
            hq = {
                name: {"count": h.count, **h.quantiles()}
                for name, h in sorted(merged.items())
            }
            ledger.append_row(
                ledger.fleet_row(
                    len(self.targets), ok, lost, self.polls, hq,
                ),
                directory=self.ledger_dir,
            )
        return {
            "poll": self.polls,
            "targets": len(self.targets),
            "targets_ok": ok,
            "targets_lost": lost,
            "hists": {n: h.count for n, h in merged.items()},
            "slo": slo,
        }

    # ---- lifecycle -------------------------------------------------------

    def run(self, polls: Optional[int] = None,
            on_poll: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> Dict[str, Any]:
        """Poll forever (or ``polls`` times); returns the last cycle's
        summary. KeyboardInterrupt exits cleanly (the CLI's ^C)."""
        last: Dict[str, Any] = {}
        n = 0
        try:
            while polls is None or n < polls:
                cycle_t0 = time.time()
                last = self.poll_once()
                if on_poll is not None:
                    on_poll(last)
                n += 1
                if polls is not None and n >= polls:
                    break
                sleep_s = self.poll_s - (time.time() - cycle_t0)
                if sleep_s > 0:
                    time.sleep(sleep_s)
        except KeyboardInterrupt:
            log.warning("hub: interrupted; closing the merged stream")
        return last

    def close(self) -> None:
        """Flush the final merged snapshot and close the hub's stream
        (only a registry the hub itself opened)."""
        if self._owns_registry:
            try:
                self.registry.emit_hists()
            finally:
                self.registry.close()

    def stream_path(self) -> Optional[str]:
        return self.registry.path
