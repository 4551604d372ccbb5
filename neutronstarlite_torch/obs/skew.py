"""Cross-partition skew analytics — the straggler plane.

Port of ``neutronstarlite_tpu/obs/skew.py``, copied: the same math, the same
records and the same knobs (tests/test_torch_obs.py holds the two copies
against each other; tests/test_torch_skew.py runs both on the same inputs).

Range partitioning of a power-law graph guarantees per-partition compute
imbalance, and on a synchronous ring every epoch runs at the SLOWEST
partition's pace — so a skewed partition taxes the whole fleet while
looking perfectly healthy to the liveness monitor (it still heartbeats).
This module turns per-partition epoch timings into a typed advisory
signal:

- :func:`baseline_stats` / :func:`effective_tolerance` — the robust
  median + MAD tolerance math, shared with the reference's
  tools/perf_sentinel (the port's tools come with a later slice).
- :class:`StragglerDetector` — per epoch, a partition whose time exceeds
  the fleet median by the k·MAD tolerance for M CONSECUTIVE epochs
  becomes one typed ``straggler`` record + the
  ``dist.straggler_partition`` gauge. On the sim ring all partitions
  share one host, so MAD is ~0 and the tolerance FLOOR governs — an
  injected ``slow_rank`` sleep must exceed ``floor`` (default 25%) of
  the median epoch time to trip, which is exactly the regime worth
  flagging.
- :func:`partition_epoch_seconds` / :func:`detect_stragglers` — the
  offline replay over a recorded stream's ``heartbeat`` records (the
  optional ``seconds`` field), for post-hoc analysis of a stream.

**Slow vs dead (the elastic contract).** A straggler is NOT a rank_loss:
the straggler detector fires on a partition that still completes epochs
(slow-but-alive, advisory — never raises, never sheds the partition),
while the liveness monitor's ``rank_loss`` fires only when a partition's
heartbeats actually STOP for miss-K epochs (dead, actionable — the
supervisor replans without it). The detector surfaces its verdict to
elastic as an advisory note (resilience/elastic.note_straggler via the
``on_straggler`` callback) so a later rank_loss on a known-slow
partition can say "it was flagged slow first"; docs/RESILIENCE.md has
the full contract.

Knobs: ``NTS_STRAGGLER`` (1/0 force on/off; default follows the elastic
arming), ``NTS_STRAGGLER_K`` (MAD multiplier, default 3.0),
``NTS_STRAGGLER_M`` (consecutive epochs, default 3),
``NTS_STRAGGLER_FLOOR`` (relative tolerance floor, default 0.25).
"""

from __future__ import annotations

import os
import statistics
from typing import Any, Callable, Dict, Iterable, List, Optional

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

DEFAULT_NSIGMA = 3.0
DEFAULT_CONSECUTIVE = 3
DEFAULT_FLOOR = 0.25
DEFAULT_MAX_TOL = 4.0


# ---- the shared robust-tolerance math (perf_sentinel re-imports these) -----


def baseline_stats(vals: List[float]) -> Dict[str, float]:
    """median + MAD of a baseline window."""
    med = float(statistics.median(vals))
    mad = float(statistics.median([abs(v - med) for v in vals]))
    return {"median": med, "mad": mad, "n": len(vals)}


def effective_tolerance(med: float, mad: float, nsigma: float,
                        floor: float, max_tol: float) -> float:
    """The RELATIVE tolerance for one metric: the window's own MAD-scaled
    noise estimate, floored (a dead-quiet history must not gate at 0%)
    and capped (a wild history must not wave everything through).
    1.4826 * MAD estimates sigma for a normal distribution."""
    if med <= 0:
        return floor
    rel = nsigma * 1.4826 * mad / med
    return min(max(rel, floor), max_tol)


# ---- knobs ------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("bad %s=%r; using %g", name, raw, default)
        return default


def straggler_enabled(default: bool = False) -> bool:
    """``NTS_STRAGGLER``: 1 forces the detector on, 0 off; unset follows
    ``default`` (the dist trainer passes its elastic-arming state)."""
    raw = os.environ.get("NTS_STRAGGLER", "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "no", "off")


def straggler_nsigma() -> float:
    return _env_float("NTS_STRAGGLER_K", DEFAULT_NSIGMA)


def straggler_consecutive() -> int:
    return max(int(_env_float("NTS_STRAGGLER_M", DEFAULT_CONSECUTIVE)), 1)


def straggler_floor() -> float:
    return _env_float("NTS_STRAGGLER_FLOOR", DEFAULT_FLOOR)


# ---- the live detector ------------------------------------------------------


class StragglerDetector:
    """M-consecutive k·MAD skew detection over per-partition epoch times.

    Feed :meth:`observe_epoch` once per epoch with every alive
    partition's measured seconds. When a partition exceeds
    ``median * (1 + effective_tolerance(median, mad, k, floor,
    max_tol))`` for ``m`` epochs in a row, ONE typed ``straggler``
    record is emitted (via ``registry.event`` when a registry is bound)
    plus the ``dist.straggler_partition`` gauge, and ``on_straggler``
    fires (the elastic advisory hook). The latch re-arms only after the
    partition returns under threshold — a persistently slow partition
    is one record, not one per epoch. ADVISORY ONLY: never raises into
    the step loop."""

    def __init__(self, partitions: int, *, nsigma: Optional[float] = None,
                 m: Optional[int] = None, floor: Optional[float] = None,
                 max_tol: float = DEFAULT_MAX_TOL, registry=None,
                 on_straggler: Optional[Callable[[int], None]] = None,
                 source: str = "partition_step"):
        self.partitions = int(partitions)
        self.nsigma = straggler_nsigma() if nsigma is None else float(nsigma)
        self.m = straggler_consecutive() if m is None else max(int(m), 1)
        self.floor = straggler_floor() if floor is None else float(floor)
        self.max_tol = float(max_tol)
        self.registry = registry
        self.on_straggler = on_straggler
        self.source = source
        self._streak: Dict[int, int] = {}
        self._latched: Dict[int, bool] = {}

    def observe_epoch(
        self, epoch: int, seconds_by_partition: Dict[int, float],
    ) -> List[Dict[str, Any]]:
        """One epoch's verdicts; returns the straggler record bodies
        emitted this epoch (usually empty)."""
        vals = {
            int(p): float(s) for p, s in seconds_by_partition.items()
            if s is not None and s > 0
        }
        if len(vals) < 2:
            return []  # skew needs a fleet to be skewed against
        stats = baseline_stats(list(vals.values()))
        med, mad = stats["median"], stats["mad"]
        tol = effective_tolerance(med, mad, self.nsigma, self.floor,
                                  self.max_tol)
        threshold = med * (1.0 + tol)
        emitted: List[Dict[str, Any]] = []
        for p, s in sorted(vals.items()):
            if s > threshold:
                self._streak[p] = self._streak.get(p, 0) + 1
                if self._streak[p] >= self.m and not self._latched.get(p):
                    self._latched[p] = True
                    body = {
                        "partition": p,
                        "epoch": int(epoch),
                        "seconds": s,
                        "median_s": med,
                        "mad_s": mad,
                        "threshold_s": threshold,
                        "excess": s / med - 1.0,
                        "consecutive": self._streak[p],
                        "source": self.source,
                    }
                    emitted.append(body)
                    self._emit(body)
            else:
                self._streak[p] = 0
                self._latched[p] = False
        return emitted

    def _emit(self, body: Dict[str, Any]) -> None:
        log.warning(
            "straggler: partition %d epoch time %.3fs exceeds fleet "
            "median %.3fs by %.0f%% (threshold %.3fs) for %d consecutive "
            "epoch(s) — slow-but-alive, advisory (NOT a rank_loss)",
            body["partition"], body["seconds"], body["median_s"],
            body["excess"] * 100, body["threshold_s"], body["consecutive"],
        )
        if self.registry is not None:
            try:
                self.registry.event("straggler", **body)
                self.registry.gauge_set(
                    "dist.straggler_partition", body["partition"]
                )
            except Exception as e:  # advisory: never into the step loop
                log.warning("straggler record emission failed: %s", e)
        if self.on_straggler is not None:
            try:
                self.on_straggler(body["partition"])
            except Exception as e:
                log.warning("straggler advisory callback failed: %s", e)


# ---- offline replay over recorded streams ----------------------------------


def partition_epoch_seconds(
    events: Iterable[Dict[str, Any]],
) -> Dict[int, Dict[int, float]]:
    """{partition: {epoch: seconds}} from a stream's ``heartbeat``
    records that carry the optional ``seconds`` field (the per-partition
    epoch wall time the dist trainer measures). Records without it — or
    pre-fabric streams — simply contribute nothing."""
    out: Dict[int, Dict[int, float]] = {}
    for e in events:
        if e.get("event") != "heartbeat":
            continue
        p, ep, s = e.get("partition"), e.get("epoch"), e.get("seconds")
        if (isinstance(p, int) and isinstance(ep, int)
                and isinstance(s, (int, float))
                and not isinstance(s, bool) and s > 0):
            out.setdefault(p, {})[ep] = float(s)
    return out


def detect_stragglers(
    events: Iterable[Dict[str, Any]], *, nsigma: Optional[float] = None,
    m: Optional[int] = None, floor: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Replay the live detector over a recorded stream (no emission —
    the returned record bodies are the verdicts). The same math the
    in-run detector applies, so an offline analysis of a stream agrees
    with what the run itself flagged."""
    by_part = partition_epoch_seconds(events)
    if not by_part:
        return []
    det = StragglerDetector(
        len(by_part), nsigma=nsigma, m=m, floor=floor, source="heartbeat",
    )
    epochs = sorted({ep for per in by_part.values() for ep in per})
    out: List[Dict[str, Any]] = []
    for ep in epochs:
        out.extend(det.observe_epoch(
            ep, {p: per[ep] for p, per in by_part.items() if ep in per}
        ))
    return out


def hop_skew(
    events: Iterable[Dict[str, Any]], *, nsigma: Optional[float] = None,
    floor: Optional[float] = None, max_tol: float = DEFAULT_MAX_TOL,
) -> Optional[Dict[str, Any]]:
    """Advisory ring-hop skew over measured ``ring_step`` durations
    (non-null ``seconds`` — comm_bench / multi-host streams; the in-run
    sim leaves them null). Streams are per-rank, so hops group by
    run_id; a stream whose mean hop time exceeds the fleet median by
    the k·MAD tolerance is named. None when fewer than 2 streams carry
    measured hops."""
    by_run: Dict[str, List[float]] = {}
    for e in events:
        if e.get("event") != "ring_step":
            continue
        s = e.get("seconds")
        if isinstance(s, (int, float)) and not isinstance(s, bool) and s > 0:
            by_run.setdefault(str(e.get("run_id")), []).append(float(s))
    if len(by_run) < 2:
        return None
    means = {rid: sum(v) / len(v) for rid, v in by_run.items()}
    stats = baseline_stats(list(means.values()))
    tol = effective_tolerance(
        stats["median"], stats["mad"],
        straggler_nsigma() if nsigma is None else nsigma,
        straggler_floor() if floor is None else floor, max_tol,
    )
    threshold = stats["median"] * (1.0 + tol)
    slow = sorted(rid for rid, m_ in means.items() if m_ > threshold)
    return {
        "streams": len(by_run),
        "median_hop_s": stats["median"],
        "mad_s": stats["mad"],
        "threshold_s": threshold,
        "slow_streams": slow,
        "mean_hop_s": means,
    }
