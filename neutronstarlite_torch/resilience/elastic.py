"""Rank-health tracking: heartbeats and the liveness monitor — port of the
part of ``neutronstarlite_tpu/resilience/elastic.py`` that the serve fleet
uses (``serve/fleet.py``: one heartbeat per replica per tick, a replica that
misses ``NTS_HEARTBEAT_MISS_K`` in a row is restarted).

- :class:`LivenessMonitor` consumes one heartbeat per partition (a fleet
  replica) per tick, each a typed ``heartbeat`` record, counts consecutive
  misses, and at ``miss_k`` emits one typed ``rank_loss`` record naming the
  partition; it raises :class:`RankLossError` (``code=rank_loss``) only
  when the guards are armed (the fleet's never are: it reads
  :meth:`LivenessMonitor.missed`).
- ``NTS_COLLECTIVE_TIMEOUT_S`` trips the same record when a step takes
  longer than the budget.

The elastic training plane, the survivor replan of a partitioned run and
the ``rank_loss@partition=k`` chaos kill, comes with the distributed
slice, as does the straggler advisory (``obs/skew``): :func:`kill_partition`
and :func:`replan_survivors` refuse, naming it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Set

from neutronstarlite_torch.resilience import events, guards
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("elastic")

_DISTRIBUTED = (
    "the last distributed slice of the torch port (the survivor replan of the "
    "partitioned trainers; the all_gather trainers came without it)"
)


class RankLossError(guards.HealthError):
    """A partition stopped participating; ``partition`` names it (None
    for a collective-timeout detection, which cannot attribute)."""

    code = "rank_loss"

    def __init__(self, msg: str, partition: Optional[int] = None,
                 epoch: Optional[int] = None):
        super().__init__(msg, epoch=epoch)
        self.partition = partition


# ---- knobs ------------------------------------------------------------------


def heartbeat_miss_k() -> int:
    """Consecutive missed beats before a partition is declared lost
    (``NTS_HEARTBEAT_MISS_K``, default 3, clamped to >= 1 — a zero or
    negative K would declare every partition dead on the spot)."""
    raw = os.environ.get("NTS_HEARTBEAT_MISS_K", "")
    try:
        return max(int(raw), 1) if raw else 3
    except ValueError:
        log.warning("bad NTS_HEARTBEAT_MISS_K=%r; using 3", raw)
        return 3


def collective_timeout_s() -> float:
    """Per-step collective budget (``NTS_COLLECTIVE_TIMEOUT_S``, default
    0 = off, negative values clamp to off)."""
    raw = os.environ.get("NTS_COLLECTIVE_TIMEOUT_S", "")
    try:
        return max(float(raw), 0.0) if raw else 0.0
    except ValueError:
        log.warning("bad NTS_COLLECTIVE_TIMEOUT_S=%r; disabling", raw)
        return 0.0


def kill_partition(partition: int) -> None:
    """The ``rank_loss`` fault kind's sim-partition kill: refused."""
    raise ValueError(
        f"killing partition {partition} needs a partitioned run, which comes "
        f"with {_DISTRIBUTED}"
    )


def replan_survivors(toolkit, lost_partition: int) -> int:
    """The survivor replan after a rank loss: refused."""
    raise ValueError(
        f"replanning around lost partition {lost_partition} comes with "
        f"{_DISTRIBUTED}"
    )


# ---- liveness monitor -------------------------------------------------------


class LivenessMonitor:
    """Per-partition heartbeat bookkeeping.

    The caller calls :meth:`epoch_end` once per epoch (the fleet: once per
    monitor tick) with the partitions that beat; the monitor emits one
    typed ``heartbeat`` record per live partition, counts consecutive
    misses per partition, and trips (``rank_loss`` record +
    :class:`RankLossError`) at ``miss_k`` misses or when the epoch's
    collective step time exceeds ``collective_timeout_s`` (the first epoch
    is exempt — it pays compile/restore). A partition that beats again
    before K resets its miss count (transient network wobble is not a
    rank loss). Like every guard, the monitor only *raises* when the
    guards are armed (supervised run / ``NTS_GUARDS=1``); unarmed it logs
    and keeps the stream records flowing."""

    def __init__(self, partitions: int, miss_k: Optional[int] = None,
                 collective_timeout: Optional[float] = None):
        self.partitions = int(partitions)
        self.miss_k = miss_k if miss_k is not None else heartbeat_miss_k()
        self.miss_k = max(int(self.miss_k), 1)
        t = (collective_timeout if collective_timeout is not None
             else collective_timeout_s())
        self.collective_timeout_s = max(float(t), 0.0)
        self._missed = {p: 0 for p in range(self.partitions)}
        self._epochs_seen = 0
        self._tripped: Set[int] = set()  # unarmed: one record per loss

    def epoch_end(self, epoch: int, alive: Optional[Iterable[int]] = None,
                  step_seconds: Optional[float] = None,
                  partition_seconds: Optional[dict] = None) -> None:
        """One epoch's health gate: beats for ``alive`` partitions, miss
        accounting for the rest, and the collective-timeout check.
        ``partition_seconds`` ({partition: measured epoch wall time})
        rides each beat as the optional ``seconds`` field."""
        live = set(alive) if alive is not None else set(range(self.partitions))
        secs = partition_seconds or {}
        for p in sorted(live):
            self._missed[p] = 0
            s = secs.get(p)
            events.emit(
                "heartbeat", partition=int(p), epoch=int(epoch),
                **({"seconds": float(s)} if s is not None else {}),
            )
        self._epochs_seen += 1
        for p in range(self.partitions):
            if p in live:
                continue
            self._missed[p] += 1
            if self._missed[p] >= self.miss_k:
                self._trip(
                    f"partition {p} missed {self._missed[p]} consecutive "
                    f"heartbeat(s) (NTS_HEARTBEAT_MISS_K={self.miss_k})",
                    partition=p, epoch=epoch, reason="heartbeat_miss",
                    missed=self._missed[p],
                )
        if (
            self.collective_timeout_s > 0
            and self._epochs_seen > 1  # first epoch pays compile/restore
            and step_seconds is not None
            and step_seconds > self.collective_timeout_s
        ):
            self._trip(
                f"collective step took {step_seconds:.3f}s "
                f"(> NTS_COLLECTIVE_TIMEOUT_S={self.collective_timeout_s:g}s"
                ") — a wedged exchange reads as a lost rank",
                partition=None, epoch=epoch, reason="collective_timeout",
            )

    def missed(self, partition: int) -> int:
        """Consecutive missed beats for one partition — the serve fleet's
        monitor consumes this directly (its guards are never armed, so
        detection cannot rely on the RankLossError raise)."""
        return self._missed.get(int(partition), 0)

    def clear(self, partition: int) -> None:
        """Forget a partition's miss count and trip latch — called after
        a supervised replica restart (serve/fleet.py): the fresh replica
        is a new liveness subject, and a SECOND death must re-detect
        (and re-record) rather than being swallowed by the latch."""
        self._missed[int(partition)] = 0
        self._tripped.discard(int(partition))

    def _trip(self, msg: str, partition: Optional[int], epoch: int,
              reason: str, missed: Optional[int] = None) -> None:
        key = -1 if partition is None else partition
        if key not in self._tripped:
            self._tripped.add(key)
            events.emit(
                "rank_loss",
                partition=int(partition) if partition is not None else None,
                epoch=int(epoch), reason=reason,
                **({"missed_beats": int(missed)} if missed is not None
                   else {}),
            )
        if not guards.guards_armed():
            log.warning("rank loss detected but guards are unarmed: %s", msg)
            return
        raise RankLossError(msg, partition=partition, epoch=epoch)
