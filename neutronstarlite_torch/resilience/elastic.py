"""Elastic degraded-mode training: rank-health tracking and the survivor
replan — port of ``neutronstarlite_tpu/resilience/elastic.py``.

- **Rank health.** :class:`LivenessMonitor` takes one heartbeat per
  partition per epoch (each a typed ``heartbeat`` record, with the
  partition's measured seconds when the trainer gives them) and raises
  :class:`RankLossError` (``code=rank_loss``) when a partition misses
  ``NTS_HEARTBEAT_MISS_K`` beats in a row, or when a step takes longer than
  ``NTS_COLLECTIVE_TIMEOUT_S`` (the attempt's first epoch exempt). The
  typed ``rank_loss`` record, naming the partition and the reason, lands
  before the raise. The serve fleet uses the same monitor (one beat per
  replica per tick) and reads :meth:`LivenessMonitor.missed`.
- **Chaos.** ``rank_loss@partition=k`` (resilience/faults) kills one
  partition of the sim twin by registering it here (:func:`kill_partition`);
  its heartbeats stop and the monitor detects the silence as it would a
  real rank's. The dead set is process-global on purpose: a supervised
  retry in the same process still sees the partition dead until a replan
  renumbers the survivors. Fault specs name partitions in the original
  launch numbering (:func:`current_index_of` translates).
- **Survivor replan.** :func:`replan_survivors` rebuilds the plan for
  P' = P - 1 at the rollback boundary: the host graph is range-partitioned
  anew over the survivors (on a 2D ``MESH:Pv,Pf`` plan the mesh is
  reshaped for Pv*Pf - 1 devices), ``build_model`` rebuilds the tables,
  the padded rows and the model, and a typed ``replan`` record lands. The
  parameters are replicated, so the supervisor restores them from the
  last good checkpoint over the new plan.
- **Straggler advisory.** The straggler detector (obs/skew) notes slow but
  live partitions here (:func:`note_straggler`); nothing sheds or raises
  on it, it only annotates a later ``rank_loss`` of the same partition.

Real ranks: as in JAX, a live process group cannot evict a member (JAX's
caveat: the runtime cannot drop a device from a live mesh; surviving a
real loss needs a launcher that restarts the job without the dead host,
which reuses the plan rebuild, the checkpoint restore and the telemetry
here). On a joined ``torch.distributed`` world :func:`replan_survivors`
refuses, and the supervisor falls back to the same-plan rollback. The sim
twin carries the replan end to end.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, List, Optional, Set

from neutronstarlite_torch.resilience import events, guards
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("elastic")

# the caveat a real-rank replan refuses with
RANKS_CAVEAT = (
    "a live torch.distributed process group cannot evict a rank (as a live JAX "
    "mesh cannot drop a device): surviving a real rank loss needs a relaunch "
    "without the dead host, so the supervisor rolls back on the same plan"
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


def elastic_enabled() -> bool:
    """``NTS_ELASTIC=1`` arms elastic degraded mode (liveness heartbeats
    and the survivor replan on a rank loss); off by default."""
    return os.environ.get("NTS_ELASTIC", "0") == "1"



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


# ---- the process-global dead set (chaos) ------------------------------------

_dead: Set[int] = set()
# partitions evicted by replans, in the original launch numbering (fault
# specs name the original plan's partitions)
_lost_originals: List[int] = []


def current_index_of(original: int) -> Optional[int]:
    """The current (post-replan) index of a partition named in the
    original launch numbering; None when it was already evicted."""
    if original in _lost_originals:
        return None
    return original - sum(1 for lost in _lost_originals if lost < original)


def _original_index_of(current: int) -> int:
    """Inverse of :func:`current_index_of` over the survivors."""
    o = seen = 0
    while True:
        if o not in _lost_originals:
            if seen == current:
                return o
            seen += 1
        o += 1


def kill_partition(partition: int) -> None:
    """Mark a sim partition dead (the ``rank_loss`` fault's effect): its
    heartbeats stop from now on. ``partition`` is in the original
    numbering; one already evicted by a replan is ignored."""
    cur = current_index_of(int(partition))
    if cur is None:
        log.warning("rank_loss: partition %d was already evicted by an earlier replan; "
                    "ignoring", partition)
        return
    _dead.add(cur)


def dead_partitions() -> Set[int]:
    return set(_dead)


# ---- the straggler advisory (obs/skew) ----------------------------------------

# partitions the straggler detector flagged slow but alive, in the current
# numbering; advisory only (the _trip message below names them)
_stragglers: Set[int] = set()


def note_straggler(partition: int) -> None:
    """The detector's ``on_straggler`` hook (models/gcn_dist wires it)."""
    _stragglers.add(int(partition))


def clear_straggler(partition: int) -> None:
    _stragglers.discard(int(partition))


def stragglers() -> Set[int]:
    return set(_stragglers)


def alive_partitions(partitions: int) -> List[int]:
    """The partitions of a P-way plan still beating. A dead mark outside
    the plan (``rank_loss@partition=7`` on 4 partitions) refuses: it would
    never be reported missing."""
    ghost = sorted(p for p in _dead if p >= partitions or p < 0)
    if ghost:
        raise ValueError(
            f"rank_loss fault names partition(s) {ghost} but the plan has only "
            f"{partitions} (0..{partitions - 1}): the injected loss would silently "
            "never be detected"
        )
    return [p for p in range(partitions) if p not in _dead]


def reset() -> None:
    """Forget the dead set, the replan history and the stragglers (tests;
    ``supervised_run`` calls it on exit)."""
    _dead.clear()
    _lost_originals.clear()
    _stragglers.clear()


def renumber_after_loss(lost: int) -> None:
    """Map the dead set onto the survivors' numbering after a replan drops
    ``lost`` (a current index): survivors above it shift down one, and a
    second partition that died before the first loss was detected stays
    dead (its beats keep missing on the smaller plan, so it is detected and
    replanned away next)."""
    global _dead
    _lost_originals.append(_original_index_of(int(lost)))
    _dead = {p - 1 if p > lost else p for p in _dead if p != lost}


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
        if partition is not None and partition in _stragglers:
            # the slow-then-dead story: flagged slow before it went silent
            msg += (f" — partition {partition} was flagged as a straggler (slow) "
                    "before it went silent")
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
            log.warning("rank loss detected but guards are unarmed: %s (wrap with "
                        "resilience.supervised_run + NTS_ELASTIC=1 to replan)", msg)
            return
        raise RankLossError(msg, partition=partition, epoch=epoch)


# ---- survivor replan ------------------------------------------------------------


def replan_survivors(toolkit, lost_partition: int) -> int:
    """Rebuild ``toolkit``'s distributed plan for the survivors; returns the
    new vertex-partition count.

    1D plan: the host graph is range-partitioned over P' = P - 1 (the lost
    range is redistributed and every boundary rebalances: the record's
    ``moved_vertices``). 2D plan (``MESH:Pv,Pf``): the mesh is reshaped
    for Pv*Pf - 1 devices; a tuner-owned mesh (``MESH:auto``) goes through
    ``tune/select.reconsult_for_replan`` (the cache for P', else the prior;
    never a trial), a pinned one through ``partitioner.choose_mesh_shape``
    with a warning. ``build_model()`` then rebuilds the plan and the model;
    the parameters come back from the checkpoint (the supervisor). On a
    joined process group it refuses (:data:`RANKS_CAVEAT`).

    On a mesh every vertex partition renumbers (Pv' is not Pv - 1 in
    general), so the dead-set translation is exact on the 1D plan only; a
    second sim death keeps missing its beats on the reshaped plan and is
    detected there."""
    from neutronstarlite_torch.parallel import partitioner as pmod
    from neutronstarlite_torch.parallel.vertex_space import reassigned_vertices
    from neutronstarlite_torch.tune import select as tune_select

    if getattr(toolkit, "world", None) is not None:
        raise ValueError(f"survivor replan refused on real ranks: {RANKS_CAVEAT}")
    spec = getattr(toolkit, "mesh_spec", None)
    dist = getattr(toolkit, "dist", None)
    old_p = dist.partitions if dist is not None else (toolkit.cfg.partitions or 2)
    old_total = spec.devices if spec is not None else old_p
    new_total = old_total - 1
    if new_total < 1:
        raise ValueError(f"cannot replan a {old_total}-device plan: no survivors")
    old_offsets = dist.offsets.copy() if dist is not None else None
    t0 = time.perf_counter()
    toolkit.cfg.partitions = new_total
    if spec is not None and "mesh" not in (getattr(toolkit, "_tune_autos", None) or set()):
        from neutronstarlite_torch.models.gcn_dist import exchange_widths

        sizes = toolkit.cfg.layer_sizes()
        widths = exchange_widths(getattr(type(toolkit), "eager", False), sizes)
        new_spec = pmod.choose_mesh_shape(toolkit.host_graph, new_total, widths,
                                          out_widths=sizes[1:])
        toolkit.cfg.mesh = new_spec.cfg_value()
        log.warning("mesh reshape: pinned MESH:%s cannot survive on %d devices; analytic "
                    "reshape -> MESH:%s", spec.label(), new_total, new_spec.label())
    renumber_after_loss(int(lost_partition))
    # tuner-resolved axes are decided again for P' (cache or prior)
    tune_select.reconsult_for_replan(toolkit)
    toolkit.build_model()
    seconds = time.perf_counter() - t0
    new_dist = getattr(toolkit, "dist", None)
    new_p = new_dist.partitions if new_dist is not None else new_total
    moved = None
    if old_offsets is not None and new_dist is not None:
        moved = reassigned_vertices(old_offsets, new_dist.offsets)
    mesh_fields = {}
    if spec is not None:
        built = getattr(toolkit, "mesh_spec", None)
        mesh_fields = {"from_mesh": spec.label(),
                       "to_mesh": built.label() if built is not None else f"{new_p}x1"}
    events.emit(
        "replan", from_partitions=int(old_p), to_partitions=int(new_p),
        lost=int(lost_partition), seconds=float(seconds),
        **({"moved_vertices": int(moved)} if moved is not None else {}), **mesh_fields,
    )
    log.warning(
        "survivor replan: %d -> %d partitions%s (lost partition %d, %s vertices re-owned, "
        "plan rebuilt in %.2fs); restoring params from the last-good checkpoint",
        old_p, new_p,
        (f" (mesh {mesh_fields['from_mesh']} -> {mesh_fields['to_mesh']})"
         if mesh_fields else ""),
        lost_partition, moved if moved is not None else "?", seconds,
    )
    return new_p
