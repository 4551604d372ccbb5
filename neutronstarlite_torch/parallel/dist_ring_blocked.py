"""The pipelined ring over blocked step tables — port of
``neutronstarlite_tpu/parallel/dist_ring_blocked.py`` (``DIST_PATH:ring_blocked``).

Each rank's adjacency is split by source partition into P step tables:
step s holds the edges whose sources live in the shard the rank holds at
that step (``ring_schedule.ring_source``), as a square ``[vp -> vp]``
``BlockedEll`` (``ops/blocked_ell.py``) with shard-local source ids, so a
gather indexes one ``[vp, f]`` buffer. The tables equal JAX's level by
level; JAX stacks the ranks' levels to one ``[P, T, N_l, K]`` array per K
(padding rows ``dst = vp``, weight 0), the port keeps each rank's own
levels (``RingBlockedEll.tables[p][s]``), the live part of JAX's ``[p]``.

The exchange (``ring_apply``), one direction: at each step the rank
*starts* the hop of the shard it holds (``mesh.ProcessGroup.shift_start``,
only while ``s < n_transfers``), *then* adds the step's tables into its one
f32 accumulator, *then* waits for the hop. On NCCL the hop runs on NCCL's
stream while the step's gathers run on the compute stream, and the wait
orders the streams without blocking the host. The shipped buffer is cast
to the wire dtype (``WIRE_DTYPE``) at the send only: step 0's own shard
keeps full precision and each row rounds once, when first shipped. The
products and the sums are f32 (``BlockedEll.aggregate_into``), as in JAX,
with one cast to x's dtype at the end. The backward (``DistExchange``) is
the reverse ring (direction -1) over the transposed tables.

A step with no edges on any rank is skipped (``work_steps``), and a
skipped suffix drops its hops (``n_transfers``). The exchange holds two
shard buffers (resident and in flight) and the accumulator: ``2 * vp``
rows, where the all_gather family holds ``P * vp``.

The sim twin (``group=None``, ``ring_apply_simulated``) adds the same
tables to the same accumulator in the same order per rank, with the
shards cut from the full x, so gloo ranks are bitwise the twin.
On the 2D mesh the same exchange runs over the vertex group, on the
rank's ``[vp, f/Pf]`` slab (``parallel/partitioner.py`` cuts it, zero-padded
to a multiple of Pf, and puts it back together); no buffer inside the ring
is full width.

``measure_overlap`` (``NTS_OVERLAP_PROBE=1``) times the exchange in three
modes (``full``, ``compute_only``: the same table work on the resident
shard, no hop; ``exchange_only``: the hop chain alone), and
``ring_wire_plan`` gives the per-hop wire bytes the trainers record.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from neutronstarlite_torch.ops.blocked_ell import BlockedEll
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.partitioner import slab_width
from neutronstarlite_torch.parallel.ring_schedule import ring_source, trim_transfers
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("dist_ring_blocked")


def _block_adjacency(own: np.ndarray, nbr: np.ndarray, w: np.ndarray, vp: int):
    """(offsets, adjacency, weights) over ``vp`` destination rows of one
    (dst partition, src partition) edge block, partition-local ids."""
    order = np.argsort(own, kind="stable")
    own, nbr, w = own[order], nbr[order], w[order]
    deg = np.bincount(own, minlength=vp)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    return offsets, nbr, w


def _block(dist: DistGraph, p: int, q: int, transpose: bool):
    """Rank p's edges of the step holding partition q: (own rows, sources,
    weights), taken by the block's edge count (a weight-0 edge is real)."""
    slot = np.arange(dist.eb)
    if transpose:  # p owns the source side: block (q, p), rows = p-local sources
        real = slot < dist.block_count[q, p]
        return (dist.block_src[q, p][real].astype(np.int64),
                dist.block_dst[q, p][real].astype(np.int64), dist.block_weight[q, p][real])
    real = slot < dist.block_count[p, q]
    return (dist.block_dst[p, q][real].astype(np.int64),
            dist.block_src[p, q][real].astype(np.int64), dist.block_weight[p, q][real])


@dataclasses.dataclass
class RingBlockedEll:
    """One direction's step tables: ``tables[p][s]`` is rank p's
    ``BlockedEll`` of step s (None on a skipped step); a rank keeps its
    own, the twin all P. ``work`` is the steps with edges on any rank,
    ``edges`` the real edges of the tables held."""

    tables: Dict[int, List[Optional[BlockedEll]]]
    work: List[int]
    edges: int
    partitions: int
    vp: int
    vt: int
    n_tiles: int
    direction: int = 1  # +1 the forward ring, -1 the reverse

    @staticmethod
    def build(dist: DistGraph, vt: int, ranks, transpose: bool = False,
              direction: int = 1, device="cpu") -> "RingBlockedEll":
        P, vp = dist.partitions, dist.vp
        counts = dist.block_count.T if transpose else dist.block_count
        work = [s for s in range(P)
                if any(counts[p, ring_source(p, s, P, direction)] > 0 for p in range(P))]
        tables: Dict[int, List[Optional[BlockedEll]]] = {}
        for p in ranks:
            tables[p] = [None] * P
            for s in work:
                own, nb, w = _block(dist, p, ring_source(p, s, P, direction), transpose)
                offsets, nb, w = _block_adjacency(own, nb, w, vp)
                tables[p][s] = BlockedEll.build(vp, offsets, nb, w, vt, device=device,
                                                src_num=vp, log_stats=False)
        rbe = RingBlockedEll(tables=tables, work=work, edges=int(counts[list(ranks)].sum()),
                             partitions=P, vp=vp, vt=int(vt), n_tiles=-(-vp // vt),
                             direction=int(direction))
        log.info(
            "ring-blocked%s: P=%d vp=%d vt=%d (%d tiles), %d work steps / %d skipped "
            "(empty partition pairs), %d rotation hops, %d table slots (%d rank(s))",
            " (transposed)" if transpose else "", P, vp, vt, rbe.n_tiles, len(work),
            P - len(work), rbe.n_transfers(), rbe.slot_count(), len(tables),
        )
        return rbe

    def work_steps(self) -> List[int]:
        return list(self.work)

    def skipped_steps(self) -> List[int]:
        return [s for s in range(self.partitions) if s not in self.work]

    def n_transfers(self) -> int:
        """Hops per application (a skipped suffix trimmed)."""
        return trim_transfers(self.work)

    def slot_count(self) -> int:
        return sum(t.slot_count() for steps in self.tables.values() for t in steps if t)


def default_ring_vt(vp: int, kernel_tile: int = 0) -> int:
    """The ring's source tile: KERNEL_TILE when set, else ``min(vp, 512)``."""
    return kernel_tile or min(vp, 512)


@dataclasses.dataclass
class RingBlockedPair:
    """The forward ring and the reverse ring over the transposed tables."""

    fwd: RingBlockedEll
    bwd: RingBlockedEll

    @staticmethod
    def build(dist: DistGraph, vt: int, ranks, device="cpu") -> "RingBlockedPair":
        ranks = list(ranks)
        return RingBlockedPair(
            fwd=RingBlockedEll.build(dist, vt, ranks, transpose=False, direction=1,
                                     device=device),
            bwd=RingBlockedEll.build(dist, vt, ranks, transpose=True, direction=-1,
                                     device=device),
        )

    def padding_stats(self) -> dict:
        """Slots over the real edges of the tables held (this rank's, or
        every rank's in the twin)."""
        fwd, bwd = self.fwd.slot_count(), self.bwd.slot_count()
        return {
            "real_edges": self.fwd.edges,
            "fwd_slots": fwd,
            "bwd_slots": bwd,
            "fwd_waste_ratio": fwd / max(self.fwd.edges, 1),
            "bwd_waste_ratio": bwd / max(self.bwd.edges, 1),
        }


def ring_apply(rbe: RingBlockedEll, x: torch.Tensor, group, wire_dtype=None,
               mode: str = "full") -> torch.Tensor:
    """One direction of the ring on this rank's ``[vp, f]`` shard (or slab);
    ``group=None`` runs the twin over the full ``[P*vp, f]`` x."""
    if group is None:
        return ring_apply_simulated(rbe, x, wire_dtype, mode)
    P = rbe.partitions
    steps = rbe.tables[group.rank]
    n_hops = rbe.n_transfers()
    acc = torch.zeros((rbe.vp, x.shape[1]), dtype=torch.float32, device=x.device)
    cur = x
    for s in range(P):
        send = s < n_hops and mode != "compute_only"
        if send:
            hop = group.shift_start(cur if wire_dtype is None else cur.to(wire_dtype),
                                    rbe.direction)
        if mode != "exchange_only" and steps[s] is not None:
            # s > 0 always reads a wire-dtype buffer (compute_only casts the
            # resident shard, so the probe times the same table work)
            steps[s].aggregate_into(acc, cur if wire_dtype is None or s == 0
                                    else cur.to(wire_dtype))
        if send:
            cur = group.shift_wait(hop)
    return (cur if mode == "exchange_only" else acc).to(x.dtype)


def ring_apply_simulated(rbe: RingBlockedEll, x: torch.Tensor, wire_dtype=None,
                         mode: str = "full") -> torch.Tensor:
    """The collective-free twin: per rank, the same step order and f32
    accumulator, the held shard cut from x (cast to the wire dtype from
    step 1 on, as a shipped shard is)."""
    P, vp = rbe.partitions, rbe.vp
    outs = []
    for p in range(P):
        acc = torch.zeros((vp, x.shape[1]), dtype=torch.float32, device=x.device)
        last = x[p * vp:(p + 1) * vp]
        for s in rbe.work:
            q = p if mode == "compute_only" else ring_source(p, s, P, rbe.direction)
            shard = x[q * vp:(q + 1) * vp]
            if wire_dtype is not None and s > 0:
                shard = shard.to(wire_dtype)
            last = shard
            if mode != "exchange_only":
                rbe.tables[p][s].aggregate_into(acc, shard)
        outs.append((last if mode == "exchange_only" else acc).to(x.dtype))
    return torch.cat(outs)


class RingBlockedExchange:
    """The pipelined ring for ``dist_ops.DistExchange``: ``fwd`` is the
    forward ring, ``bwd`` the reverse ring over the transposed tables.
    ``group`` is the ring's group (the vertex group on the 2D mesh; None:
    the twin)."""

    def __init__(self, tables: RingBlockedPair, group, wire_dtype=None):
        self.tables, self.group, self.wire_dtype = tables, group, wire_dtype

    def run(self, x: torch.Tensor, direction: str) -> torch.Tensor:
        return ring_apply(getattr(self.tables, direction), x, self.group, self.wire_dtype)


@torch.no_grad()
def measure_overlap(rbe: RingBlockedEll, x: torch.Tensor, group=None, wire_dtype=None,
                    repeats: int = 3) -> dict:
    """How much of the hop time hides under the step tables' work: the
    median of ``repeats`` warm calls in each mode (CUDA events on the card,
    the host clock after a synchronise on the CPU), and

        hidden     = max(compute + exchange - overlapped, 0)
        efficiency = hidden / exchange   (clamped to [0, 1])

    In the twin (``group=None``) the "exchange" is a slice of x, so the
    numbers measure the schedule's overhead, not wire time."""
    cuda = x.device.type == "cuda"

    def run_mode(mode: str) -> float:
        ring_apply(rbe, x, group, wire_dtype, mode)  # warm
        ts = []
        for _ in range(max(repeats, 1)):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                start.record()
                ring_apply(rbe, x, group, wire_dtype, mode)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                ring_apply(rbe, x, group, wire_dtype, mode)
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    overlap_s = run_mode("full")
    compute_s = run_mode("compute_only")
    exchange_s = run_mode("exchange_only")
    hidden_s = max(compute_s + exchange_s - overlap_s, 0.0)
    efficiency = min(hidden_s / exchange_s, 1.0) if exchange_s > 0 else None
    return {
        "overlap_s": overlap_s,
        "compute_s": compute_s,
        "exchange_s": exchange_s,
        "hidden_s": hidden_s,
        "efficiency": efficiency,
        "simulated": group is None,
        "repeats": int(max(repeats, 1)),
    }


def ring_wire_plan(rbe: RingBlockedEll, widths, itemsize: int, pf: int = 1) -> dict:
    """Per-epoch wire facts: one entry per hop, each shipping ``[vp,
    slab_width(w, pf)]`` per layer exchange (pf = 1: the full width), the
    skip schedule and the exchange's peak residency."""
    slabs = [slab_width(w, pf) for w in widths]
    per_hop = rbe.vp * sum(slabs) * itemsize
    skipped = set(rbe.skipped_steps())
    return {
        "transfers": rbe.n_transfers(),
        "work_steps": rbe.work_steps(),
        "skipped_steps": sorted(skipped),
        "rows_per_transfer": rbe.vp,
        "slab_widths": slabs,
        "slab_cols": sum(slabs),
        "steps": [
            {"step": s, "bytes": per_hop, "skipped": s in skipped,
             "slab_cols": sum(slabs)}
            for s in range(1, rbe.n_transfers() + 1)
        ],
        "peak_resident_rows": min(2, rbe.partitions) * rbe.vp,
        "peak_resident_feature_bytes": (
            min(2, rbe.partitions) * rbe.vp
            * (max(slabs) if slabs else 0) * itemsize
        ),
    }
