"""The distributed exchanges — port of ``neutronstarlite_tpu/parallel/dist_ops.py``
and of the exchange halves of ``dist_ell.py``, ``dist_bsp.py`` and
``dist_blocked.py``.

Every exchange computes ``out[v] = sum over in-edges (u -> v) of w_uv *
x[u]`` over the padded ``[P*vp, f]`` vertex space, and its gradient, the
same sum over the transposed adjacency (``DistExchange``, one
``autograd.Function`` for all of them). Each rank holds its ``[vp, f]``
shard; with ``group=None`` (the sim twin) one process holds the whole
array and runs every shard's part in turn, in the order the ranks would.

- **The all_gather family** (``GatherExchange``): one ``all_gather`` of
  the shards, then a collective-free aggregation over the rank's own
  rectangular tables (``vp`` rows over ``P*vp`` sources): ELL
  (``dist_ell.py``, the ``ell_level`` kernel), bsp (``dist_bsp.py``, the
  ``bsp_ell`` kernel) or blocked ELL (``dist_blocked.py``, plain
  PyTorch). The backward all_gathers the gradient shards and runs the
  transposed tables (rows = the rank's sources, neighbours = global
  destination ids), as JAX's custom VJP does. The twin
  (``gather_simulated``) runs each shard's tables over the full x and
  concatenates the outputs.
- **The ring** (``RingExchange``, ``COMM_LAYER:ring``): at ring step s
  rank p holds the shard of partition (p + s) % P, starts sending it to
  rank p - 1 (and receiving rank p + 1's), adds block (p, (p + s) % P)
  into an f32 accumulator while the hop flies (products in x's dtype, the
  port's scatter policy), then waits: P - 1 send/recv rounds, the hop of
  ``mesh.ProcessGroup.shift_start`` / ``shift_wait`` that the pipelined
  ring (``dist_ring_blocked.py``) uses too. The backward is the reverse ring:
  rank q holds the gradient shard of (q - s) % P at step s and adds the
  transposed block ((q - s) % P, q). ``ring_aggregate_simulated`` is its
  twin, with the same per-rank order of additions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from neutronstarlite_torch.obs import cost
from neutronstarlite_torch.parallel.dist_graph import DistGraph

# bound on one ring step chunk's [edges, f] float32 intermediate
_CHUNK_BYTES = 256 << 20


class DistExchange(torch.autograd.Function):
    """``ex.run(x, "fwd")``, whose gradient is ``ex.run(g, "bwd")``."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex.run(x.contiguous(), "fwd")

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.run(g.contiguous(), "bwd"), None


def dist_gather_dst_from_src(ex, x: torch.Tensor) -> torch.Tensor:
    """Differentiable exchange of this rank's (or, in the twin, every
    rank's) rows: [vp or P*vp, f] -> the same shape. An exchange with an
    ``apply`` of its own (the split mirror, ``dist_edge_ops.py``) takes
    its backward there."""
    apply = getattr(ex, "apply", None)
    return apply(x) if apply is not None else DistExchange.apply(x, ex)


@dataclasses.dataclass
class ShardTables:
    """One route's per-shard tables, keyed by shard: ``fwd[p]`` aggregates
    into partition p's rows, ``bwd[p]`` is its transposed twin. A rank keeps
    only its own shard; the sim twin keeps all P. ``edges[direction][p]`` is
    the real edges of a shard's tables."""

    fwd: Dict[int, Any]
    bwd: Dict[int, Any]
    partitions: int
    vp: int
    edges: Dict[str, Dict[int, int]]

    def slot_count(self, direction: str = "fwd") -> int:
        return sum(t.slot_count() for t in getattr(self, direction).values())

    def padding_stats(self, real_edges: int) -> dict:
        fwd, bwd = self.slot_count("fwd"), self.slot_count("bwd")
        return {
            "real_edges": int(real_edges),
            "fwd_slots": fwd,
            "bwd_slots": bwd,
            "fwd_waste_ratio": fwd / max(real_edges, 1),
            "bwd_waste_ratio": bwd / max(real_edges, 1),
        }


def gather_simulated(tables: Dict[int, Any], x: torch.Tensor, kernel: Callable) -> torch.Tensor:
    """The all_gather family's twin: each shard's tables over the full
    [P*vp, f] x, the outputs concatenated."""
    return torch.cat([kernel(tables[p], x) for p in sorted(tables)])


class GatherExchange:
    """all_gather + per-shard aggregation through ``kernel(tables, xg)``.
    ``name`` names a hand-written kernel, whose per-shard calls are noted
    for the program cost (``obs/cost``: FlopCounterMode cannot see them).
    None for the blocked tables, which are plain PyTorch and, as on one
    device, not priced (FlopCounterMode counts no gather or sum)."""

    def __init__(self, tables: ShardTables, kernel: Callable, group,
                 name: Optional[str] = None):
        self.tables, self.kernel, self.group, self.name = tables, kernel, group, name

    def run(self, x: torch.Tensor, direction: str) -> torch.Tensor:
        tabs = getattr(self.tables, direction)
        if self.name is not None:
            t = self.tables
            for p in (sorted(tabs) if self.group is None else [self.group.rank]):
                cost.note_kernel(self.name, direction, x,
                                 (p, t.edges[direction][p], t.vp, t.partitions * t.vp))
        if self.group is None:
            return gather_simulated(tabs, x, self.kernel)
        return self.kernel(tabs[self.group.rank], self.group.all_gather(x))


# ---- the ring -------------------------------------------------------------------


def _scatter_add(acc: torch.Tensor, src, dst, w, x: torch.Tensor) -> None:
    """acc[dst] += w * x[src] per edge: products in x's dtype, added in
    f32, in chunks bounding the [edges, f] intermediate."""
    chunk = max(1, _CHUNK_BYTES // max(4 * x.shape[1], 1))
    for lo in range(0, src.shape[0], chunk):
        vals = x[src[lo:lo + chunk]] * w[lo:lo + chunk, None].to(x.dtype)
        acc.index_add_(0, dst[lo:lo + chunk], vals.float())


Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (src, dst, weight)


@dataclasses.dataclass
class RingTables:
    """Per rank, per ring step, the real edges of the block it adds: ``fwd[p][s]``
    is block (p, (p+s) % P) (sources in the shard it holds, destinations in
    its own); ``bwd[q][s]`` is block ((q-s) % P, q) transposed."""

    fwd: Dict[int, List[Step]]
    bwd: Dict[int, List[Step]]
    partitions: int
    vp: int

    @staticmethod
    def build(dist: DistGraph, ranks: Iterable[int], device="cpu") -> "RingTables":
        rb = dist.step_blocks()
        P, cnt = dist.partitions, dist.block_count

        def dev(a):
            return torch.from_numpy(a).to(device)

        def ids(a):
            return torch.from_numpy(a.astype("int64")).to(device)

        fwd, bwd = {}, {}
        for p in ranks:
            fwd[p] = []
            bwd[p] = []
            for s in range(P):
                n = int(cnt[p, (p + s) % P])
                fwd[p].append((ids(rb.src[s][p, :n]), ids(rb.dst[s][p, :n]),
                               dev(rb.wgt[s][p, :n])))
                r = (p - s) % P  # step s row r is block (r, p)
                n = int(cnt[r, p])
                bwd[p].append((ids(rb.dst[s][r, :n]), ids(rb.src[s][r, :n]),
                               dev(rb.wgt[s][r, :n])))
        return RingTables(fwd=fwd, bwd=bwd, partitions=P, vp=dist.vp)


class RingExchange:
    """The ring over ``tables`` (``group=None``: the twin)."""

    def __init__(self, tables: RingTables, group):
        self.tables, self.group = tables, group

    def run(self, x: torch.Tensor, direction: str) -> torch.Tensor:
        P, vp = self.tables.partitions, self.tables.vp
        sign = 1 if direction == "fwd" else -1  # the shard held at step s: p + sign*s
        steps = getattr(self.tables, direction)
        f = x.shape[1]
        if self.group is None:
            outs = []
            for p in range(P):
                acc = torch.zeros((vp, f), dtype=torch.float32, device=x.device)
                for s, (src, dst, w) in enumerate(steps[p]):
                    q = (p + sign * s) % P
                    _scatter_add(acc, src, dst, w, x[q * vp:(q + 1) * vp])
                outs.append(acc.to(x.dtype))
            return torch.cat(outs)
        acc = torch.zeros((vp, f), dtype=torch.float32, device=x.device)
        cur = x
        for s, (src, dst, w) in enumerate(steps[self.group.rank]):
            # start the hop, add this step's block while it flies, then wait
            hop = self.group.shift_start(cur, sign) if s != P - 1 else None
            _scatter_add(acc, src, dst, w, cur)
            if hop is not None:
                cur = self.group.shift_wait(hop)
        return acc.to(x.dtype)


def ring_aggregate_simulated(tables: RingTables, x: torch.Tensor) -> torch.Tensor:
    """The ring's collective-free twin over the full [P*vp, f] x."""
    return RingExchange(tables, None).run(x, "fwd")
