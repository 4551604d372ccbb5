"""The split mirror exchange (``COMM_LAYER:mirror``) — port of
``_split_aggregate_body`` and ``dist_gather_dst_from_src_mirror_split(_sim)``
in ``neutronstarlite_tpu/parallel/dist_edge_ops.py``.

Over ``parallel/mirror.SplitMirror``'s layout, rank p computes
``out[v] = sum over remote edges w * mirror[slot] + sum over local edges
w * x[src]`` for its ``vp`` rows:

1. it gathers the rows its consumers need from its shard (``need_ids[p]``,
   ``[P, mb, f]``) and exchanges them with one ``all_to_all``: chunk q of
   what arrives is the ``[mb, f]`` rows producer q gathered for p, the
   ``[P*mb, f]`` mirror space (the diagonal chunk is dead rows no edge
   reads);
2. it sums the remote edge list over the mirror rows and the local list
   over its resident shard.

As in JAX, the products and the sums are f32 (the x-dtype rows times the
f32 weights), added as two sums and cast once to x's dtype. The
backward on ranks is explicit: the transposed local sum into the shard's
gradient, plus the remote edges' gradient rows per mirror slot, sent back
to their producers by a second ``all_to_all`` (in x's dtype, as the
forward ships them) and scatter-added through ``need_ids``. The twin
(``group=None``) gathers every consumer's mirror rows from the full x
and lets autograd take the backward, which the gloo ranks are held to.

The uniform mirror exchange and the edge ops of GAT/GGCN come with the
edge-family slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from neutronstarlite_torch.parallel.mirror import SplitMirror

# bound on one chunk's [edges, f] float32 products
_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class MirrorTables:
    """One rank's device tables: ``need`` [P*mb] ids into its shard (the
    rows it sends, consumer-major), the remote list (``r_slot`` into the
    mirror space, ``r_dst``, ``r_w`` = weight * mask) and the local list
    (``l_src``, ``l_dst``, ``l_w``)."""

    need: torch.Tensor
    r_slot: torch.Tensor
    r_dst: torch.Tensor
    r_w: torch.Tensor
    l_src: torch.Tensor
    l_dst: torch.Tensor
    l_w: torch.Tensor

    @staticmethod
    def of(sm: SplitMirror, p: int, device) -> "MirrorTables":
        def ids(a):
            return torch.from_numpy(a.astype("int64")).to(device)

        def wgt(w, m):
            return torch.from_numpy(w * m).to(device)

        return MirrorTables(
            need=ids(sm.need_ids[p].reshape(-1)),
            r_slot=ids(sm.r_src_slot[p]), r_dst=ids(sm.r_dst[p]),
            r_w=wgt(sm.r_weight[p], sm.r_mask[p]),
            l_src=ids(sm.l_src[p]), l_dst=ids(sm.l_dst[p]),
            l_w=wgt(sm.l_weight[p], sm.l_mask[p]),
        )


def _edge_sum(rows: int, src, dst, w, x: torch.Tensor) -> torch.Tensor:
    """[rows, f] f32: out[dst] += w * x[src] per edge, f32 products, in
    chunks bounding the [edges, f] intermediate."""
    out = torch.zeros((rows, x.shape[1]), dtype=torch.float32, device=x.device)
    chunk = max(1, _CHUNK_BYTES // max(4 * x.shape[1], 1))
    for lo in range(0, src.shape[0], chunk):
        vals = x[src[lo:lo + chunk]].float() * w[lo:lo + chunk, None]
        out = out.index_add(0, dst[lo:lo + chunk], vals)
    return out


def split_aggregate(vp: int, t: MirrorTables, mirrors: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """One rank's aggregation: the remote sum over its mirror rows plus the
    local sum over its shard, f32, cast once to the shard's dtype."""
    rem = _edge_sum(vp, t.r_slot, t.r_dst, t.r_w, mirrors)
    loc = _edge_sum(vp, t.l_src, t.l_dst, t.l_w, xs)
    return (rem + loc).to(xs.dtype)


class _SplitMirrorRank(torch.autograd.Function):
    """The exchange on a rank, with its explicit backward."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        t = ex.tables[ex.group.rank]
        mirrors = ex.group.all_to_all(x[t.need])
        return split_aggregate(ex.sm.vp, t, mirrors, x)

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        t, sm = ex.tables[ex.group.rank], ex.sm
        gf = g.contiguous()
        # the transposed sums: the local list into the shard, the remote
        # list into the mirror slots
        gx = _edge_sum(sm.vp, t.l_dst, t.l_src, t.l_w, gf)
        gm = _edge_sum(sm.partitions * sm.mb, t.r_dst, t.r_slot, t.r_w, gf)
        back = ex.group.all_to_all(gm.to(g.dtype))
        gx.index_add_(0, t.need, back.float())
        return gx.to(g.dtype), None


class SplitMirrorExchange:
    """``COMM_LAYER:mirror``: the split mirror exchange over ``group``
    (None: the twin, every rank's tables in one process)."""

    def __init__(self, sm: SplitMirror, group, device="cpu"):
        self.sm, self.group = sm, group
        ranks = range(sm.partitions) if group is None else [group.rank]
        self.tables: Dict[int, MirrorTables] = {p: MirrorTables.of(sm, p, device)
                                                for p in ranks}
        if group is None:
            # each consumer's mirror rows as ids into the full [P*vp] x
            P, vp = sm.partitions, sm.vp
            base = (torch.arange(P, device=device) * vp)[:, None]
            self._mirror_ids = {
                p: (base + torch.from_numpy(sm.need_ids[:, p].astype("int64")).to(device)
                    ).reshape(-1)
                for p in range(P)
            }

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            return _SplitMirrorRank.apply(x.contiguous(), self)
        return dist_gather_dst_from_src_mirror_split_sim(self, x)


def dist_gather_dst_from_src_mirror_split_sim(ex: SplitMirrorExchange,
                                              x: torch.Tensor) -> torch.Tensor:
    """The collective-free twin over the full [P*vp, f] x (autograd takes
    the backward)."""
    P, vp = ex.sm.partitions, ex.sm.vp
    return torch.cat([
        split_aggregate(vp, ex.tables[p], x[ex._mirror_ids[p]], x[p * vp:(p + 1) * vp])
        for p in range(P)
    ])
