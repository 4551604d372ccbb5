"""The mirror-slot exchanges and the distributed edge ops — port of
``neutronstarlite_tpu/parallel/dist_edge_ops.py``.

**The uniform mirror** (``mirror.MirrorGraph``; GAT/GGCN dist, TEST_GETDEP,
the DepCache GCN). ``dist_get_dep_nbr`` materialises a rank's mirror rows
``[P*mb, f]`` with one ``all_to_all``: the rank gathers, for each
consumer q, the rows ``need_ids[rank, q]`` of its shard, and chunk q of
what arrives is what producer q gathered for it. Its backward sends the
gradient rows back by a second ``all_to_all`` and scatter-adds them
through ``need_ids``. Then, over the rank's destination-sorted edge list
(padding: mask 0, dst ``vp - 1``):

- ``dist_scatter_src`` (mirror -> edge), ``dist_scatter_dst`` (vertex ->
  edge), masked;
- ``dist_edge_softmax``: per-destination softmax of masked scores (a
  padded slot takes no part in the max, the sum or the gradient; a
  destination with no live edge gives exact zeros), with the hand-paired
  backward s * (g - sum_seg(s * g));
- ``dist_aggregate_dst`` (sum), ``dist_aggregate_dst_max`` / ``_min`` (the
  gradient goes to the first live edge that attains the extreme);
- ``dist_aggregate_dst_fuse_weight``: out[dst] = sum_e w_e * mirror[slot],
  differentiable in both, in chunks of edges so that no ``[El, f]``
  product is kept for the backward; products and sums f32 whatever the
  input dtype, the output f32 (JAX accumulates wide too);
- ``dist_gather_dst_from_src_mirror``: the weighted aggregation through the
  exchange;
- ``dist_gated_chain_chunked``: the GAT/GGCN chain (mirror fetch ->
  leaky_relu(src half + dst half) -> softmax -> gated sum of the payload's
  first f columns) a destination-aligned chunk at a time
  (``mirror.chunk_edge_list``), each chunk recomputed in the backward by
  ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``) and written over
  its ``dp``-row window of a ``[vp + dp, f]`` f32 buffer in order, as JAX's
  ``dynamic_update_slice`` does.

Every op takes the exchange ``UniformMirror``; with ``group=None`` (the
collective-free twin, JAX's ``*_sim``) it runs every rank's tables at once
over the edge lists flattened rank-major: edges ``[P*El, ...]``, mirror rows
``[P*P*mb, f]`` (JAX's ``[P, P*mb, f]`` reshaped), vertices ``[P*vp, f]``.
The per-destination segments of different ranks are disjoint, so the
flattened sums are each rank's own.

**The split mirror** (``COMM_LAYER:mirror`` on the GCN family, port of
``_split_aggregate_body`` and ``dist_gather_dst_from_src_mirror_split(_sim)``).
Over ``mirror.SplitMirror``'s layout, rank p computes ``out[v] = sum over
remote edges w * mirror[slot] + sum over local edges w * x[src]`` for its
``vp`` rows:

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

No op here launches a hand-written kernel: in JAX these are XLA segment
ops and an ``all_to_all``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neutronstarlite_torch.ops.segment import (
    segment_max_sorted,
    segment_min_sorted,
    segment_sum_sorted,
)
from neutronstarlite_torch.parallel.mirror import (
    ChunkedEdgeList,
    MirrorGraph,
    SplitMirror,
    chunk_edge_list,
)

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


# ---------------------------------------------------------------------------
# the uniform mirror exchange
# ---------------------------------------------------------------------------


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: f32 for bf16 and f32 inputs (JAX sums
    wide), f64 for f64 ones."""
    return torch.promote_types(dtype, torch.float32)


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)


@dataclasses.dataclass
class EdgeLists:
    """Destination-sorted edge tables of one rank, or of every rank
    flattened rank-major (the twin): ``slot`` into the mirror rows, ``dst``
    into ``rows`` vertex rows, ``weight`` and ``mask`` f32."""

    slot: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    rows: int

    @staticmethod
    def of_rank(mg: MirrorGraph, p: int, device="cpu") -> "EdgeLists":
        return EdgeLists(
            slot=_ids(mg.edge_src_slot[p], device), dst=_ids(mg.edge_dst[p], device),
            weight=torch.from_numpy(mg.edge_weight[p].copy()).to(device),
            mask=torch.from_numpy(mg.edge_mask[p].copy()).to(device), rows=mg.vp,
        )

    @staticmethod
    def of_twin(mg: MirrorGraph, device="cpu") -> "EdgeLists":
        P, mb, vp = mg.partitions, mg.mb, mg.vp
        p = np.arange(P, dtype=np.int64)[:, None]
        return EdgeLists(
            slot=_ids((mg.edge_src_slot + p * (P * mb)).reshape(-1), device),
            dst=_ids((mg.edge_dst + p * vp).reshape(-1), device),
            weight=torch.from_numpy(mg.edge_weight.reshape(-1).copy()).to(device),
            mask=torch.from_numpy(mg.edge_mask.reshape(-1).copy()).to(device),
            rows=P * vp,
        )


@dataclasses.dataclass
class ChunkTables:
    """One rank's destination-aligned chunks (``mirror.ChunkedEdgeList``
    row p): per chunk the slot, p-local dst, chunk-relative dst and mask
    tensors, and its base row on the host."""

    slot: List[torch.Tensor]
    dstl: List[torch.Tensor]
    dstr: List[torch.Tensor]
    mask: List[torch.Tensor]
    base: List[int]
    dp: int

    @staticmethod
    def of_rank(ch: ChunkedEdgeList, p: int, device="cpu") -> "ChunkTables":
        n = ch.n_chunks
        return ChunkTables(
            slot=[_ids(ch.slot[p, k], device) for k in range(n)],
            dstl=[_ids(ch.dstl[p, k], device) for k in range(n)],
            dstr=[_ids(ch.dstr[p, k], device) for k in range(n)],
            mask=[torch.from_numpy(ch.mask[p, k].copy()).to(device) for k in range(n)],
            base=[int(b) for b in ch.base[p]], dp=ch.dp,
        )


class UniformMirror:
    """The uniform mirror exchange over ``group`` (None: the twin).

    A rank keeps ``need`` (``need_ids[rank]`` consumer-major, the rows it
    sends) and its edge lists; with ``chunk`` (the chunked chain's target
    edges per chunk) it keeps its chunk tables instead, as JAX ships only
    need_ids and the chunks to a mesh; ``edges=False`` keeps neither (the
    exchange alone). The twin keeps every rank's edge lists flattened and
    ``mirror_src``, each mirror row's source row in the full ``[P*vp]`` x."""

    def __init__(self, mg: MirrorGraph, group=None, device="cpu",
                 chunk: Optional[int] = None, edges: bool = True):
        self.mg, self.group = mg, group
        P, vp = mg.partitions, mg.vp
        self.edges: Optional[EdgeLists] = None
        self.chunks: Optional[ChunkTables] = None
        self.chunk_list: Optional[ChunkedEdgeList] = None
        if group is None:
            if edges:
                self.edges = EdgeLists.of_twin(mg, device)
            src = np.arange(P, dtype=np.int64)[None, :, None] * vp \
                + mg.need_ids.transpose(1, 0, 2).astype(np.int64)  # [p, q, mb]
            self.mirror_src = _ids(src.reshape(-1), device)
            return
        r = group.rank
        self.need = _ids(mg.need_ids[r].reshape(-1), device)
        if not edges:
            return
        if chunk is None:
            self.edges = EdgeLists.of_rank(mg, r, device)
        else:
            self.chunk_list = chunk_edge_list(mg, chunk)
            self.chunks = ChunkTables.of_rank(self.chunk_list, r, device)


class _AllToAllGather(torch.autograd.Function):
    """``all_to_all(x[need])`` on a rank; the backward returns the gradient
    rows to their producers and scatter-adds them through ``need``."""

    @staticmethod
    def forward(ctx, x, need, group):
        ctx.need, ctx.group, ctx.n = need, group, x.shape[0]
        return group.all_to_all(x[need])

    @staticmethod
    def backward(ctx, g):
        back = ctx.group.all_to_all(g.contiguous())
        gx = torch.zeros((ctx.n,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
        return gx.index_add_(0, ctx.need, back), None, None


def all_to_all_gather(x: torch.Tensor, need: torch.Tensor, group) -> torch.Tensor:
    """The rows ``need`` (consumer-major) of this rank's shard, exchanged:
    chunk q of the result came from rank q."""
    return _AllToAllGather.apply(x.contiguous(), need, group)


def dist_get_dep_nbr(ex: UniformMirror, x: torch.Tensor) -> torch.Tensor:
    """Vertex rows -> mirror rows: ``[vp, f] -> [P*mb, f]`` on a rank,
    ``[P*vp, f] -> [P*P*mb, f]`` in the twin."""
    if ex.group is None:
        return x[ex.mirror_src]
    return all_to_all_gather(x, ex.need, ex.group)


def _bcast(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return mask.to(t.dtype).view((-1,) + (1,) * (t.dim() - 1))


def scatter_src_body(el: EdgeLists, mirrors: torch.Tensor) -> torch.Tensor:
    ev = mirrors[el.slot]
    return ev * _bcast(el.mask, ev)


def scatter_dst_body(el: EdgeLists, x: torch.Tensor) -> torch.Tensor:
    ev = x[el.dst]
    return ev * _bcast(el.mask, ev)


def dist_scatter_src(ex: UniformMirror, mirrors: torch.Tensor) -> torch.Tensor:
    """Mirror rows -> edges through the slot table (padding zero)."""
    return scatter_src_body(ex.edges, mirrors)


def dist_scatter_dst(ex: UniformMirror, x: torch.Tensor) -> torch.Tensor:
    """Vertex rows -> edges by destination (padding zero)."""
    return scatter_dst_body(ex.edges, x)


def dist_aggregate_dst(ex: UniformMirror, ev: torch.Tensor) -> torch.Tensor:
    """Edges -> vertex rows, the masked sum over in-edges."""
    el = ex.edges
    return segment_sum_sorted(ev * _bcast(el.mask, ev), el.dst, el.rows)


class MaskedEdgeSoftmax(torch.autograd.Function):
    """Per-destination softmax of the live slots' scores [E, C]: a masked
    slot scores -inf and weighs 0; a destination with no live slot gives
    zeros. Backward s * (g - sum_seg(s * g)), masked. The exponentials,
    the denominators and the backward's sums are f32 for a bf16 score (the
    reference sums the denominator in bf16, which loses a hub's tail);
    the result is cast back to the score's dtype."""

    @staticmethod
    def forward(ctx, score, dst, mask, rows: int):
        out_dtype = score.dtype
        score = score.to(_wide(score.dtype))
        live = (mask > 0)[:, None]
        masked = torch.where(live, score, torch.full_like(score, float("-inf")))
        m = segment_max_sorted(masked, dst, rows)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.where(live, torch.exp(masked - m[dst]), torch.zeros_like(score))
        denom = segment_sum_sorted(e, dst, rows)
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        s = e / denom[dst]
        ctx.rows, ctx.out_dtype = rows, out_dtype
        ctx.save_for_backward(s, dst, mask)
        return s.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        s, dst, mask = ctx.saved_tensors
        g = g.to(s.dtype)
        tot = segment_sum_sorted(s * g, dst, ctx.rows)
        grad = s * (g - tot[dst]) * mask.to(s.dtype)[:, None]
        return grad.to(ctx.out_dtype), None, None, None


def edge_softmax_body(rows: int, dst, mask, score: torch.Tensor) -> torch.Tensor:
    squeeze = score.dim() == 1
    out = MaskedEdgeSoftmax.apply(score[:, None] if squeeze else score, dst, mask, rows)
    return out[:, 0] if squeeze else out


def dist_edge_softmax(ex: UniformMirror, score: torch.Tensor) -> torch.Tensor:
    """Edge scores [E, C] -> the per-destination softmax, padding masked."""
    el = ex.edges
    return edge_softmax_body(el.rows, el.dst, el.mask, score)


class MaskedExtreme(torch.autograd.Function):
    """Per-destination elementwise max (or min) over the live edges; the
    gradient of each (vertex, column) goes to the first live edge that
    attains it. A vertex with no live edge gets 0 and passes none."""

    @staticmethod
    def forward(ctx, ev, dst, mask, rows: int, is_min: bool):
        e_num = ev.shape[0]
        live = (mask > 0)[:, None]
        fill = float("inf") if is_min else float("-inf")
        masked = torch.where(live, ev, torch.full_like(ev, fill))
        seg = (segment_min_sorted if is_min else segment_max_sorted)(masked, dst, rows)
        eidx = torch.arange(e_num, dtype=torch.int64, device=ev.device)[:, None]
        hit = (masked == seg[dst]) & live
        record = segment_min_sorted(
            torch.where(hit, eidx, torch.full_like(eidx, e_num)).expand_as(ev).contiguous(),
            dst, rows).clamp_(max=e_num)
        ctx.save_for_backward(record)
        ctx.e_num = e_num
        return torch.where(torch.isfinite(seg), seg, torch.zeros_like(seg))

    @staticmethod
    def backward(ctx, g):
        (record,) = ctx.saved_tensors
        e_num, f = ctx.e_num, g.shape[1]
        valid = record < e_num
        flat = record.clamp(max=max(e_num - 1, 0)) * f + torch.arange(
            f, dtype=torch.int64, device=g.device)
        grad = torch.zeros(e_num * f, dtype=g.dtype, device=g.device)
        grad.index_add_(0, flat[valid], g[valid])
        return grad.view(e_num, f), None, None, None, None


def dist_aggregate_dst_max(ex: UniformMirror, ev: torch.Tensor) -> torch.Tensor:
    el = ex.edges
    return MaskedExtreme.apply(ev, el.dst, el.mask, el.rows, False)


def dist_aggregate_dst_min(ex: UniformMirror, ev: torch.Tensor) -> torch.Tensor:
    el = ex.edges
    return MaskedExtreme.apply(ev, el.dst, el.mask, el.rows, True)


class MaskedWeightedSum(torch.autograd.Function):
    """out[dst] = sum over live edges of w[e] * m[slot[e]] (w [E, 1] or
    [E, f]) in chunks of edges, wide (f32, f64 for f64 input) products
    and sums, out in that dtype. The
    backward: grad_m[slot] += w * g[dst]; grad_w[e] = g[dst] * m[slot]
    (summed over f when w is [E, 1]), 0 on padding."""

    @staticmethod
    def forward(ctx, w, m, slot, dst, mask, rows: int):
        ctx.rows = rows
        ctx.save_for_backward(w, m, slot, dst, mask)
        acc = _wide(m.dtype)
        out = torch.zeros((rows, m.shape[1]), dtype=acc, device=m.device)
        step = max(1, _CHUNK_BYTES // max(4 * m.shape[1], 1))
        for lo in range(0, slot.shape[0], step):
            sl = slice(lo, lo + step)
            wm = w[sl].to(acc) * mask[sl, None]
            out.index_add_(0, dst[sl], m[slot[sl]].to(acc) * wm)
        return out

    @staticmethod
    def backward(ctx, g):
        w, m, slot, dst, mask = ctx.saved_tensors
        need_w, need_m = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        acc = _wide(m.dtype)
        gm = torch.zeros(m.shape, dtype=acc, device=m.device) if need_m else None
        gw = torch.empty(w.shape, dtype=acc, device=w.device) if need_w else None
        step = max(1, _CHUNK_BYTES // max(4 * m.shape[1], 1))
        for lo in range(0, slot.shape[0], step):
            sl = slice(lo, lo + step)
            gd = g[dst[sl]].to(acc)
            mk = mask[sl, None]
            if need_m:
                gm.index_add_(0, slot[sl], gd * (w[sl].to(acc) * mk))
            if need_w:
                prod = gd * m[slot[sl]].to(acc)
                gw[sl] = (prod.sum(1, keepdim=True) if w.shape[1] == 1 else prod) * mk
        return (gw.to(w.dtype) if need_w else None, gm.to(m.dtype) if need_m else None,
                None, None, None, None)


def fuse_weight_body(el: EdgeLists, w: torch.Tensor, mirrors: torch.Tensor) -> torch.Tensor:
    w = w[:, None] if w.dim() == 1 else w
    return MaskedWeightedSum.apply(w, mirrors, el.slot, el.dst, el.mask, el.rows)


def dist_aggregate_dst_fuse_weight(ex: UniformMirror, w: torch.Tensor,
                                   mirrors: torch.Tensor) -> torch.Tensor:
    """out[dst] = sum_e w_e * mirror[slot(e)] (f32) -> vertex rows."""
    return fuse_weight_body(ex.edges, w, mirrors)


def dist_gather_dst_from_src_mirror(ex: UniformMirror, x: torch.Tensor) -> torch.Tensor:
    """The weighted aggregation out[v] = sum over in-edges of w * x[src]
    through the uniform exchange (f32)."""
    return dist_aggregate_dst_fuse_weight(ex, ex.edges.weight, dist_get_dep_nbr(ex, x))


# ---- the gated chain ---------------------------------------------------------


def gated_chain_body(el: EdgeLists, mirrors: torch.Tensor, dst_half: torch.Tensor,
                     f: int, slope: float) -> torch.Tensor:
    """The whole chain over one edge list (a rank's, or the twin's flattened
    one) at once: ``mirrors`` [.., f + C] = [h || src half], ``dst_half``
    [rows, C]; returns the wide (f32) gated sum [rows, f]."""
    e_src = scatter_src_body(el, mirrors[:, f:])
    e_dst = scatter_dst_body(el, dst_half)
    a = edge_softmax_body(el.rows, el.dst, el.mask, F.leaky_relu(e_src + e_dst, slope))
    return fuse_weight_body(el, a, mirrors[:, :f])


def _chain_chunk(mirrors, dst_half, slot, dstl, dstr, mask, dp: int, f: int,
                 slope: float) -> torch.Tensor:
    rows = mirrors[slot]
    score = F.leaky_relu(rows[:, f:] + dst_half[dstl], slope)
    a = edge_softmax_body(dp, dstr, mask, score)
    vals = rows[:, :f] * a * mask.to(rows.dtype)[:, None]
    return segment_sum_sorted(vals.to(_wide(vals.dtype)), dstr, dp)


def gated_chain_chunked_body(ct: ChunkTables, vp: int, mirrors: torch.Tensor,
                             dst_half: torch.Tensor, f: int, slope: float) -> torch.Tensor:
    """The chain a chunk at a time, each chunk recomputed in the backward;
    chunk k's ``dp`` rows are written over rows ``base[k]:base[k] + dp`` of
    a ``[vp + dp, f]`` f32 buffer in order (a later chunk overwrites the
    zero rows past an earlier one's range; pad chunks land in the
    margin). Returns ``[vp, f]``."""
    dp = ct.dp
    out = torch.zeros((vp + dp, f), dtype=_wide(mirrors.dtype), device=mirrors.device)
    for k, b in enumerate(ct.base):
        seg = checkpoint(_chain_chunk, mirrors, dst_half, ct.slot[k], ct.dstl[k],
                         ct.dstr[k], ct.mask[k], dp, f, slope, use_reentrant=False)
        out[b:b + dp] = seg
    return out[:vp]


def dist_gated_chain(ex: UniformMirror, payload: torch.Tensor, dst_half: torch.Tensor,
                     f: int, slope: float) -> torch.Tensor:
    """The gated edge chain of GAT (payload [h || h.a_src], C = 1) and GGCN
    ([h || Ws.h], C = f'): the mirror exchange of the payload, then the
    chain, chunked when the exchange holds chunk tables (the ranks), else
    whole (the twin, as JAX's sim chain)."""
    mir = dist_get_dep_nbr(ex, payload)
    if ex.chunks is not None:
        return gated_chain_chunked_body(ex.chunks, ex.mg.vp, mir, dst_half, f, slope)
    return gated_chain_body(ex.edges, mir, dst_half, f, slope)
