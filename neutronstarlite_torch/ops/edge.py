"""Edge-level operators: V->E scatter, E->V aggregate, per-destination edge
softmax — port of ``neutronstarlite_tpu/ops/edge.py``.

The graph is an ``ops.aggregate.ScatterGraph`` (the port's counterpart of
the JAX ``DeviceGraph``): edge tensors are [E, ...] in CSC (destination-
sorted) order. The JAX module pads the edge arrays to a chunk multiple for
XLA's static shapes and masks the padding; here there is no padding, so the
mask is all ones and needs no tensor.

- ``scatter_src_to_edge`` / ``scatter_dst_to_edge`` / ``scatter_src_dst_to_edge``:
  V->E gathers (autograd's transpose is the scatter-add).
- ``aggregate_edge_to_dst``: E->V sum.
- ``aggregate_edge_to_dst_weighted``: out[v] = sum over in-edges e of
  w_e * x[src(e)], differentiable in both w ([E], [E, 1] or [E, f]) and x.
  An ``autograd.Function`` that works in chunks of edges, so that no whole
  [E, f] product is saved for the backward; products and the accumulator
  are f32, cast once.
- ``aggregate_edge_to_dst_max`` / ``_min``: per-destination elementwise
  extreme; the gradient goes to the first edge (in CSC order) that attains
  it.
- ``edge_softmax``: per-destination softmax over in-edge scores, with the
  hand-paired backward s * (g - sum_seg(s * g)). A destination with no
  in-edge has no edge to weight, so it aggregates to exact zeros.
"""

from __future__ import annotations

import torch

from neutronstarlite_torch.ops.aggregate import _CHUNK_BYTES, ScatterGraph
from neutronstarlite_torch.ops.segment import (
    segment_max_sorted,
    segment_min_sorted,
    segment_sum_sorted,
)


def scatter_src_to_edge(graph: ScatterGraph, x: torch.Tensor) -> torch.Tensor:
    """[V, f] -> [E, f]: edge e gets x[src(e)]."""
    return x[graph.csc_src]


def scatter_dst_to_edge(graph: ScatterGraph, x: torch.Tensor) -> torch.Tensor:
    """[V, f] -> [E, f]: edge e gets x[dst(e)]."""
    return x[graph.csc_dst]


def scatter_src_dst_to_edge(graph: ScatterGraph, x: torch.Tensor) -> torch.Tensor:
    """[V, f] -> [E, 2f]: edge e gets [x[src(e)] || x[dst(e)]]."""
    return torch.cat([scatter_src_to_edge(graph, x), scatter_dst_to_edge(graph, x)], dim=1)


def aggregate_edge_to_dst(graph: ScatterGraph, edge_vals: torch.Tensor) -> torch.Tensor:
    """[E, f] -> [V, f]: out[v] = sum of edge_vals over in-edges of v."""
    return segment_sum_sorted(edge_vals, graph.csc_dst, graph.v_num)


def _chunk(f: int) -> int:
    return max(1, _CHUNK_BYTES // max(4 * f, 1))


class WeightedAggregate(torch.autograd.Function):
    """out[v] = sum over in-edges e of w[e] * x[src(e)], w [E, 1] or [E, f].

    The backward: grad_x[u] = sum over out-edges e of w[e] * g[dst(e)], and
    grad_w[e] = g[dst(e)] * x[src(e)] (summed over f when w is [E, 1]).
    Both run over the same edge chunks as the forward."""

    @staticmethod
    def forward(ctx, w, x, graph: ScatterGraph):
        ctx.graph = graph
        ctx.save_for_backward(w, x)
        src, dst = graph.csc_src, graph.csc_dst
        out = torch.zeros((graph.v_num, x.shape[1]), dtype=torch.float32, device=x.device)
        step = _chunk(x.shape[1])
        for lo in range(0, src.shape[0], step):
            vals = x[src[lo:lo + step]].float() * w[lo:lo + step].float()
            out.index_add_(0, dst[lo:lo + step], vals)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        graph = ctx.graph
        src, dst = graph.csc_src, graph.csc_dst
        need_w, need_x = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) if need_x else None
        gw = torch.empty(w.shape, dtype=torch.float32, device=w.device) if need_w else None
        step = _chunk(x.shape[1])
        for lo in range(0, src.shape[0], step):
            gd = g[dst[lo:lo + step]].float()
            if need_x:
                gx.index_add_(0, src[lo:lo + step], gd * w[lo:lo + step].float())
            if need_w:
                prod = gd * x[src[lo:lo + step]].float()
                gw[lo:lo + step] = prod.sum(1, keepdim=True) if w.shape[1] == 1 else prod
        return (
            gw.to(w.dtype) if need_w else None,
            gx.to(x.dtype) if need_x else None,
            None,
        )


def aggregate_edge_to_dst_weighted(
    graph: ScatterGraph, edge_weight: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """out[v] = sum over in-edges e of edge_weight[e] * x[src(e)];
    ``edge_weight`` is [E], [E, 1] or [E, f]."""
    squeeze = edge_weight.dim() == 1
    w = edge_weight[:, None] if squeeze else edge_weight
    return WeightedAggregate.apply(w, x, graph)


class EdgeExtreme(torch.autograd.Function):
    """Per-destination elementwise max (or min) over edge values; the
    gradient of each (vertex, column) goes to the first edge that attains
    it. A vertex with no in-edge gets 0 and passes no gradient."""

    @staticmethod
    def forward(ctx, ev, graph: ScatterGraph, is_min: bool):
        dst, v_num = graph.csc_dst, graph.v_num
        e_num = ev.shape[0]
        seg = (segment_min_sorted if is_min else segment_max_sorted)(ev, dst, v_num)
        eidx = torch.arange(e_num, dtype=torch.int64, device=ev.device)[:, None]
        hit = ev == seg[dst]
        record = segment_min_sorted(
            torch.where(hit, eidx, torch.full_like(eidx, e_num)).expand_as(ev).contiguous(),
            dst, v_num,
        ).clamp_(max=e_num)
        ctx.save_for_backward(record)
        ctx.e_num = e_num
        return torch.where(torch.isfinite(seg), seg, torch.zeros_like(seg))

    @staticmethod
    def backward(ctx, g):
        (record,) = ctx.saved_tensors
        e_num = ctx.e_num
        f = g.shape[1]
        valid = record < e_num
        flat = record.clamp(max=max(e_num - 1, 0)) * f + torch.arange(
            f, dtype=torch.int64, device=g.device
        )
        grad = torch.zeros(e_num * f, dtype=g.dtype, device=g.device)
        grad.index_add_(0, flat[valid], g[valid])
        return grad.view(e_num, f), None, None


def aggregate_edge_to_dst_max(graph: ScatterGraph, edge_vals: torch.Tensor) -> torch.Tensor:
    """[E, f] -> [V, f]: per-destination elementwise max."""
    return EdgeExtreme.apply(edge_vals, graph, False)


def aggregate_edge_to_dst_min(graph: ScatterGraph, edge_vals: torch.Tensor) -> torch.Tensor:
    """[E, f] -> [V, f]: per-destination elementwise min."""
    return EdgeExtreme.apply(edge_vals, graph, True)


class EdgeSoftmax(torch.autograd.Function):
    """Softmax over each destination's in-edge scores [E, h], stabilised by
    the segment max; backward s * (g - sum_seg(s * g))."""

    @staticmethod
    def forward(ctx, score, graph: ScatterGraph):
        dst, v_num = graph.csc_dst, graph.v_num
        m = segment_max_sorted(score, dst, v_num)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(score - m[dst])
        denom = segment_sum_sorted(e, dst, v_num)
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        s = e / denom[dst]
        ctx.graph = graph
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        graph = ctx.graph
        sg = s * g
        tot = segment_sum_sorted(sg, graph.csc_dst, graph.v_num)
        return s * (g - tot[graph.csc_dst]), None


def edge_softmax(graph: ScatterGraph, score: torch.Tensor) -> torch.Tensor:
    """[E, h] (or [E]) -> the same shape: per-destination softmax over
    incident-edge scores (h = attention heads or channels)."""
    squeeze = score.dim() == 1
    out = EdgeSoftmax.apply(score[:, None] if squeeze else score, graph)
    return out[:, 0] if squeeze else out
