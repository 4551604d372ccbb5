"""Neighbour aggregation dispatch and the plain scatter route — port of
``neutronstarlite_tpu/ops/aggregate.py``.

``gather_dst_from_src(graph, x)``: ``out[v] = sum over in-edges (u -> v) of
w_uv * x[u]``; ``gather_src_from_dst`` is the CSR direction. ``graph`` is one
of three forms:

- ``ScatterGraph`` — the default route: the edge lists in CSC and CSR order
  and a chunked gather -> scale -> ``index_add_`` in plain PyTorch (the JAX
  package's XLA segment-sum). ``ScatterAggregate`` pairs the forward over
  the CSC with the backward over the CSR. Products are taken in x's dtype,
  as in JAX; the accumulator is f32 (JAX accumulates in x's dtype) and is
  cast once at the end.
- ``ops.ell.EllPair`` — the ELL-level kernel (``ops/ell_kernel.py``).
- ``ops.bsp_ell.BspEllPair`` — the block-sparse kernel (``ops/bsp_ell.py``).

The JAX module's lane-pad fence (narrow widths padded to 128 lanes before
an XLA scatter) is a TPU/XLA artefact and is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.ops.bsp_ell import BspAggregate, BspEllPair
from neutronstarlite_torch.ops.ell import EllPair
from neutronstarlite_torch.ops.ell_kernel import EllAggregate

# bound on one chunk's [edges, f] float32 intermediate
_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class ScatterGraph:
    """Edge lists of both directions on the device (int64 ids)."""

    csc_src: torch.Tensor
    csc_dst: torch.Tensor
    csc_weight: torch.Tensor
    csr_src: torch.Tensor
    csr_dst: torch.Tensor
    csr_weight: torch.Tensor
    v_num: int

    @staticmethod
    def from_host(g: CSCGraph, device="cpu") -> "ScatterGraph":
        def ids(a):
            return torch.from_numpy(a).to(device=device, dtype=torch.int64)

        return ScatterGraph(
            csc_src=ids(g.row_indices),
            csc_dst=ids(g.dst_of_edge),
            csc_weight=torch.from_numpy(g.edge_weight_forward).to(device),
            csr_src=ids(g.src_of_edge),
            csr_dst=ids(g.column_indices),
            csr_weight=torch.from_numpy(g.edge_weight_backward).to(device),
            v_num=int(g.v_num),
        )


def scatter_accumulate(
    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, x: torch.Tensor, v_num: int
) -> torch.Tensor:
    """sum over edges of w_e * x[src_e] into row dst_e; [V, f] -> [v_num, f]."""
    f = x.shape[1]
    out = torch.zeros((v_num, f), dtype=torch.float32, device=x.device)
    chunk = max(1, _CHUNK_BYTES // max(4 * f, 1))
    for lo in range(0, src.shape[0], chunk):
        vals = x[src[lo:lo + chunk]] * w[lo:lo + chunk, None].to(x.dtype)
        out.index_add_(0, dst[lo:lo + chunk], vals.float())
    return out.to(x.dtype)


class ScatterAggregate(torch.autograd.Function):
    """CSC aggregation forward, CSR aggregation backward (``reverse``
    swaps the two: the CSR direction as a forward op)."""

    @staticmethod
    def forward(ctx, x, g: ScatterGraph, reverse: bool):
        ctx.g, ctx.reverse = g, reverse
        if reverse:
            return scatter_accumulate(g.csr_dst, g.csr_src, g.csr_weight, x, g.v_num)
        return scatter_accumulate(g.csc_src, g.csc_dst, g.csc_weight, x, g.v_num)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.g
        if ctx.reverse:
            gx = scatter_accumulate(g.csc_src, g.csc_dst, g.csc_weight, grad, g.v_num)
        else:
            gx = scatter_accumulate(g.csr_dst, g.csr_src, g.csr_weight, grad, g.v_num)
        return gx, None, None


def gather_dst_from_src(graph, x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over in-edges (u -> v) of w_uv * x[u]; [V, f] -> [V, f]."""
    if isinstance(graph, BspEllPair):
        return BspAggregate.apply(x, graph.fwd, graph.bwd)
    if isinstance(graph, EllPair):
        return EllAggregate.apply(x, graph.fwd, graph.bwd)
    if isinstance(graph, ScatterGraph):
        return ScatterAggregate.apply(x, graph, False)
    raise TypeError(f"unknown aggregation graph {type(graph).__name__}")


def gather_src_from_dst(graph, y: torch.Tensor) -> torch.Tensor:
    """out[u] = sum over out-edges (u -> v) of w_uv * y[v] (CSR direction)."""
    if isinstance(graph, BspEllPair):
        return BspAggregate.apply(y, graph.bwd, graph.fwd)
    if isinstance(graph, EllPair):
        return EllAggregate.apply(y, graph.bwd, graph.fwd)
    if isinstance(graph, ScatterGraph):
        return ScatterAggregate.apply(y, graph, True)
    raise TypeError(f"unknown aggregation graph {type(graph).__name__}")
