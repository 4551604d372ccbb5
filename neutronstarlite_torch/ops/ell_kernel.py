"""The ELL-level CUDA kernel: work list, wrapper, launch counter and
autograd pairing — the counterpart of ``neutronstarlite_tpu/ops/pallas_kernels.py``.

``ell_level_aggregate(buckets, x)`` aggregates over every level of an
``EllBuckets`` (``ops/ell.py``). On a CUDA tensor it runs ``csrc/ell_level.cu``
over a work list of all levels at once (``ell_work``): one launch, and a
second, the reduction of the split rows' partials, when a row is longer
than the cap. Rows of zero degree (the K=0 level) have no item and stay
zero. ``launches`` counts every kernel launched, the reduction included.
On a CPU tensor it takes the plain version ``EllBuckets.plain``
(``ops/ell.ell_tables_aggregate``). There is no fallback from one to the
other. Rectangular tables (``EllBuckets.src_num``) read x of ``src_num``
rows and write ``v_num``; the kernel indexes x only through the tables, so
its launch is the square one. ``EllAggregate`` pairs the forward over the
CSC tables with the backward over the CSR tables.

Runtime weights (GAT's attention): ``ell_level_aggregate(buckets, x,
weights)`` reads per-level weights computed at run time instead of the
tables' own. The work list depends only on the rows' degrees and f, so it
is reused as it is; only the [levels, 3] pointer array is made afresh for
the call (``runtime_levels``), and the cached one stays the tables'.
``EllWeightedAggregate`` is the autograd pairing for that case: the
caller supplies the weights' layout over the backward tables and the
weights' gradient.

Not ported, because they exist only for Mosaic's compile count and VMEM:
``merge_low_k_levels``/``effective_min_k``, ``MAX_PALLAS_K`` (the JAX
executor sends K > 1024 levels to XLA) and the feature-column chunking.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from neutronstarlite_torch.obs import cost
from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops.ell import EllBuckets, ell_tables_aggregate

_MAX_CTAS = 2 ** 31 - 1  # CUDA's limit on gridDim.x


@dataclasses.dataclass(frozen=True)
class EllGeometry:
    """The launch geometry the built kernel exports."""

    max_cap: int  # the largest cap on one item's live slots
    min_cap: int  # the least cap
    target_warps: int  # the warp count (items x column chunks) a work list aims for
    warps_per_cta: int


@functools.lru_cache(maxsize=None)
def geometry() -> EllGeometry:
    g = (ctypes.c_int * 4)()
    _build.load("ell_level").nts_ell_level_geometry(g)
    return EllGeometry(*g)


def occupancy(dtype: torch.dtype, f: int) -> dict:
    """The kernel instance that runs x of ``dtype`` at width f: CTAs per SM
    from the CUDA occupancy API, registers per thread, shared bytes per CTA
    and local (spill) bytes per thread."""
    o = (ctypes.c_int * 4)()
    err = _build.load("ell_level").nts_ell_level_occupancy(int(dtype == torch.bfloat16), f, o)
    _build.check(err, f"ell_level occupancy f={f}")
    return {"ctas_per_sm": o[0], "regs": o[1], "smem_bytes": o[2], "local_bytes": o[3]}


@dataclasses.dataclass
class EllWork:
    """A launch's work list (numpy arrays, or tensors on the tables' device).

    ``items`` [n, 5] int32 rows (level, row, lo, hi, target): the live slots
    ``lo:hi`` of table row ``row`` of level ``level``; ``target`` >= 0 is the
    output vertex, < 0 the scratch row ``-1 - target`` of a split row's
    piece. ``split_ptr`` [n_split + 1] int32: split row j's pieces are the
    scratch rows ``split_ptr[j]:split_ptr[j+1]``, in slot order;
    ``split_out`` [n_split] int32 its vertex. On the device, ``levels``
    [n_levels, 3] int64 holds each level's (nbr base pointer, wgt base
    pointer, K): how the kernel finds the tables' own rows."""

    items: object
    split_ptr: object
    split_out: object
    cap: int  # the most live slots one item walks
    live_rows: int  # rows with a live slot (the others stay zero)
    n_pieces: int  # scratch rows: the pieces of the split rows
    levels: object = None

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_split(self) -> int:
        return len(self.split_out)


def ell_work(
    degs: Sequence[np.ndarray], rows_vertex: Sequence[np.ndarray], f: int, cols: int,
    target_warps: int, min_cap: int, max_cap: int,
) -> EllWork:
    """The work list over every level's rows, given each row's degree and
    vertex per level, f, and the kernel's geometry (``cols`` per warp).

    The cap is the live slots that spread the launch's work (live slots x
    column chunks) over ``target_warps`` warps, held within
    [``min_cap``, ``max_cap``]. A row of d > cap live slots splits into
    ceil(d / cap) near-equal slot ranges; a shorter row is one item; a row
    of no live slot has none. Items are ordered heaviest first, ties in
    (level, row, slot) order. A pure function of its arguments, so a given
    shape always sums in the same order."""
    lvl = np.concatenate([np.full(len(d), i, np.int64) for i, d in enumerate(degs)]
                         + [np.zeros(0, np.int64)])
    row = np.concatenate([np.arange(len(d), dtype=np.int64) for d in degs]
                         + [np.zeros(0, np.int64)])
    deg = np.concatenate([np.asarray(d, np.int64) for d in degs] + [np.zeros(0, np.int64)])
    vert = np.concatenate([np.asarray(v, np.int64) for v in rows_vertex]
                          + [np.zeros(0, np.int64)])
    live = deg > 0
    lvl, row, deg, vert = lvl[live], row[live], deg[live], vert[live]
    chunks = -(-f // cols)
    cap = max(min_cap, min(max_cap, -(-int(deg.sum()) * chunks // target_warps)))
    parts = -(-deg // cap)
    of = np.repeat(np.arange(len(deg)), parts)  # the row of each item
    piece = np.arange(len(of)) - np.repeat(np.cumsum(parts) - parts, parts)
    lo = deg[of] * piece // parts[of]
    hi = deg[of] * (piece + 1) // parts[of]
    split = parts[of] > 1
    # scratch rows: the split rows' pieces, in row then slot order
    target = np.where(split, -np.cumsum(split), vert[of])
    order = np.argsort(-(hi - lo), kind="stable")
    items = np.stack([lvl[of], row[of], lo, hi, target], axis=1)[order]
    split_rows = parts > 1
    split_ptr = np.concatenate([[0], np.cumsum(parts[split_rows])]).astype(np.int32)
    return EllWork(
        items=np.ascontiguousarray(items, dtype=np.int32), split_ptr=split_ptr,
        split_out=vert[split_rows].astype(np.int32),
        cap=int(cap), live_rows=int(len(deg)), n_pieces=int(split_ptr[-1]),
    )


def work_list(buckets: EllBuckets, f: int) -> EllWork:
    """The CUDA launch's work list at width f (``ell_work`` with the built
    kernel's geometry) and the tables' level pointers, on the tables'
    device; cached on the tables per column-chunk count."""
    cols, geo = _build.kernel_cols("ell_level"), geometry()
    chunks = -(-f // cols)
    work = buckets._work.get(chunks)
    if work is None:
        w = ell_work(
            [d.cpu().numpy() for d in buckets.deg],
            [r.cpu().numpy() for r in buckets.rows_vertex],
            f, cols, geo.target_warps, geo.min_cap, geo.max_cap,
        )
        dev = buckets.inv_perm.device
        work = EllWork(
            items=torch.from_numpy(w.items).to(dev),
            split_ptr=torch.from_numpy(w.split_ptr).to(dev),
            split_out=torch.from_numpy(w.split_out).to(dev),
            cap=w.cap, live_rows=w.live_rows, n_pieces=w.n_pieces,
            levels=torch.tensor(
                [[n.data_ptr(), g.data_ptr(), n.shape[1]] for n, g in zip(buckets.nbr, buckets.wgt)],
                dtype=torch.int64, device=dev,
            ),
        )
        buckets._work[chunks] = work
    return work


def _check_inputs(buckets: EllBuckets, x: torch.Tensor, weights) -> None:
    if x.dim() != 2 or x.shape[0] != buckets.n_src:
        raise ValueError(f"x must be [{buckets.n_src}, f], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ell_level takes float32 or bfloat16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("ell_level needs a contiguous x")
    for nbr, wgt, rows in zip(buckets.nbr, buckets.wgt, buckets.rows_vertex):
        for t, dt in ((nbr, torch.int32), (wgt, torch.float32), (rows, torch.int32)):
            if t.device != x.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError(
                    "ELL tables must be contiguous int32/float32/int32 on x's device"
                )
    if weights is None:
        return
    if len(weights) != len(buckets.nbr):
        raise ValueError(f"{len(weights)} weight levels for {len(buckets.nbr)} table levels")
    for nbr, w in zip(buckets.nbr, weights):
        if (w.shape != nbr.shape or w.dtype != torch.float32 or w.device != x.device
                or not w.is_contiguous()):
            raise ValueError(
                "runtime weights must be contiguous float32 on x's device, one "
                "level per table level and of its shape"
            )


def runtime_levels(buckets: EllBuckets, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n_levels, 3] int64 (nbr base pointer, weight base pointer, K) on the
    tables' device, the weights taken from ``weights`` instead of the
    tables: the cached ``EllWork.levels`` is left as it is. Copied from
    pinned memory without blocking the host; the caching allocators keep
    the source and the weights' memory until the stream has used them."""
    rows = [[n.data_ptr(), w.data_ptr(), n.shape[1]] for n, w in zip(buckets.nbr, weights)]
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(buckets.inv_perm.device, non_blocking=True)


def ell_level_aggregate(
    buckets: EllBuckets, x: torch.Tensor, weights: Optional[Sequence[torch.Tensor]] = None
) -> torch.Tensor:
    """[n_src, f] -> [V, f]: out[v] = sum over v's table row of w * x[nbr]
    (``n_src = V`` unless the tables are rectangular).

    ``weights``: per-level weights computed at run time (same shapes as
    ``buckets.wgt``, float32, contiguous, on x's device) in place of the
    tables' own; only the live slots ``[:deg]`` of a row are read."""
    if x.device.type == "cpu":
        if weights is None:
            return buckets.plain(x)
        return ell_tables_aggregate(x, buckets.nbr, list(weights))[buckets.inv_perm]
    if x.device.type != "cuda":
        raise ValueError(f"ell_level runs on cuda or cpu tensors, got {x.device}")
    _check_inputs(buckets, x, weights)
    lib = _build.load("ell_level")
    v_num, f = buckets.v_num, x.shape[1]
    if f == 0:
        return torch.empty((v_num, 0), dtype=x.dtype, device=x.device)
    work = work_list(buckets, f)
    out = (torch.zeros if work.live_rows < v_num else torch.empty)(
        (v_num, f), dtype=x.dtype, device=x.device
    )
    if not work.n_items:
        return out
    levels = work.levels if weights is None else runtime_levels(buckets, weights)
    ctas = -(-work.n_items * -(-f // _build.kernel_cols("ell_level"))
             // geometry().warps_per_cta)
    if ctas > _MAX_CTAS:
        raise ValueError(f"ell_level would launch {ctas} CTAs, over the grid's {_MAX_CTAS}")
    scratch = (torch.empty(work.n_pieces * f, dtype=torch.float32, device=x.device)
               if work.n_split else None)
    err = lib.nts_ell_level(
        levels.data_ptr(), work.items.data_ptr(), work.n_items,
        work.split_ptr.data_ptr(), work.split_out.data_ptr(), work.n_split,
        x.data_ptr(), out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        f, int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"ell_level {work.n_items} items f={f}")
    # the work items, then the split rows' reduction
    ell_level_aggregate.launches += 2 if work.n_split else 1
    return out


ell_level_aggregate.launches = 0


class EllAggregate(torch.autograd.Function):
    """Aggregation over ``fwd`` tables; its gradient is the same kernel over
    ``bwd`` (the transposed adjacency). The tables are not differentiable."""

    @staticmethod
    def forward(ctx, x, fwd: EllBuckets, bwd: EllBuckets):
        ctx.bwd = bwd
        cost.note_kernel("ell_level", "fwd", x)
        return ell_level_aggregate(fwd, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        cost.note_kernel("ell_level", "bwd", g)
        return ell_level_aggregate(ctx.bwd, g.contiguous()), None, None


class EllWeightedAggregate(torch.autograd.Function):
    """Aggregation over ``fwd`` tables with runtime weights, differentiable
    in x and in the weights. The caller supplies the backward's two halves:
    ``transpose(weights)`` gives the same weights laid out over the ``bwd``
    tables (x's gradient is the kernel over them), and
    ``weight_grad(g, x)`` gives the weights' gradient, one tensor per level.

    ``EllWeightedAggregate.apply(x, fwd, bwd, transpose, weight_grad, *weights)``"""

    @staticmethod
    def forward(ctx, x, fwd: EllBuckets, bwd: EllBuckets, transpose: Callable,
                weight_grad: Callable, *weights):
        x = x.contiguous()
        ctx.bwd, ctx.transpose, ctx.weight_grad = bwd, transpose, weight_grad
        ctx.save_for_backward(x, *weights)
        cost.note_kernel("ell_level", "fwd", x)
        return ell_level_aggregate(fwd, x, weights)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            cost.note_kernel("ell_level", "bwd", g)
        gx = (ell_level_aggregate(ctx.bwd, g, ctx.transpose(weights))
              if ctx.needs_input_grad[0] else None)
        gw = (ctx.weight_grad(g, x) if any(ctx.needs_input_grad[5:])
              else [None] * len(weights))
        return (gx, None, None, None, None, *gw)
