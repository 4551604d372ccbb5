"""The ELL-level CUDA kernel: wrapper, launch counter and autograd pairing —
the counterpart of ``neutronstarlite_tpu/ops/pallas_kernels.py``.

``ell_level_aggregate(buckets, x)`` aggregates over every level of an
``EllBuckets`` (``ops/ell.py``): on a CUDA tensor it launches
``csrc/ell_level.cu`` once per level, every level included (a hub level
runs split-K: the split sums, then a reduction kernel, two launches;
zero-degree levels launch nothing and stay zero). ``launches`` counts
every kernel launched, the reductions included. On a CPU tensor it takes the plain version
``EllBuckets.plain`` (``ops/ell.ell_tables_aggregate``). There is no
fallback from one to the other. ``EllAggregate`` pairs the forward over the
CSC tables with the backward over the CSR tables.

Not ported, because they exist only for Mosaic's compile count and VMEM:
``merge_low_k_levels``/``effective_min_k``, ``MAX_PALLAS_K`` (the JAX
executor sends K > 1024 levels to XLA) and the feature-column chunking.
"""

from __future__ import annotations

import math

import torch

from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops.ell import EllBuckets

_SPLIT_MIN_K = 2048  # levels wider than this may split K across CTAs
_SPLIT_SLOTS = 1024  # least slots per split
_SPLIT_TARGET_WARPS = 4096  # parallelism a split hub level aims for


def split_count(n_rows: int, k: int, f: int, warp_cols: int) -> int:
    """Number of K splits for one level (1 = no split), given the columns
    one warp of the kernel covers. Fixed by the shape, so a level's
    summation order is the same on every run."""
    if k <= _SPLIT_MIN_K:
        return 1
    warps = n_rows * math.ceil(f / warp_cols)
    want = math.ceil(_SPLIT_TARGET_WARPS / max(warps, 1))
    return max(1, min(math.ceil(k / _SPLIT_SLOTS), want, 65535))


def _check_inputs(buckets: EllBuckets, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != buckets.v_num:
        raise ValueError(f"x must be [{buckets.v_num}, f], got {tuple(x.shape)}")
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


def ell_level_aggregate(buckets: EllBuckets, x: torch.Tensor) -> torch.Tensor:
    """[V, f] -> [V, f]: out[v] = sum over v's table row of w * x[nbr]."""
    if x.device.type == "cpu":
        return buckets.plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_level runs on cuda or cpu tensors, got {x.device}")
    _check_inputs(buckets, x)
    lib = _build.load("ell_level")
    warp_cols = _build.kernel_cols("ell_level")
    v_num, f = x.shape
    has_empty = any(n.shape[1] == 0 for n in buckets.nbr)
    out = (torch.zeros if has_empty else torch.empty)(
        (v_num, f), dtype=x.dtype, device=x.device
    )
    if f == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for nbr, wgt, rows in zip(buckets.nbr, buckets.wgt, buckets.rows_vertex):
        n_rows, k = nbr.shape
        if n_rows == 0 or k == 0:
            continue  # zero-degree level: zero rows, no launch
        splits = split_count(n_rows, k, f, warp_cols)
        scratch = (
            torch.empty(splits * n_rows * f, dtype=torch.float32, device=x.device)
            if splits > 1 else None
        )
        err = lib.nts_ell_level(
            nbr.data_ptr(), wgt.data_ptr(), x.data_ptr(), rows.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            n_rows, k, f, splits, int(x.dtype == torch.bfloat16), stream,
        )
        _build.check(err, f"ell_level [{n_rows}, {k}] f={f}")
        # a split level runs two kernels: the split sums, then their reduction
        ell_level_aggregate.launches += 2 if splits > 1 else 1
    return out


ell_level_aggregate.launches = 0


class EllAggregate(torch.autograd.Function):
    """Aggregation over ``fwd`` tables; its gradient is the same kernel over
    ``bwd`` (the transposed adjacency). The tables are not differentiable."""

    @staticmethod
    def forward(ctx, x, fwd: EllBuckets, bwd: EllBuckets):
        ctx.bwd = bwd
        return ell_level_aggregate(fwd, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ell_level_aggregate(ctx.bwd, g.contiguous()), None, None
