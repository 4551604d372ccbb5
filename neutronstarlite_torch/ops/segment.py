"""Segment reductions over sorted ids — port of ``neutronstarlite_tpu/ops/segment.py``.

``segment_*_sorted(data, ids, n)`` reduce the rows of ``data`` [E, ...] into
``n`` segments by ``ids`` [E] (CSC or CSR order keeps them sorted). An empty
segment holds the reduction's identity, as in ``jax.ops.segment_*``: 0 for
the sum, -inf / +inf for max / min of floats, the dtype's lowest / highest
value for integers. The sum is ``index_add_``; max and min are
``scatter_reduce_(..., include_self=False)`` over that identity.
``zero_cotangent`` is a JAX artefact (float0 cotangents) and is not ported.
"""

from __future__ import annotations

import torch


def _identity(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def segment_sum_sorted(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def _segment_extreme(data: torch.Tensor, ids: torch.Tensor, n: int, is_min: bool):
    out = torch.full((n,) + tuple(data.shape[1:]), _identity(data.dtype, is_min),
                     dtype=data.dtype, device=data.device)
    index = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, "amin" if is_min else "amax",
                               include_self=False)


def segment_max_sorted(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return _segment_extreme(data, ids, n, is_min=False)


def segment_min_sorted(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return _segment_extreme(data, ids, n, is_min=True)
