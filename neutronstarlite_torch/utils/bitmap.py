"""Vertex subsets and the vertex-map engine — port of
``neutronstarlite_tpu/utils/bitmap.py``.

Reference counterparts:

- ``Bitmap`` / ``VertexSubset`` (dep/gemini/bitmap.hpp:10-68): word-packed
  bitsets with an atomic ``set_bit``, used as active-vertex frontiers. Here
  the carrier is a boolean tensor: the mask applies as one vectorised
  ``where`` and a reduction, and a mutator returns a new subset, so there
  is no concurrent update to guard.
- ``Graph::process_vertices`` (core/graph.hpp:1977-2053): the per-vertex
  map over the active set, a local reduction, then an ``MPI_Allreduce`` of
  the result. Here: one masked apply and reduction; on the distributed
  twin (every shard in one process) the Allreduce is
  ``reduce_over_shards``, a plain reduction over the shards' results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

REDUCERS = ("sum", "max", "min")


@dataclasses.dataclass(frozen=True)
class VertexSubset:
    """A set of vertices as a boolean mask (typedef Bitmap VertexSubset,
    dep/gemini/bitmap.hpp:68)."""

    mask: torch.Tensor  # [V] bool

    # -- constructors (Bitmap::clear / fill) --------------------------------
    @staticmethod
    def empty(v_num: int, device="cpu") -> "VertexSubset":
        return VertexSubset(torch.zeros(v_num, dtype=torch.bool, device=device))

    @staticmethod
    def full(v_num: int, device="cpu") -> "VertexSubset":
        return VertexSubset(torch.ones(v_num, dtype=torch.bool, device=device))

    @staticmethod
    def of(v_num: int, ids, device="cpu") -> "VertexSubset":
        """Subset from a vertex-id list."""
        mask = torch.zeros(v_num, dtype=torch.bool, device=device)
        mask[torch.as_tensor(ids, dtype=torch.int64, device=device)] = True
        return VertexSubset(mask)

    # -- queries --------------------------------------------------------------
    @property
    def v_num(self) -> int:
        return self.mask.shape[0]

    def get_bit(self, v) -> torch.Tensor:
        return self.mask[v]

    def count(self) -> torch.Tensor:
        """Popcount (the reduction loop in bitmap.hpp)."""
        return self.mask.sum()

    # -- functional mutators (set_bit's role; no atomics needed) ------------
    def _with(self, v, value: bool) -> "VertexSubset":
        mask = self.mask.clone()
        mask[v] = value
        return VertexSubset(mask)

    def set_bit(self, v) -> "VertexSubset":
        return self._with(v, True)

    def clear_bit(self, v) -> "VertexSubset":
        return self._with(v, False)

    def union(self, other: "VertexSubset") -> "VertexSubset":
        return VertexSubset(self.mask | other.mask)

    def intersect(self, other: "VertexSubset") -> "VertexSubset":
        return VertexSubset(self.mask & other.mask)

    def invert(self) -> "VertexSubset":
        return VertexSubset(~self.mask)


def _identity(reducer: str, dtype: torch.dtype):
    """The value an inactive vertex contributes under ``reducer``."""
    if reducer == "sum":
        return 0
    if dtype == torch.bool:
        lo, hi = False, True
    elif dtype.is_floating_point:
        lo, hi = torch.finfo(dtype).min, torch.finfo(dtype).max
    else:
        lo, hi = torch.iinfo(dtype).min, torch.iinfo(dtype).max
    return lo if reducer == "max" else hi


def _reduce(vals: torch.Tensor, reducer: str) -> torch.Tensor:
    if vals.dtype == torch.bool and reducer != "sum":
        return vals.any() if reducer == "max" else vals.all()
    return {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[reducer](vals)


def process_vertices(
    fn: Callable[[torch.Tensor], torch.Tensor],
    active: VertexSubset,
    reducer: str = "sum",
) -> torch.Tensor:
    """Map ``fn`` over the active vertex ids and reduce (process_vertices,
    core/graph.hpp:1977: per-vertex lambda over the active bitmap, a local
    reduction, then MPI_Allreduce at :2045).

    ``fn`` takes the [V] vertex-id tensor and returns per-vertex values (the
    reference's scalar lambda, batched). Inactive vertices contribute the
    reducer's identity."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; known: {REDUCERS}")
    ids = torch.arange(active.v_num, device=active.mask.device)
    vals = fn(ids)
    ident = torch.full((), _identity(reducer, vals.dtype), dtype=vals.dtype,
                       device=vals.device)
    return _reduce(torch.where(active.mask, vals, ident), reducer)


def reduce_over_shards(values: Sequence[torch.Tensor], reducer: str = "sum") -> torch.Tensor:
    """The distributed twin's Allreduce: each shard's ``process_vertices``
    result, combined by the same reducer (the reference's ``psum`` /
    ``pmax`` / ``pmin`` over the mesh becomes a plain reduction)."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; known: {REDUCERS}")
    return _reduce(torch.stack([torch.as_tensor(v) for v in values]), reducer)
