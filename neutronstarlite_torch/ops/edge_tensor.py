"""Per-destination neighbourhood views of edge and vertex tensors — port of
``neutronstarlite_tpu/ops/edge_tensor.py``.

Reference counterpart: ``ntsEdgeTensor`` / ``ntsVertexTensor``
(core/NtsEdgeTensor.hpp:23-183): ``getNbrTensor(v)`` returns the slice of
an edge tensor holding v's incident edges, for a per-vertex NN over a
vertex's incident-edge block.

As in the reference port, the ragged per-vertex slices become one padded
dense neighbourhood table ``[V, K, f]``, made by one gather: K is the
largest in-degree (or ``cap``), and ``mask`` zeroes the padding, so a
per-vertex NN over incident edges is one batched op over axis 1. The slot
table and its mask are built in NumPy (the reference's fill) and held as
tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from neutronstarlite_torch.graph.storage import CSCGraph


@dataclasses.dataclass(frozen=True)
class NbrTable:
    """[V, K] edge-slot table into the CSC-ordered edge arrays, and its mask."""

    edge_slot: torch.Tensor  # [V, K] int64 indices into [E]-shaped edge tensors
    mask: torch.Tensor  # [V, K] float32, 1 on real incident edges
    cap: int

    @staticmethod
    def build(g: CSCGraph, cap: Optional[int] = None, device="cpu") -> "NbrTable":
        """K = the largest in-degree unless ``cap`` truncates heavy vertices
        (a fan-out-style bound: the static shape's price)."""
        deg = g.in_degree.astype(np.int64)
        k_max = int(deg.max()) if cap is None else min(int(deg.max()), cap)
        k_max = max(k_max, 1)
        off = g.column_offset.astype(np.int64)
        v = g.v_num
        slot = np.zeros((v, k_max), dtype=np.int64)
        mask = np.zeros((v, k_max), dtype=np.float32)
        k = np.arange(k_max)
        valid = k[None, :] < np.minimum(deg, k_max)[:, None]  # [V, K]
        slot[valid] = (off[:v, None] + k[None, :])[valid]
        mask[valid] = 1.0
        return NbrTable(edge_slot=torch.from_numpy(slot).to(device),
                        mask=torch.from_numpy(mask).to(device), cap=k_max)

    def edge_view(self, edge_tensor: torch.Tensor) -> torch.Tensor:
        """[E, f] edge tensor -> [V, K, f] per-destination incident-edge
        blocks (getNbrTensor for every vertex at once)."""
        vals = edge_tensor[self.edge_slot]
        return vals * self.mask[..., None].to(vals.dtype)

    def vertex_view(self, graph, x: torch.Tensor) -> torch.Tensor:
        """[V, f] vertex tensor -> [V, K, f] neighbour-feature blocks:
        block[v, k] = x[source of v's k-th in-edge]; ``graph`` carries the
        CSC source ids (``ops/aggregate.ScatterGraph``)."""
        vals = x[graph.csc_src[self.edge_slot]]
        return vals * self.mask[..., None].to(vals.dtype)

    def reduce_sum(self, blocks: torch.Tensor) -> torch.Tensor:
        """[V, K, f] -> [V, f], the sum over the neighbourhood axis. Blocks
        from edge_view / vertex_view are already masked; blocks whose padding
        became nonzero (a bias add) need ``blocks * mask[..., None]`` first."""
        return blocks.sum(dim=1)
