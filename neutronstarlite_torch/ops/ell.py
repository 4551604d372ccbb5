"""ELL degree-bucket tables and their plain aggregation — port of
``neutronstarlite_tpu/ops/ell.py``.

Vertices are grouped into power-of-two in-degree buckets (K = 4, 8, 16, ...,
next_pow2(max degree)), plus a K=0 bucket for zero-degree vertices; each
bucket stores a padded dense table ``nbr [Nk, K]`` / ``wgt [Nk, K]``
(padding: index 0, weight 0). One level computes
``o[r] = sum_k wgt[r, k] * x[nbr[r, k]]``; the concatenation over levels is
put back in vertex order by ``inv_perm``. ``EllPair`` holds the forward
(in-edge, CSC) and backward (out-edge, CSR) tables: the backward of the
aggregation is the same operation over the transposed adjacency.

The tables are filled by the JAX module's NumPy branch, so they are bitwise
the JAX tables. ``ell_tables_aggregate`` is the plain PyTorch version of
the ELL-level kernel (``ops/ell_kernel.py``, ``csrc/ell_level.cu``): f32
products and accumulation whatever the input dtype, one cast to
``x.dtype``, zero rows for a K=0 level; it works through each level in
pieces of rows (and of slots, for a hub row) so that its gathered
intermediate stays bounded at any graph size. The JAX module's byte-budget
chunking (``NTS_ELL_CHUNK_MIB``) bounds TPU VMEM intermediates and is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from neutronstarlite_torch.graph.storage import CSCGraph

_MIN_K = 4
_PLAIN_CHUNK_ELEMS = 1 << 26  # bound on one [rows, slots, f] intermediate


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _level_sum(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """f32 [Nk, f] = sum_k wgt[r, k] * x[nbr[r, k]], in pieces of rows (and,
    for a row wider than the budget, of slots) whose [rows, slots, f]
    intermediate stays within ``_PLAIN_CHUNK_ELEMS``."""
    n_rows, k = nbr.shape
    f = x.shape[1]
    acc = torch.zeros((n_rows, f), dtype=torch.float32, device=x.device)
    row_step = max(1, _PLAIN_CHUNK_ELEMS // max(k * f, 1))
    k_step = min(k, max(1, _PLAIN_CHUNK_ELEMS // max(f, 1)))
    for r0 in range(0, n_rows, row_step):
        for k0 in range(0, k, k_step):
            nb = nbr[r0:r0 + row_step, k0:k0 + k_step]
            w = wgt[r0:r0 + row_step, k0:k0 + k_step]
            acc[r0:r0 + row_step] += (x[nb].float() * w[:, :, None]).sum(dim=1)
    return acc


def ell_tables_aggregate(
    x: torch.Tensor, nbrs: List[torch.Tensor], wgts: List[torch.Tensor]
) -> torch.Tensor:
    """Concatenation over levels of ``sum_k wgt[r, k] * x[nbr[r, k]]``,
    [sum Nk, f] in x.dtype (callers apply ``inv_perm``)."""
    f = x.shape[1]
    outs = []
    for nbr, wgt in zip(nbrs, wgts):
        n_rows, k = nbr.shape
        if k == 0:
            outs.append(torch.zeros((n_rows, f), dtype=x.dtype, device=x.device))
            continue
        outs.append(_level_sum(x, nbr, wgt).to(x.dtype))
    if not outs:
        return torch.zeros((0, f), dtype=x.dtype, device=x.device)
    return torch.cat(outs, dim=0)


@dataclasses.dataclass
class EllBuckets:
    """One direction's degree-bucketed tables (torch tensors).

    ``nbr[i]`` [Nk, K_i] int32 neighbour ids, ``wgt[i]`` [Nk, K_i] float32
    weights, ``rows_vertex[i]`` [Nk] int32 the vertex of each table row,
    ``inv_perm`` [V] int64 vertex -> row of the bucket-ordered concatenation.
    """

    nbr: List[torch.Tensor]
    wgt: List[torch.Tensor]
    rows_vertex: List[torch.Tensor]
    inv_perm: torch.Tensor
    v_num: int

    @staticmethod
    def build(
        v_num: int,
        offsets: np.ndarray,  # [V+1] per-vertex adjacency offsets
        adj: np.ndarray,  # [E] neighbour ids, grouped by vertex
        weights: np.ndarray,  # [E]
        device="cpu",
    ) -> "EllBuckets":
        deg = np.diff(offsets).astype(np.int64)
        order = np.argsort(deg, kind="stable")
        sdeg = deg[order]
        nbrs, wgts, perm_parts = [], [], []
        i = 0
        j0 = int(np.searchsorted(sdeg, 0, side="right"))
        if j0 > 0:  # zero-degree rows: a K=0 level, no slots
            nbrs.append(np.zeros((j0, 0), dtype=np.int32))
            wgts.append(np.zeros((j0, 0), dtype=np.float32))
            perm_parts.append(order[:j0])
            i = j0
        while i < v_num:
            K = max(_next_pow2(max(int(sdeg[i]), 1)), _MIN_K)
            j = max(int(np.searchsorted(sdeg, K, side="right")), i + 1)
            ids = order[i:j]
            nbr = np.zeros((len(ids), K), dtype=np.int32)
            wgt = np.zeros((len(ids), K), dtype=np.float32)
            lo, d = offsets[ids], deg[ids]
            k = np.arange(K)
            valid = k[None, :] < d[:, None]
            flat_idx = (lo[:, None] + k[None, :])[valid]
            nbr[valid] = adj[flat_idx]
            wgt[valid] = weights[flat_idx]
            nbrs.append(nbr)
            wgts.append(wgt)
            perm_parts.append(ids)
            i = j
        perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, np.int64)
        inv = np.empty(v_num, dtype=np.int64)
        inv[perm] = np.arange(v_num)
        return EllBuckets(
            nbr=[torch.from_numpy(n).to(device) for n in nbrs],
            wgt=[torch.from_numpy(w).to(device) for w in wgts],
            rows_vertex=[
                torch.from_numpy(p.astype(np.int32)).to(device) for p in perm_parts
            ],
            inv_perm=torch.from_numpy(inv).to(device),
            v_num=int(v_num),
        )

    def slot_count(self) -> int:
        return sum(int(n.numel()) for n in self.nbr)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """out[v] = sum over v's table row of w * x[nbr]; [V, f] -> [V, f]."""
        return ell_tables_aggregate(x, self.nbr, self.wgt)[self.inv_perm]


@dataclasses.dataclass
class EllPair:
    """Forward (in-edge/CSC) + backward (out-edge/CSR) bucket tables."""

    fwd: EllBuckets
    bwd: EllBuckets

    @staticmethod
    def from_host(g: CSCGraph, device="cpu") -> "EllPair":
        return EllPair(
            fwd=EllBuckets.build(
                g.v_num, g.column_offset, g.row_indices, g.edge_weight_forward, device
            ),
            bwd=EllBuckets.build(
                g.v_num, g.row_offset, g.column_indices, g.edge_weight_backward, device
            ),
        )
