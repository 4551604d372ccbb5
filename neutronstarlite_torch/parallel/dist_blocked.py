"""Per-shard blocked (source-tiled) ELL tables for the all_gather exchange —
port of ``neutronstarlite_tpu/parallel/dist_blocked.py``.

Each shard's tables are a rectangular ``BlockedEll``
(``ops/blocked_ell.py``): ``vp`` destination rows over the gathered
``P*vp`` source rows cut into tiles of ``vt`` (``KERNEL_TILE``), so a
gather indexes one ``[vt, f]`` tile of the slab. Plain PyTorch, as on one
device (JAX runs it as XLA code). JAX stacks the shards' levels into one
``[P, T, N_l, K]`` table per K (rows padded to the largest shard's); the
port keeps each shard's own levels, bitwise the live part of JAX's
``[p]`` slice.
"""

from __future__ import annotations

from typing import Iterable

import torch

from neutronstarlite_torch.ops.blocked_ell import BlockedEll
from neutronstarlite_torch.parallel.dist_ell import build_shard_tables
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import ShardTables, gather_simulated


def build_dist_blocked(dist: DistGraph, shards: Iterable[int], vt: int,
                       device="cpu") -> ShardTables:
    """Forward and transposed per-shard blocked tables of ``shards``."""
    P, vp = dist.partitions, dist.vp
    return build_shard_tables(dist, shards, lambda offs, nbr, w: BlockedEll.build(
        vp, offs, nbr, w, vt, device=device, src_num=P * vp))


def dist_blocked_gather_simulated(tables, x: torch.Tensor) -> torch.Tensor:
    """Collective-free twin: each shard's blocked tables (one direction,
    keyed by shard) over the full x, concatenated."""
    return gather_simulated(tables, x, BlockedEll.aggregate)
