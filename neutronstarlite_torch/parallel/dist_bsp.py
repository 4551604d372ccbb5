"""Per-shard rectangular bsp tables for the all_gather exchange — port of
``neutronstarlite_tpu/parallel/dist_bsp.py``.

Each shard's tables are a rectangular ``BspEll`` (``ops/bsp_ell.py``):
``vp`` destination rows in tiles of ``dt``, over the gathered ``P*vp``
source rows in tiles of ``vt`` (``t_src = ceil(P*vp / vt)``), built from
the shard's adjacency over global padded ids
(``dist_ell.per_device_adjacency``) and aggregated by the ``bsp_ell``
CUDA kernel or, on the CPU, its plain version. The tables are built in
numpy and moved to the device once per array.

Only the unsegmented form is ported: JAX's segmented stacked layout
exists so that Mosaic's scalar-prefetch key fits SMEM. JAX also pads the
shards' block counts to one stacked shape (a multiple of 8 across shards,
filled with the shard's last key); the port keeps one table set per
shard, bitwise the live ``[:B_p]`` part of JAX's ``[p]`` slice.
"""

from __future__ import annotations

from typing import Iterable

import torch

from neutronstarlite_torch.ops.bsp_ell import DEFAULT_DT, DEFAULT_VT, BspEll, bsp_aggregate
from neutronstarlite_torch.parallel.dist_ell import build_shard_tables
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import ShardTables, gather_simulated


def build_dist_bsp(dist: DistGraph, shards: Iterable[int], vt: int = DEFAULT_VT,
                   device="cpu", dt: int = DEFAULT_DT) -> ShardTables:
    """Forward and transposed per-shard bsp tables of ``shards``."""
    P, vp = dist.partitions, dist.vp
    return build_shard_tables(dist, shards, lambda offs, nbr, w: BspEll.build(
        vp, offs, nbr, w, dt=dt, vt=vt, device=device, src_num=P * vp))


def dist_bsp_gather_simulated(tables, x: torch.Tensor) -> torch.Tensor:
    """Collective-free twin: each shard's bsp tables (one direction, keyed
    by shard) over the full x, concatenated."""
    return gather_simulated(tables, x, bsp_aggregate)
