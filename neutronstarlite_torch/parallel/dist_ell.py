"""Per-shard ELL tables for the all_gather exchange — port of
``neutronstarlite_tpu/parallel/dist_ell.py``.

``per_device_adjacency`` gathers, per shard, its rows' in-edges (or, for
the transposed tables, its sources' out-edges) from the ``[P, P, Eb]``
blocks, with neighbours as global padded ids over the ``[P*vp]`` space.
Each shard's tables are a rectangular ``EllBuckets`` (``vp`` rows,
``src_num = P*vp``), aggregated by the ``ell_level`` CUDA kernel
(``ops/ell_kernel.py``) or, on the CPU, its plain version.

JAX pads the shards' tables to one stacked shape for ``shard_map`` (the
levels shared, each level's rows the largest shard's, low levels merged
for Mosaic). The port keeps one table set per shard, with the port's own
level ladder (a K=0 level for rows without an edge); each row holds the
same live slots, in the same order, as its row in JAX's ``[p]`` slice.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from neutronstarlite_torch.ops.ell import EllBuckets
from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import ShardTables, gather_simulated


def per_device_adjacency(dist: DistGraph, transpose: bool,
                         shards: Optional[Iterable[int]] = None):
    """Per shard (all, or those of ``shards``) a CSC-style adjacency over
    global padded neighbour ids: ``[(offsets [vp+1], nbr [e_d], w [e_d],
    deg [vp])]``, and the largest per-vertex degree among them."""
    P, vp = dist.partitions, dist.vp
    per_dev = []
    max_deg = 0
    slot = np.arange(dist.eb)
    for d in (range(P) if shards is None else shards):
        own_l, nbr_g, ws = [], [], []
        for o in range(P):
            # realness comes from the block's edge count, not weight != 0
            if transpose:  # d owns the source side: block (o, d)
                w = dist.block_weight[o, d]
                real = slot < dist.block_count[o, d]
                own_l.append(dist.block_src[o, d][real].astype(np.int64))
                nbr_g.append(dist.block_dst[o, d][real].astype(np.int64) + o * vp)
            else:  # d owns the destination side: block (d, o)
                w = dist.block_weight[d, o]
                real = slot < dist.block_count[d, o]
                own_l.append(dist.block_dst[d, o][real].astype(np.int64))
                nbr_g.append(dist.block_src[d, o][real].astype(np.int64) + o * vp)
            ws.append(w[real])
        own = np.concatenate(own_l)
        nbr = np.concatenate(nbr_g)
        w = np.concatenate(ws)
        order = np.argsort(own, kind="stable")
        own, nbr, w = own[order], nbr[order], w[order]
        deg = np.bincount(own, minlength=vp)
        offsets = np.concatenate([[0], np.cumsum(deg)])
        per_dev.append((offsets, nbr, w, deg))
        if len(deg):
            max_deg = max(max_deg, int(deg.max()))
    return per_dev, max_deg


def build_shard_tables(dist: DistGraph, shards: Iterable[int], make) -> ShardTables:
    """``ShardTables`` with ``make(offsets, nbr, w)`` per shard and direction
    (numpy in, the shard's tables out)."""
    shards = list(shards)
    out, edges = {}, {}
    for direction, transpose in (("fwd", False), ("bwd", True)):
        per_dev, _ = per_device_adjacency(dist, transpose, shards)
        out[direction] = {p: make(offs, nbr, w) for p, (offs, nbr, w, _deg)
                          in zip(shards, per_dev)}
        edges[direction] = {p: len(nbr) for p, (_offs, nbr, _w, _deg) in zip(shards, per_dev)}
    return ShardTables(fwd=out["fwd"], bwd=out["bwd"], partitions=dist.partitions,
                       vp=dist.vp, edges=edges)


def build_dist_ell(dist: DistGraph, shards: Iterable[int], device="cpu") -> ShardTables:
    """Forward and transposed per-shard ELL tables of ``shards``."""
    P, vp = dist.partitions, dist.vp
    return build_shard_tables(dist, shards, lambda offs, nbr, w: EllBuckets.build(
        vp, offs, nbr, w, device=device, src_num=P * vp))


def dist_ell_gather_simulated(tables, x: torch.Tensor) -> torch.Tensor:
    """Collective-free twin: each shard's ELL tables (one direction, keyed
    by shard) over the full x, concatenated."""
    return gather_simulated(tables, x, ell_level_aggregate)
