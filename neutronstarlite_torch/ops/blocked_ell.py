"""Blocked (source-tiled) ELL tables and their aggregation — port of
``neutronstarlite_tpu/ops/blocked_ell.py``.

Vertices are cut into T contiguous source tiles of ``vt`` rows. Each tile
owns the edges whose source lies in it, with tile-LOCAL source ids, so a
gather indexes only that tile's ``[vt, f]`` slice of x. The levels are
global: one stacked table per distinct row capacity K, each ``[T, N_l, K]``
padded to the largest per-tile row count, so every tile runs the same
loop. A row is one (tile, destination) run of edges; rows are sorted by
destination within a (tile, level) and a destination's in-tile run lives in
exactly one level, so within one (tile, level) every row is a different
destination.

``levels`` picks the capacities: ``pow2`` (K = next power of two of the
run, at least 4; the default) or ``binned`` (the runs' quantiles rounded up
to multiples of 4, never more slots than pow2: ``_binned_row_k``). The JAX
module's ``NTS_ELL_LEVELS`` fallback is not ported: the cfg key
``ELL_LEVELS`` sets the fused tables' ladder.

The tables are built on the host, by the native runtime's counting sort
by tile and level fill when it is available (``native/``), else by the JAX
module's NumPy branch, and moved to the device. From one host graph both
give the same tables, bitwise the JAX tables: the counting sort is stable
and the edges arrive grouped by destination.

Aggregation (``aggregate``): an f32 accumulator, tiles outer and levels
inner, as in JAX, cast once at the end, so a destination whose in-edges
span many tiles never rounds T times. A (tile, level)'s real rows are the
first ``n_rows[l][t]`` of its ``N_l``; the rest are padding rows with
``dst = v_num``, which JAX computes and drops with ``mode="drop"`` and the
port does not visit (an index out of range is a device-side assert on
CUDA). Each destination is written once per (tile, level), so
``acc[dr] = acc[dr] + part`` needs no float atomics and two calls are
bitwise equal. Rows are taken in chunks whose ``[rows, K, f]`` gather stays
within ``ops/ell.py::_PLAIN_CHUNK_ELEMS``; rows are independent, so the
chunk size does not change a result. (The JAX module's 32 MiB
``NTS_ELL_CHUNK_MIB`` sized TPU VMEM and is not ported.)

Rectangular form (``src_num``, as in JAX): the distributed trainer's
per-shard tables (``parallel/dist_blocked.py``) have one shard's ``vp``
destination rows over the whole gathered ``[P*vp, f]`` source slab, so
the tiles cut ``src_num`` source rows; ``src_num = 0`` is the square form.

``BlockedAggregate`` pairs the forward over the CSC tables (tiled by
source) with the backward over the CSR tables (tiled by destination), as
JAX's ``_blocked_aggregate`` custom_vjp does. The route is
``OPTIM_KERNEL:1 KERNEL_TILE:<vt>`` without ``PALLAS``; it runs no
hand-written kernel, as in JAX, where it is XLA code.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from neutronstarlite_torch import native as native_rt
from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.ops import ell as _ell
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("blocked_ell")

_MIN_K = 4


def resolve_levels(levels: str = "") -> str:
    """``pow2`` or ``binned``; ``""`` is ``pow2`` (the fused edge tables
    default to ``binned`` at their call site)."""
    lv = levels or "pow2"
    if lv not in ("pow2", "binned"):
        raise ValueError(f"ELL level mode must be pow2 or binned, got {lv!r}")
    return lv


def _binned_row_k(row_len: np.ndarray, row_tile: np.ndarray, n_tiles: int) -> np.ndarray:
    """Per-row level capacity, degree-binned: start from the pow2 ladder's
    bins; shrink each bin's K to its longest run rounded up to a multiple
    of ``_MIN_K``; split a bin at its median run when that saves >= 25 % of
    the bin's slots priced on the stacked allocation (a level costs
    n_tiles * max rows in any one tile * K). Never more slots than pow2."""
    lens = np.maximum(row_len.astype(np.int64), 1)
    tiles = row_tile.astype(np.int64)
    pow2 = np.maximum(2 ** np.ceil(np.log2(lens)).astype(np.int64), _MIN_K)

    def up(v):
        return max(int(-(-int(v) // _MIN_K) * _MIN_K), _MIN_K)

    def tile_rows(mask):
        """the most rows any one tile contributes: the n_l a level of
        these rows allocates"""
        return int(np.bincount(tiles[mask], minlength=n_tiles).max()) if mask.any() else 0

    out = np.empty_like(lens)
    for K in np.unique(pow2):
        sel = pow2 == K
        lb = lens[sel]
        mx = up(lb.max())
        med = up(np.median(lb))
        if med < mx:
            low = sel & (lens <= med)
            cost_split = tile_rows(low) * med + tile_rows(sel & ~low) * mx
            if cost_split <= 0.75 * tile_rows(sel) * mx:
                out[sel] = np.where(lb <= med, med, mx)
                continue
        out[sel] = mx
    return out


@dataclasses.dataclass
class BlockedEll:
    """One direction's source-tiled stacked tables (torch tensors).

    Per level l: ``nbr[l]`` [T, N_l, K_l] int32 tile-local source ids,
    ``wgt[l]`` [T, N_l, K_l] float32 weights (0 on padding slots),
    ``dst_row[l]`` [T, N_l] int32 the destination of each row (``v_num``
    on padding rows); ``n_rows[l]`` [T] (host) the real rows of each tile,
    which come first.
    """

    nbr: List[torch.Tensor]
    wgt: List[torch.Tensor]
    dst_row: List[torch.Tensor]
    n_rows: List[np.ndarray]
    vt: int
    v_num: int
    n_tiles: int
    src_num: int = 0  # source rows when they differ from v_num (rectangular)

    @staticmethod
    def build(
        v_num: int,
        offsets: np.ndarray,  # [V+1] per-destination adjacency offsets
        adj: np.ndarray,  # [E] source ids, grouped by destination
        weights: np.ndarray,  # [E]
        vt: int,
        levels: str = "",
        device="cpu",
        src_num: int = 0,  # 0 = square; else rectangular (adj < src_num)
        log_stats: bool = True,
    ) -> "BlockedEll":
        levels = resolve_levels(levels)
        n_src = _ell.source_rows(v_num, src_num)
        n_tiles = -(-n_src // vt)
        # with T*V < 2^31 the (tile, dst) key fits int32 (JAX's fast path)
        idx_t = np.int32 if max(n_tiles * v_num, n_src) < 2 ** 31 else np.int64
        deg = np.diff(offsets).astype(np.int64)
        dst_of_edge = np.repeat(np.arange(v_num, dtype=idx_t), deg)
        adj = np.asarray(adj, dtype=idx_t)
        weights = np.asarray(weights)
        nbrs, wgts, dsts, n_rows = [], [], [], []
        if len(adj):
            # edges arrive grouped by destination, so one stable sort by
            # (tile, dst) gives the (tile, row) order
            tile_of_edge = adj // np.asarray(vt, idx_t)
            use_native = native_rt.available()
            if use_native:
                order = native_rt.sort_by_tile(tile_of_edge.astype(np.int32, copy=False), n_tiles)
            else:
                key = tile_of_edge * np.asarray(v_num, idx_t) + dst_of_edge
                order = np.argsort(key, kind="stable")
            tile_sorted = tile_of_edge[order]
            dst_sorted = dst_of_edge[order]
            change = (tile_sorted[1:] != tile_sorted[:-1]) | (dst_sorted[1:] != dst_sorted[:-1])
            row_start = np.nonzero(np.concatenate([[True], change]))[0]
            row_len = np.diff(np.concatenate([row_start, [len(order)]]))
            row_tile = tile_sorted[row_start].astype(np.int64)
            row_dst = dst_sorted[row_start].astype(np.int64)
            if levels == "binned":
                row_k = _binned_row_k(row_len, row_tile, n_tiles)
            else:
                row_k = np.maximum(
                    2 ** np.ceil(np.log2(np.maximum(row_len, 1))).astype(np.int64), _MIN_K
                )
            src_local = (adj - tile_of_edge * np.asarray(vt, idx_t))[order]
            w_sorted = weights[order]
            if use_native:
                src_local = src_local.astype(np.int32, copy=False)
                w_sorted = np.ascontiguousarray(w_sorted, np.float32)
            pad_slots = real_slots = 0
            for K in sorted(int(k) for k in np.unique(row_k)):
                sel = np.nonzero(row_k == K)[0]
                t_sel = row_tile[sel]
                counts = np.bincount(t_sel, minlength=n_tiles)
                n_l = int(counts.max())
                nbr = np.zeros((n_tiles, n_l, K), dtype=np.int32)
                wgt = np.zeros((n_tiles, n_l, K), dtype=np.float32)
                dstr = np.full((n_tiles, n_l), v_num, dtype=np.int32)
                # a row's slot in its tile is its rank among the tile's rows
                # (sel is sorted by (tile, dst): destinations stay sorted)
                starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
                slot = np.arange(len(sel)) - starts[t_sel]
                d = row_len[sel]
                lo = row_start[sel]
                if use_native:
                    native_rt.fill_blocked_level(
                        lo, d, t_sel.astype(np.int32), row_dst[sel].astype(np.int32),
                        slot, n_l, K, src_local, w_sorted, nbr, wgt, dstr,
                    )
                else:
                    k = np.arange(K)
                    valid = k[None, :] < d[:, None]
                    flat_idx = (lo[:, None] + k[None, :])[valid]
                    ti = np.broadcast_to(t_sel[:, None], (len(sel), K))[valid]
                    si = np.broadcast_to(slot[:, None], (len(sel), K))[valid]
                    ki = np.broadcast_to(k, (len(sel), K))[valid]
                    nbr[ti, si, ki] = src_local[flat_idx]
                    wgt[ti, si, ki] = w_sorted[flat_idx]
                    dstr[t_sel, slot] = row_dst[sel]
                nbrs.append(nbr)
                wgts.append(wgt)
                dsts.append(dstr)
                n_rows.append(counts)
                pad_slots += n_tiles * n_l * K - int(d.sum())
                real_slots += int(d.sum())
            if log_stats:
                log.info(
                    "blocked ELL: %d tiles of %d, %d levels, padding waste %.2fx "
                    "(%d real / %d padded slots)",
                    n_tiles, vt, len(nbrs), (real_slots + pad_slots) / real_slots,
                    real_slots, pad_slots,
                )
        return BlockedEll(
            nbr=[torch.from_numpy(n).to(device) for n in nbrs],
            wgt=[torch.from_numpy(w).to(device) for w in wgts],
            dst_row=[torch.from_numpy(d).to(device) for d in dsts],
            n_rows=n_rows,
            vt=int(vt),
            v_num=int(v_num),
            n_tiles=int(n_tiles),
            src_num=int(src_num),
        )

    def slot_count(self) -> int:
        return sum(int(n.numel()) for n in self.nbr)

    def blocks(
        self, width: int
    ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]:
        """``(lo, nbr, wgt, dst_row)`` of every chunk of real rows, tiles
        outer and levels inner (JAX's order): ``lo`` is the tile's first
        source row, the tables are the chunk's rows, and a chunk's
        ``[rows, K, width]`` gather stays within ``_PLAIN_CHUNK_ELEMS``."""
        for t in range(self.n_tiles):
            for nbr, wgt, dstr, n_rows in zip(self.nbr, self.wgt, self.dst_row, self.n_rows):
                n, k = int(n_rows[t]), nbr.shape[2]
                step = max(_ell._PLAIN_CHUNK_ELEMS // max(k * width, 1), 1)
                for r0 in range(0, n, step):
                    r1 = min(r0 + step, n)
                    yield t * self.vt, nbr[t, r0:r1], wgt[t, r0:r1], dstr[t, r0:r1]

    def aggregate(self, x: torch.Tensor) -> torch.Tensor:
        """out[v] = sum over in-edges of w * x[src]; [src_num or V, f] -> [V, f]
        in x.dtype (f32 products and accumulation, one cast)."""
        acc = torch.zeros((self.v_num, x.shape[1]), dtype=torch.float32, device=x.device)
        return self.aggregate_into(acc, x).to(x.dtype)

    def aggregate_into(self, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``aggregate`` added into an existing [V, f] f32 accumulator,
        returned un-cast."""
        for lo, nb, wg, dr in self.blocks(x.shape[1]):
            x_tile = x[lo:lo + self.vt]
            acc[dr] = acc[dr] + (x_tile[nb].float() * wg[:, :, None]).sum(dim=1)
        return acc


@dataclasses.dataclass
class BlockedEllPair:
    """Forward (CSC, tiled by source) + backward (CSR, tiled by
    destination) tables."""

    fwd: BlockedEll
    bwd: BlockedEll

    @staticmethod
    def from_host(g: CSCGraph, vt: int, levels: str = "", device="cpu") -> "BlockedEllPair":
        return BlockedEllPair(
            fwd=BlockedEll.build(g.v_num, g.column_offset, g.row_indices,
                                 g.edge_weight_forward, vt, levels, device),
            bwd=BlockedEll.build(g.v_num, g.row_offset, g.column_indices,
                                 g.edge_weight_backward, vt, levels, device),
        )


class BlockedAggregate(torch.autograd.Function):
    """``fwd.aggregate(x)``, whose gradient is ``bwd.aggregate(g)``."""

    @staticmethod
    def forward(ctx, x, fwd: BlockedEll, bwd: BlockedEll):
        ctx.bwd = bwd
        return fwd.aggregate(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd.aggregate(grad), None, None


def blocked_gather_dst_from_src(pair: BlockedEllPair, x: torch.Tensor) -> torch.Tensor:
    """Source-tiled weighted aggregation; its backward runs the CSR tables."""
    return BlockedAggregate.apply(x, pair.fwd, pair.bwd)


def blocked_gather_src_from_dst(pair: BlockedEllPair, y: torch.Tensor) -> torch.Tensor:
    """The CSR direction as a forward op."""
    return BlockedAggregate.apply(y, pair.bwd, pair.fwd)
