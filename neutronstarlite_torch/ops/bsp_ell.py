"""Block-sparse (dst tile, src tile) aggregation: tables, plain version,
CUDA wrapper, launch counter and autograd pairing — port of
``neutronstarlite_tpu/ops/bsp_ell.py``.

Vertices are cut into destination tiles of ``dt`` rows and source tiles of
``vt`` rows. Edges are packed into blocks of ``R`` rows x ``K`` slots, each
block belonging to one (dst tile, src tile): a row is (a piece of) one
destination's in-edge run inside one source tile, runs longer than K split
into several rows. A block stores tile-local source ids ``nbr [B, K, R]``,
weights ``wgt [B, K, R]``, each row's tile-local destination ``ldst [B, R]``
and one key ``blk_key [B] = dst_tile * t_src + src_tile``. Data blocks come
first, grouped per dst tile in tile order; then one zero-weight filler block
per empty tile; then zero-weight padding to a multiple of 8 blocks. Apart
from ``tile_ptr`` (the [t_dst+1] range of each tile's data blocks) the
tables are bitwise those of the JAX module's NumPy fill in its unsegmented
form (one segment: ``b_seg`` = all blocks, ``t_seg = t_dst``). When the
native runtime is available (``native/``) its counting sort and run fill
build them, the same tables from one host graph.

The CUDA kernel does not walk whole tiles: ``bsp_pieces`` cuts the data
blocks into pieces (contiguous block ranges inside one dst tile), a tile
splitting only where the card would not be filled or where it is heavier
than the mean tile, and the kernel runs one CTA per (column chunk, piece).
The pieces combine by f32 atomic adds into an f32 buffer, cast to x's
dtype by a second kernel (``csrc/bsp_ell.cu``).

Numeric policy (the TPU kernel's): each weight rounds to ``x.dtype`` before
the product; products and accumulation are f32, across all of a tile's
blocks; one cast to ``x.dtype`` at the end.

Not ported, because they exist only so that the TPU kernel's Mosaic
scalar-prefetch key fits SMEM: the grid segmentation, ``bsp_bseg_menu`` /
``bsp_tseg_menu`` and ``NTS_BSP_MAX_BLOCKS``.

Rectangular form (``src_num``, as in JAX): the distributed trainer's
per-shard tables (``parallel/dist_bsp.py``) have one shard's ``vp``
destination rows and index the whole gathered ``[P*vp, f]`` slab, so the
source tiling is sized by ``src_num`` (``t_src = ceil(src_num / vt)``)
apart from the destination tiling; ``src_num = 0`` is the square form.
The kernel reads source rows below ``n_src`` and writes ``v_num`` rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from neutronstarlite_torch import native as native_rt
from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.obs import cost
from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops.ell import source_rows
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("bsp_ell")

DEFAULT_DT = 512  # dst tile rows
DEFAULT_VT = 4096  # src tile rows
DEFAULT_K = 8  # slots per packed row
DEFAULT_R = 128  # rows per block
_MAX_CTAS = 2 ** 31 - 1  # CUDA's limit on gridDim.x (chunks x pieces)
_PLAIN_CHUNK_ELEMS = 1 << 26  # bound on one [blocks, K, R, f] intermediate


@dataclasses.dataclass
class BspEll:
    """One direction's packed block tables (torch tensors)."""

    nbr: torch.Tensor  # [B, K, R] int32 tile-local source ids
    wgt: torch.Tensor  # [B, K, R] float32 (0 on padding)
    ldst: torch.Tensor  # [B, R] int32 tile-local destination row
    blk_key: torch.Tensor  # [B] int32 dst_tile * t_src + src_tile
    tile_ptr: torch.Tensor  # [t_dst + 1] int32 data-block range per dst tile
    v_num: int
    dt: int
    vt: int
    src_num: int = 0  # source rows when they differ from v_num (rectangular)
    # piece lists of the CUDA launch, by column-chunk count (see ``pieces``)
    _pieces: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def t_dst(self) -> int:
        return -(-self.v_num // self.dt)

    @property
    def n_src(self) -> int:
        return source_rows(self.v_num, self.src_num)

    @property
    def t_src(self) -> int:
        return -(-self.n_src // self.vt)

    @staticmethod
    def build(
        v_num: int,
        offsets: np.ndarray,  # [V+1] per-dst adjacency offsets
        adj: np.ndarray,  # [E] source ids, grouped by dst
        weights: np.ndarray,  # [E]
        dt: int = DEFAULT_DT,
        vt: int = DEFAULT_VT,
        k_slots: int = DEFAULT_K,
        r_rows: int = DEFAULT_R,
        device="cpu",
        src_num: int = 0,  # 0 = square; else rectangular (adj < src_num)
    ) -> "BspEll":
        K, R = int(k_slots), int(r_rows)
        t_dst = -(-v_num // dt)
        t_src = -(-source_rows(v_num, src_num) // vt)
        e_num = len(adj)
        deg = np.diff(offsets).astype(np.int64)
        dst_of_edge = np.repeat(np.arange(v_num, dtype=np.int64), deg)
        adj = np.asarray(adj, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float32)

        if e_num:
            # group edges by (dst tile, src tile); a stable sort keeps each
            # group's edges dst-ascending
            key = (dst_of_edge // dt) * t_src + adj // vt
            # the native counting sort keeps an int64 histogram of
            # t_dst * t_src keys: past 2**24 of them argsort is the better
            # trade (JAX's bound)
            use_native = native_rt.available()
            if use_native and t_dst * t_src < 2 ** 24:
                order = native_rt.sort_by_tile(key.astype(np.int32, copy=False), t_dst * t_src)
            else:
                order = np.argsort(key, kind="stable")
            ks, ds = key[order], dst_of_edge[order]
            ss, ws = adj[order], weights[order]
            # (group, dst) runs -> packed rows of <= K slots
            change = (ks[1:] != ks[:-1]) | (ds[1:] != ds[:-1])
            run_start = np.nonzero(np.concatenate([[True], change]))[0]
            run_len = np.diff(np.concatenate([run_start, [e_num]]))
            run_key, run_dst = ks[run_start], ds[run_start]
            rows_of_run = -(-run_len // K)
            n_rows = int(rows_of_run.sum())
            row_of_first = np.concatenate([[0], np.cumsum(rows_of_run)[:-1]])
            row_run = np.repeat(np.arange(len(run_start)), rows_of_run)
            row_key = run_key[row_run]
            # rows are key-sorted; rank within key -> (block, slot)
            key_change = np.nonzero(
                np.concatenate([[True], row_key[1:] != row_key[:-1]])
            )[0]
            grp_rows = np.diff(np.concatenate([key_change, [n_rows]]))
            rank = np.arange(n_rows) - np.repeat(key_change, grp_rows)
            grp_blocks = -(-grp_rows // R)
            grp_block_start = np.concatenate([[0], np.cumsum(grp_blocks)[:-1]])
            row_block = np.repeat(grp_block_start, grp_rows) + rank // R
            row_slot = rank % R
            n_data = int(grp_blocks.sum())
        else:
            n_rows = n_data = 0
            row_block = np.zeros(0, np.int64)
            row_key = np.zeros(0, np.int64)

        if n_data:
            blk_first = np.nonzero(
                np.concatenate([[True], row_block[1:] != row_block[:-1]])
            )[0]
            data_bd = (row_key[blk_first] // t_src).astype(np.int64)
            data_bs = (row_key[blk_first] % t_src).astype(np.int64)
        else:
            data_bd = np.zeros(0, np.int64)
            data_bs = np.zeros(0, np.int64)

        empty_tiles = np.nonzero(np.bincount(data_bd, minlength=t_dst) == 0)[0]
        used = n_data + len(empty_tiles)
        n_blocks = used + (-used) % 8
        nbr = np.zeros((n_blocks, K, R), dtype=np.int32)
        wgt = np.zeros((n_blocks, K, R), dtype=np.float32)
        ldst = np.zeros((n_blocks, R), dtype=np.int32)
        blk_key = np.zeros(n_blocks, dtype=np.int32)
        if e_num:
            src_local = (ss - (ss // vt) * vt).astype(np.int32)
            run_ldst = (run_dst - (run_dst // dt) * dt).astype(np.int32)
            if use_native:
                # one OpenMP pass over the runs; the data blocks come first,
                # so the [n_blocks, K, R] tables take them in place
                native_rt.fill_bsp(
                    run_start, run_len, row_of_first, run_ldst, row_block, row_slot,
                    src_local, ws, K, R, nbr, wgt, ldst,
                )
            else:
                # per-edge placement: row-relative slot position
                run_of_edge = np.repeat(np.arange(len(run_start)), run_len)
                off = np.arange(e_num) - run_start[run_of_edge]
                e_row = row_of_first[run_of_edge] + off // K
                b_e, s_e = row_block[e_row], row_slot[e_row]
                nbr[b_e, off % K, s_e] = src_local
                wgt[b_e, off % K, s_e] = ws
                ldst[row_block, row_slot] = run_ldst[row_run]
            blk_key[:n_data] = data_bd * t_src + data_bs
        blk_key[n_data:used] = empty_tiles * t_src
        if used:
            blk_key[used:] = blk_key[used - 1]
        tile_ptr = np.searchsorted(data_bd, np.arange(t_dst + 1), side="left")
        if e_num:
            log.info(
                "bsp ELL: %d blocks [%d slots x %d rows], %d dst x %d src tiles, "
                "%d packed rows, slot waste %.2fx",
                n_blocks, K, R, t_dst, t_src, n_rows, n_blocks * K * R / e_num,
            )

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return BspEll(
            nbr=dev(nbr), wgt=dev(wgt), ldst=dev(ldst), blk_key=dev(blk_key),
            tile_ptr=dev(tile_ptr.astype(np.int32)),
            v_num=int(v_num), dt=int(dt), vt=int(vt), src_num=int(src_num),
        )

    def slot_count(self) -> int:
        return int(self.nbr.numel())

    def pieces(self, f: int) -> torch.Tensor:
        """The CUDA launch's piece list at width f (``bsp_pieces`` with the
        built kernel's geometry), on the tables' device; cached per
        column-chunk count."""
        cols, geo = _build.kernel_cols("bsp_ell"), geometry()
        chunks = -(-f // cols)
        ptr = self._pieces.get(chunks)
        if ptr is None:
            ptr = torch.from_numpy(bsp_pieces(
                self.tile_ptr.cpu().numpy(), f, cols, geo.target_ctas,
                geo.min_piece_blocks,
            )).to(self.tile_ptr.device)
            self._pieces[chunks] = ptr
        return ptr


def bsp_pieces(
    tile_ptr: np.ndarray, f: int, cols: int, target_ctas: int, min_blocks: int
) -> np.ndarray:
    """The piece list ``piece_ptr [P+1]`` (int32): piece p holds data blocks
    ``piece_ptr[p]:piece_ptr[p+1]``, all of one dst tile, in tile order, and
    together the pieces cover every data block once.

    A piece holds at most ``cap`` blocks, where ``cap`` is the least of the
    mean blocks per non-empty tile and the blocks that spread the launch's
    work (blocks x column chunks) over ``target_ctas`` CTAs, but at least
    ``min_blocks``. A tile of more than ``cap`` blocks splits into
    ``ceil(n / cap)`` pieces of near-equal size; a lighter tile stays whole.
    A pure function of the tables' tile ranges, f and the kernel's geometry
    (``cols`` per CTA, ``target_ctas``, ``min_blocks``)."""
    tile_ptr = np.asarray(tile_ptr, np.int64)
    n = int(tile_ptr[-1])
    if n == 0:
        return np.zeros(1, np.int32)
    counts = np.diff(tile_ptr)
    busy = counts > 0
    mean = -(-n // int(busy.sum()))
    spread = -(-n * -(-f // cols) // target_ctas)
    cap = max(min_blocks, min(mean, spread))
    c, lo = counts[busy], tile_ptr[:-1][busy]
    parts = -(-c // cap)
    tile = np.repeat(np.arange(len(c)), parts)
    i = np.arange(len(tile)) - np.repeat(np.cumsum(parts) - parts, parts)
    starts = lo[tile] + (c[tile] * i) // parts[tile]
    return np.append(starts, n).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BspGeometry:
    """The launch geometry the built kernel exports."""

    max_k: int  # most slots per packed row
    target_ctas: int  # the CTA count a launch's piece list aims for
    min_piece_blocks: int  # least blocks per piece


@functools.lru_cache(maxsize=None)
def geometry() -> BspGeometry:
    g = (ctypes.c_int * 3)()
    _build.load("bsp_ell").nts_bsp_ell_geometry(g)
    return BspGeometry(*g)


def occupancy(dtype: torch.dtype, f: int) -> dict:
    """The kernel instance that runs x of ``dtype`` at width f: CTAs per SM
    from the CUDA occupancy API, registers per thread, shared bytes per CTA
    and local (spill) bytes per thread."""
    o = (ctypes.c_int * 4)()
    err = _build.load("bsp_ell").nts_bsp_ell_occupancy(int(dtype == torch.bfloat16), f, o)
    _build.check(err, f"bsp_ell occupancy f={f}")
    return {"ctas_per_sm": o[0], "regs": o[1], "smem_bytes": o[2], "local_bytes": o[3]}


def bsp_blocks_aggregate(t: BspEll, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The f32 sums of blocks ``lo:hi`` alone: [t_dst * dt, f]. Blocks are
    processed in chunks that bound the [blocks, K, R, f] intermediate;
    fillers and padding carry weight 0 and add nothing."""
    f = x.shape[1]
    _, k, r = t.nbr.shape
    out = torch.zeros((t.t_dst * t.dt, f), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(k * r * f, 1))
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        key = t.blk_key[a:b].long()
        src = (key % t.t_src)[:, None, None] * t.vt + t.nbr[a:b].long()
        dst = (key // t.t_src)[:, None] * t.dt + t.ldst[a:b].long()
        w = t.wgt[a:b].to(x.dtype).float()
        valid = src < t.n_src
        src = torch.where(valid, src, torch.zeros_like(src))
        w = torch.where(valid, w, torch.zeros_like(w))
        rows = (x[src].float() * w[..., None]).sum(dim=1)  # [b, R, f]
        out.index_add_(0, dst.reshape(-1), rows.reshape(-1, f))
    return out


def bsp_tables_aggregate(t: BspEll, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/bsp_ell.cu``: [n_src, f] -> [V, f]."""
    out = bsp_blocks_aggregate(t, x, 0, t.nbr.shape[0])
    return out[: t.v_num].to(x.dtype)


def _check_inputs(t: BspEll, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != t.n_src:
        raise ValueError(f"x must be [{t.n_src}, f], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bsp_ell takes float32 or bfloat16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bsp_ell needs a contiguous x")
    for a, dt in ((t.nbr, torch.int32), (t.wgt, torch.float32), (t.ldst, torch.int32),
                  (t.blk_key, torch.int32)):
        if a.device != x.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError("bsp tables must be contiguous int32/float32 on x's device")
    max_k = geometry().max_k
    if t.nbr.shape[1] > max_k:
        raise ValueError(
            f"bsp_ell holds a packed row's slots in registers: K={t.nbr.shape[1]} "
            f"slots exceed its {max_k}"
        )
    ctas = -(-x.shape[1] // _build.kernel_cols("bsp_ell")) * (t.pieces(x.shape[1]).numel() - 1)
    if ctas > _MAX_CTAS:
        raise ValueError(f"bsp_ell would launch {ctas} CTAs, over the grid's {_MAX_CTAS}")


def bsp_aggregate(t: BspEll, x: torch.Tensor) -> torch.Tensor:
    """The wrapper: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor; [n_src, f] -> [V, f]. On the card it runs two kernels, the
    aggregation into an f32 buffer and its cast to x's dtype (only the cast
    when the tables hold no edge); ``launches`` counts both."""
    if x.device.type == "cpu":
        return bsp_tables_aggregate(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsp_ell runs on cuda or cpu tensors, got {x.device}")
    _check_inputs(t, x)
    lib = _build.load("bsp_ell")
    f = x.shape[1]
    out = torch.empty((t.v_num, f), dtype=x.dtype, device=x.device)
    if f == 0 or t.v_num == 0:
        return out
    piece_ptr = t.pieces(f)
    n_pieces = piece_ptr.numel() - 1
    acc = torch.empty(t.v_num * (-(-f // 4) * 4), dtype=torch.float32, device=x.device)
    k, r = t.nbr.shape[1], t.nbr.shape[2]
    err = lib.nts_bsp_ell(
        t.nbr.data_ptr(), t.wgt.data_ptr(), t.ldst.data_ptr(), t.blk_key.data_ptr(),
        piece_ptr.data_ptr(), x.data_ptr(), acc.data_ptr(), out.data_ptr(), n_pieces,
        t.t_src, t.dt, t.vt, k, r, t.n_src, t.v_num, f,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"bsp_ell B={t.nbr.shape[0]} f={f}")
    bsp_aggregate.launches += 2 if n_pieces else 1
    return out


bsp_aggregate.launches = 0


class BspAggregate(torch.autograd.Function):
    """Aggregation over ``fwd`` block tables; its gradient is the same kernel
    over ``bwd`` (the transposed adjacency)."""

    @staticmethod
    def forward(ctx, x, fwd: BspEll, bwd: BspEll):
        ctx.bwd = bwd
        cost.note_kernel("bsp_ell", "fwd", x)
        return bsp_aggregate(fwd, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        cost.note_kernel("bsp_ell", "bwd", g)
        return bsp_aggregate(ctx.bwd, g.contiguous()), None, None


@dataclasses.dataclass
class BspEllPair:
    """Forward (CSC) + backward (CSR) block tables."""

    fwd: BspEll
    bwd: BspEll

    @staticmethod
    def from_host(
        g: CSCGraph,
        dt: int = DEFAULT_DT,
        vt: int = DEFAULT_VT,
        k_slots: int = DEFAULT_K,
        r_rows: int = DEFAULT_R,
        device="cpu",
    ) -> "BspEllPair":
        return BspEllPair(
            fwd=BspEll.build(
                g.v_num, g.column_offset, g.row_indices, g.edge_weight_forward,
                dt, vt, k_slots, r_rows, device,
            ),
            bwd=BspEll.build(
                g.v_num, g.row_offset, g.column_indices, g.edge_weight_backward,
                dt, vt, k_slots, r_rows, device,
            ),
        )
