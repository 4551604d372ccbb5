"""The port's aggregation kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run as the JAX tests run them off-TPU (``interpret=True``). Same
tables (built by both packages from one edge list), same numpy inputs.
Tolerances: float32 rtol=1e-5, atol=1e-6 (the two sides sum in different
orders); bfloat16 rtol=atol=2**-7 (both accumulate in f32 and round once to
bf16, so a different summation order can move the result by one bf16 ulp).
The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph import storage as jax_storage
from neutronstarlite_tpu.ops import aggregate as jax_aggregate
from neutronstarlite_tpu.ops import bsp_ell as jax_bsp
from neutronstarlite_tpu.ops import ell as jax_ell
from neutronstarlite_tpu.ops import pallas_kernels as jax_pk
from neutronstarlite_tpu.ops.device_graph import DeviceGraph

from neutronstarlite_torch.graph import storage as t_storage
from neutronstarlite_torch.ops import aggregate as t_aggregate
from neutronstarlite_torch.ops import bsp_ell as t_bsp
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.ops import ell_kernel as t_ellk

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _graph(seed, v_num, e_num, hub=0, self_loops=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    if hub:
        many = rng.integers(0, v_num, size=hub, dtype=np.uint32)
        src = np.concatenate([src, many, np.full(hub, 5, np.uint32)])
        dst = np.concatenate([dst, np.full(hub, 5, np.uint32), many])
    if self_loops:
        loops = np.arange(v_num, dtype=np.uint32)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return (
        t_storage.build_graph(src, dst, v_num),
        jax_storage.build_graph(src, dst, v_num, use_native=False),
    )


GRAPHS = {
    "random": dict(seed=1, v_num=97, e_num=700),
    "hub": dict(seed=2, v_num=150, e_num=600, hub=1300),  # a K=2048 level
    "isolated": dict(seed=3, v_num=60, e_num=70, self_loops=False),  # a K=0 level
    "edgeless": dict(seed=4, v_num=19, e_num=0, self_loops=False),
}


def _x(seed, v, f, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((v, f)).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


# ---- ELL level kernel ------------------------------------------------------

@pytest.mark.parametrize("name", ["hub", "isolated"])
def test_ell_levels_match_pallas_level_kernel(name):
    tg, jg = _graph(**GRAPHS[name])
    ours = t_ell.EllPair.from_host(tg).fwd
    ref = jax_ell.EllPair.from_host(jg).fwd
    x = _x(0, tg.v_num, 12)
    ks = []
    for nbr_t, wgt_t, nbr_j, wgt_j in zip(ours.nbr, ours.wgt, ref.nbr, ref.wgt):
        k = nbr_t.shape[1]
        ks.append(k)
        got = t_ell.ell_tables_aggregate(torch.from_numpy(x), [nbr_t], [wgt_t])
        if k == 0:
            assert got.shape == (nbr_t.shape[0], 12) and not got.any()
            continue
        want = jax_pk.ell_aggregate_pallas(
            nbr_j, wgt_j, jnp.asarray(x), row_tile=8, interpret=True
        )
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    assert (max(ks) > 1024) if name == "hub" else (0 in ks)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_pair_forward_matches_pallas(name, dtype):
    tg, jg = _graph(**GRAPHS[name])
    x = _x(1, tg.v_num, 10)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)  # same inputs both sides
    tdt = getattr(torch, dtype)
    got = t_ellk.ell_level_aggregate(
        t_ell.EllPair.from_host(tg).fwd, _to_torch(x, tdt)
    )
    assert got.dtype == tdt and got.shape == (tg.v_num, 10)
    want = jax_pk.gather_dst_from_src_pallas(
        jax_ell.EllPair.from_host(jg), jnp.asarray(x, dtype=getattr(jnp, dtype)),
        row_tile=8, interpret=True,
    )
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("name", ["random", "hub"])
def test_ell_gradient_matches_jax_grad(name):
    tg, jg = _graph(**GRAPHS[name])
    x, c = _x(2, tg.v_num, 6), _x(3, tg.v_num, 6)
    pair = t_ell.EllPair.from_host(tg)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_ellk.EllAggregate.apply(xt, pair.fwd, pair.bwd)
    (out * torch.from_numpy(c)).sum().backward()
    ppair = jax_pk.PallasEllPair.from_host(jg, row_tile=8)
    g_ref = jax.grad(
        lambda v: (jax_pk.pallas_gather_dst_from_src(ppair, v) * jnp.asarray(c)).sum()
    )(jnp.asarray(x))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_ref), **F32_TOL)
    np.testing.assert_allclose(
        _np(out), np.asarray(jax_pk.pallas_gather_dst_from_src(ppair, jnp.asarray(x))),
        **F32_TOL,
    )


def test_ell_wrapper_counts_only_cuda_launches():
    tg, _ = _graph(**GRAPHS["random"])
    before = t_ellk.ell_level_aggregate.launches
    t_ellk.ell_level_aggregate(t_ell.EllPair.from_host(tg).fwd,
                               torch.from_numpy(_x(0, tg.v_num, 4)))
    assert t_ellk.ell_level_aggregate.launches == before


# ---- the ELL kernel's work list ---------------------------------------------

# (target_warps, min_cap, max_cap): the built kernel's geometry, and a small
# cap that splits most rows
WORK_GEOMS = {"kernel": (3072, 128, 4096), "small_cap": (4, 4, 8)}


def _work(buckets, f, geom):
    return t_ellk.ell_work([d.numpy() for d in buckets.deg],
                           [r.numpy() for r in buckets.rows_vertex], f, 128,
                           *WORK_GEOMS[geom])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_ell_deg_is_each_rows_degree(name):
    """The per-row degree the tables carry is the row's in- (fwd) or out-
    (bwd) degree, and every slot past it is padding (index 0, weight 0)."""
    tg, _ = _graph(**GRAPHS[name])
    pair = t_ell.EllPair.from_host(tg)
    for b, offsets in ((pair.fwd, tg.column_offset), (pair.bwd, tg.row_offset)):
        want = np.diff(offsets)
        for nbr, wgt, rows, deg in zip(b.nbr, b.wgt, b.rows_vertex, b.deg):
            assert deg.dtype == torch.int32 and deg.shape == rows.shape
            np.testing.assert_array_equal(deg.numpy(), want[rows.numpy()])
            pad = np.arange(nbr.shape[1])[None, :] >= deg.numpy()[:, None]
            assert not nbr.numpy()[pad].any() and not wgt.numpy()[pad].any()


@pytest.mark.parametrize("geom", list(WORK_GEOMS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_ell_work_covers_every_live_slot_once(name, geom):
    """Every live slot of every row is in exactly one item, a row's items in
    slot order; no item reaches into padding or exceeds the cap; items come
    heaviest first; the list is the same on two builds of the tables."""
    tg, _ = _graph(**GRAPHS[name])
    for f in (41, 602):
        for side in ("fwd", "bwd"):
            b = getattr(t_ell.EllPair.from_host(tg), side)
            w = _work(b, f, geom)
            again = _work(getattr(t_ell.EllPair.from_host(tg), side), f, geom)
            for a, c in ((w.items, again.items), (w.split_ptr, again.split_ptr),
                         (w.split_out, again.split_out)):
                np.testing.assert_array_equal(a, c)
            _, min_cap, max_cap = WORK_GEOMS[geom]
            assert min_cap <= w.cap <= max_cap
            lvl, row, lo, hi, target = w.items.T.astype(np.int64)
            size = hi - lo
            assert (size > 0).all() and (size <= w.cap).all()
            assert (np.diff(size) <= 0).all()  # heaviest first
            deg = [d.numpy() for d in b.deg]
            verts = [r.numpy() for r in b.rows_vertex]
            assert w.live_rows == sum(int((d > 0).sum()) for d in deg)
            split_of = {int(v): j for j, v in enumerate(w.split_out)}
            seen = set()
            for key in sorted(set(zip(lvl.tolist(), row.tolist()))):
                mine = np.nonzero((lvl == key[0]) & (row == key[1]))[0]
                mine = mine[np.argsort(lo[mine])]
                d, v = int(deg[key[0]][key[1]]), int(verts[key[0]][key[1]])
                bounds = np.concatenate([lo[mine][:1], hi[mine]])
                # contiguous ranges from slot 0 to the degree: no padding
                np.testing.assert_array_equal(lo[mine][1:], hi[mine][:-1])
                assert bounds[0] == 0 and bounds[-1] == d
                if len(mine) == 1:
                    assert target[mine[0]] == v and v not in split_of
                else:  # the pieces' scratch rows, in slot order
                    j = split_of[v]
                    np.testing.assert_array_equal(
                        -1 - target[mine], np.arange(w.split_ptr[j], w.split_ptr[j + 1]))
                seen.add(key)
            want = {(i, r) for i, d in enumerate(deg) for r in np.nonzero(d > 0)[0].tolist()}
            assert seen == want
            assert w.n_pieces == w.split_ptr[-1] == int((target < 0).sum())
            if geom == "small_cap" and name in ("hub", "random"):
                assert w.n_split > 0


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_work_combined_matches_whole_and_pallas(name, dtype):
    """The plain version run item by item over the work list (a small cap,
    so rows split) and combined as the kernel combines (a whole row's f32
    sum cast once; a split row's f32 partials summed in piece order, then
    cast once) equals the whole plain version, and on the hub graph the
    Pallas kernels in interpret mode."""
    tg, jg = _graph(**GRAPHS[name])
    f = 9
    x = _x(12, tg.v_num, f)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = _to_torch(x, tdt)
    b = t_ell.EllPair.from_host(tg).fwd
    w = _work(b, f, "small_cap")
    got = torch.zeros((tg.v_num, f), dtype=tdt)
    scratch = torch.zeros((w.n_pieces, f), dtype=torch.float32)
    for lvl, row, lo, hi, target in w.items.tolist():
        part = t_ell._level_sum(xt, b.nbr[lvl][row:row + 1, lo:hi],
                                b.wgt[lvl][row:row + 1, lo:hi])[0]
        if target >= 0:
            got[target] = part.to(tdt)
        else:
            scratch[-1 - target] = part
    for j, v in enumerate(w.split_out.tolist()):
        acc = torch.zeros(f, dtype=torch.float32)
        for p in range(w.split_ptr[j], w.split_ptr[j + 1]):
            acc += scratch[p]
        got[v] = acc.to(tdt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(b.plain(xt)), **tol)
    if name == "hub":
        assert w.n_split > 0
        want = jax_pk.gather_dst_from_src_pallas(
            jax_ell.EllPair.from_host(jg), jnp.asarray(x, dtype=getattr(jnp, dtype)),
            row_tile=8, interpret=True,
        )
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("budget", [1, 40, 5000])
def test_ell_plain_in_pieces_matches_whole(monkeypatch, budget):
    """The plain version bounds its intermediate by cutting a level into
    pieces of rows and, for a hub row, of slots; the pieces add up to the
    whole level's sum."""
    tg, _ = _graph(**GRAPHS["hub"])
    buckets = t_ell.EllPair.from_host(tg).fwd
    x = torch.from_numpy(_x(5, tg.v_num, 7))
    want = buckets.plain(x)
    monkeypatch.setattr(t_ell, "_PLAIN_CHUNK_ELEMS", budget)
    np.testing.assert_allclose(_np(buckets.plain(x)), _np(want), **F32_TOL)


# ---- block-sparse kernel ---------------------------------------------------

BSP_GEOMS = {"tiny": (8, 16, 4, 8), "default": (512, 4096, 8, 128)}


@pytest.mark.parametrize(
    "name,geom", [(n, "tiny") for n in GRAPHS] + [("hub", "default")]
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsp_forward_matches_pallas(name, geom, dtype):
    dt, vt, K, R = BSP_GEOMS[geom]
    tg, jg = _graph(**GRAPHS[name])
    x = _x(4, tg.v_num, 9)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    ours = t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                              tg.edge_weight_forward, dt, vt, K, R)
    ref = jax_bsp.BspEll.build(jg.v_num, jg.column_offset, jg.row_indices,
                               jg.edge_weight_forward, dt=dt, vt=vt, k_slots=K, r_rows=R)
    tdt = getattr(torch, dtype)
    got = t_bsp.bsp_aggregate(ours, _to_torch(x, tdt))
    assert got.dtype == tdt and got.shape == (tg.v_num, 9)
    want = ref.aggregate(jnp.asarray(x, dtype=getattr(jnp, dtype)), interpret=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_bsp_weight_rounds_to_x_dtype():
    """bf16 x: the weights round to bf16 before the product (TPU policy),
    so the result differs from the f32-weight ELL path in general but
    matches a hand computation with rounded weights."""
    tg, _ = _graph(**GRAPHS["random"])
    t = t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                           tg.edge_weight_forward, 8, 16, 4, 8)
    x = _x(5, tg.v_num, 3).astype(ml_dtypes.bfloat16).astype(np.float32)
    got = _np(t_bsp.bsp_aggregate(t, _to_torch(x, torch.bfloat16)))
    w = tg.edge_weight_forward.astype(ml_dtypes.bfloat16).astype(np.float64)
    dense = np.zeros((tg.v_num, tg.v_num))
    np.add.at(dense, (tg.dst_of_edge, tg.row_indices), w)
    want = (dense @ x.astype(np.float64)).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("name", ["random", "hub"])
def test_bsp_gradient_matches_jax_grad(name):
    tg, jg = _graph(**GRAPHS[name])
    x, c = _x(6, tg.v_num, 5), _x(7, tg.v_num, 5)
    pair = t_bsp.BspEllPair.from_host(tg, dt=8, vt=16, k_slots=4, r_rows=8)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_bsp.BspAggregate.apply(xt, pair.fwd, pair.bwd) * torch.from_numpy(c)).sum().backward()
    jpair = jax_bsp.BspEllPair.from_host(jg, dt=8, vt=16, k_slots=4, r_rows=8)
    g_ref = jax.grad(
        lambda v: (jax_bsp.bsp_gather_dst_from_src(jpair, v) * jnp.asarray(c)).sum()
    )(jnp.asarray(x))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_ref), **F32_TOL)


# ---- dispatch and the plain scatter route ---------------------------------

@pytest.mark.parametrize("route", ["scatter", "ell", "bsp"])
def test_dispatch_both_directions_match_jax_scatter(route):
    tg, jg = _graph(**GRAPHS["hub"])
    graph = {
        "scatter": lambda: t_aggregate.ScatterGraph.from_host(tg),
        "ell": lambda: t_ell.EllPair.from_host(tg),
        "bsp": lambda: t_bsp.BspEllPair.from_host(tg, dt=16, vt=32),
    }[route]()
    dg = DeviceGraph.from_host(jg)
    x, c = _x(8, tg.v_num, 7), _x(9, tg.v_num, 7)
    for ours, ref in (
        (t_aggregate.gather_dst_from_src, jax_aggregate.gather_dst_from_src),
        (t_aggregate.gather_src_from_dst, jax_aggregate.gather_src_from_dst),
    ):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = ours(graph, xt)
        (out * torch.from_numpy(c)).sum().backward()
        np.testing.assert_allclose(_np(out), np.asarray(ref(dg, jnp.asarray(x))), **F32_TOL)
        g_ref = jax.grad(lambda v: (ref(dg, v) * jnp.asarray(c)).sum())(jnp.asarray(x))
        np.testing.assert_allclose(_np(xt.grad), np.asarray(g_ref), **F32_TOL)


def test_wrappers_refuse_other_devices():
    tg, _ = _graph(**GRAPHS["random"])
    x = torch.zeros((tg.v_num, 3), device="meta")
    with pytest.raises(ValueError):
        t_ellk.ell_level_aggregate(t_ell.EllPair.from_host(tg).fwd, x)
    with pytest.raises(ValueError):
        t_bsp.bsp_aggregate(t_bsp.BspEllPair.from_host(tg).fwd, x)


def test_bsp_checks_refuse_what_the_kernel_cannot_launch(monkeypatch):
    """The kernel holds a packed row's K slots in registers, so tables of
    more slots per row than its geometry allows are refused. (The geometry
    is the built kernel's export; there is no kernel to ask on the CPU.)"""
    monkeypatch.setattr(t_bsp, "geometry", lambda: t_bsp.BspGeometry(
        max_k=8, target_ctas=2048, min_piece_blocks=2))
    tg, _ = _graph(**GRAPHS["random"])
    t = t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                           tg.edge_weight_forward, dt=8, vt=16, k_slots=16, r_rows=8)
    with pytest.raises(ValueError, match="slots"):
        t_bsp._check_inputs(t, torch.zeros((tg.v_num, 2)))
    with pytest.raises(TypeError):
        t_bsp._check_inputs(t, torch.zeros((tg.v_num, 2), dtype=torch.float64))


# ---- the bsp kernel's piece list -------------------------------------------

# (cols, target_ctas, min_blocks): the built kernel's geometry, and others
PIECE_GEOMS = [(128, 2048, 2), (128, 64, 1), (64, 4, 3)]


def _cap(tile_ptr, f, cols, target, min_blocks):
    counts = np.diff(tile_ptr)
    n = int(tile_ptr[-1])
    mean = -(-n // int((counts > 0).sum()))
    return max(min_blocks, min(mean, -(-n * -(-f // cols) // target)))


def _tile_ptrs():
    tg, _ = _graph(**GRAPHS["hub"])
    yield t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                             tg.edge_weight_forward, 8, 16, 4, 8).tile_ptr.numpy()
    # the 0.1-scale Reddit forward tables' shape: 46 tiles, the heaviest 648
    rng = np.random.default_rng(0)
    counts = rng.integers(150, 330, size=46)
    counts[7], counts[20] = 648, 0
    yield np.concatenate([[0], np.cumsum(counts)])
    yield np.zeros(5, np.int64)  # no edges


@pytest.mark.parametrize("geom", PIECE_GEOMS)
@pytest.mark.parametrize("f", [41, 128, 602])
def test_bsp_pieces_cover_every_block_once_within_cap(geom, f):
    for tile_ptr in _tile_ptrs():
        ptr = t_bsp.bsp_pieces(tile_ptr, f, *geom)
        n = int(tile_ptr[-1])
        assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == n
        if n == 0:
            assert len(ptr) == 1
            continue
        sizes = np.diff(ptr)
        assert (sizes > 0).all()  # in order, each block once
        assert set(tile_ptr.tolist()) <= set(ptr.tolist())  # no piece spans two tiles
        assert sizes.max() <= _cap(tile_ptr, f, *geom)
        counts = np.diff(tile_ptr)
        # a tile within the cap stays whole; a heavier one splits evenly
        for lo, c in zip(tile_ptr[:-1], counts):
            inside = sizes[(ptr[:-1] >= lo) & (ptr[:-1] < lo + c)]
            assert inside.sum() == c
            assert len(inside) == (-(-c // _cap(tile_ptr, f, *geom)) if c else 0)
            if len(inside):
                assert inside.max() - inside.min() <= 1


def test_bsp_pieces_split_only_what_needs_it():
    tile_ptr = list(_tile_ptrs())[1]
    # a launch wide enough to fill the card alone: only tiles over the mean split
    ptr = t_bsp.bsp_pieces(tile_ptr, 4096, 128, 256, 2)
    counts = np.diff(tile_ptr)
    mean = -(-int(tile_ptr[-1]) // int((counts > 0).sum()))
    assert len(ptr) - 1 == sum(-(-c // mean) for c in counts)
    assert np.diff(ptr).max() <= mean < 648


@pytest.mark.parametrize("f", [41, 602])
def test_bsp_pieces_same_on_two_builds(f):
    tg, _ = _graph(**GRAPHS["hub"])
    ptrs = [
        t_bsp.bsp_pieces(
            t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                               tg.edge_weight_forward, 8, 16, 4, 8).tile_ptr.numpy(),
            f, *PIECE_GEOMS[0],
        )
        for _ in range(2)
    ]
    np.testing.assert_array_equal(*ptrs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsp_pieces_combined_match_whole_and_pallas(dtype):
    """The plain version run piece by piece over the kernel's piece list and
    combined as the kernel combines (f32 adds into one f32 buffer, one cast)
    equals the whole plain version and the Pallas kernel in interpret mode,
    on a graph whose hub tile splits."""
    dt, vt, K, R = BSP_GEOMS["tiny"]
    tg, jg = _graph(**GRAPHS["hub"])
    f = 9
    x = _x(11, tg.v_num, f)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    ours = t_bsp.BspEll.build(tg.v_num, tg.column_offset, tg.row_indices,
                              tg.edge_weight_forward, dt, vt, K, R)
    tile_ptr = ours.tile_ptr.numpy()
    ptr = t_bsp.bsp_pieces(tile_ptr, f, *PIECE_GEOMS[0])
    per_tile = np.bincount(np.searchsorted(tile_ptr, ptr[:-1], side="right") - 1)
    assert per_tile.max() > 1  # a tile splits
    xt = _to_torch(x, getattr(torch, dtype))
    acc = torch.zeros((ours.t_dst * dt, f), dtype=torch.float32)
    for lo, hi in zip(ptr[:-1], ptr[1:]):
        acc += t_bsp.bsp_blocks_aggregate(ours, xt, int(lo), int(hi))
    got = acc[: tg.v_num].to(xt.dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(t_bsp.bsp_tables_aggregate(ours, xt)), **tol)
    ref = jax_bsp.BspEll.build(jg.v_num, jg.column_offset, jg.row_indices,
                               jg.edge_weight_forward, dt=dt, vt=vt, k_slots=K, r_rows=R)
    want = ref.aggregate(jnp.asarray(x, dtype=getattr(jnp, dtype)), interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
