"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible: a CUDA kernel has no CPU mode. On the CPU,
``test_torch_kernels.py`` holds the plain versions against the JAX
package's Pallas kernels. This file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed. The suite's
``conftest.py`` imports jax, so there it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel against plain version on the same card: float32
rtol=1e-5, atol=1e-6 (the two sum in different orders), except that the
bsp kernel's f32 atol is 4e-5 of the reference's rms (its f32 atomics add
in a varying order, so a sum that cancels to near zero can sit a few
ulps of its terms away; the rule ``chip_smoke.py`` applies); bfloat16
rtol=atol=2**-7 (both accumulate in f32 and round once, so the order can
move a result by one bf16 ulp). The blocked ELL aggregation and the fused
edge op are plain PyTorch on both devices: the card against the CPU at
float32 rtol=1e-5, atol=1e-5 of the CPU output's rms (cuBLAS-free, but
the reductions sum in another order), two calls on the card bitwise
equal. Checkpoints on the ELL route: a resume and a supervised rollback
equal a straight run bitwise (the kernel is repeatable). Serving: each
bucket's captured CUDA graph equals the eager forward bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gat import GATTrainer, gat_layer_ell
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.models.ggcn import GGCNTrainer
from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops import blocked_ell as t_blocked
from neutronstarlite_torch.ops import bsp_ell as t_bsp
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.ops import ell_gat as t_ell_gat
from neutronstarlite_torch.ops import ell_kernel as t_ellk
from neutronstarlite_torch.ops import fused_edge as t_fused
from neutronstarlite_torch.utils.config import InputInfo

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
V = 300


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _hub_graph(hub: int = 3000):
    """Random edges plus one vertex with ``hub`` in- and out-edges (3000: a
    K=4096 ELL level, whose row splits into pieces) and self loops."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, V, size=1200, dtype=np.uint32)
    dst = rng.integers(0, V, size=1200, dtype=np.uint32)
    many = rng.integers(0, V, size=hub, dtype=np.uint32)
    loops = np.arange(V, dtype=np.uint32)
    src = np.concatenate([src, many, np.full(hub, 5, np.uint32), loops])
    dst = np.concatenate([dst, np.full(hub, 5, np.uint32), many, loops])
    return src, dst, build_graph(src, dst, V)


def _np(t):
    return t.detach().float().cpu().numpy()


def _split_tiles(tables, f):
    """How many dst tiles the kernel's piece list at width f splits."""
    tile_ptr = tables.tile_ptr.cpu().numpy()
    starts = tables.pieces(f).cpu().numpy()[:-1]
    per_tile = np.bincount(np.searchsorted(tile_ptr, starts, side="right") - 1)
    return int((per_tile > 1).sum())


@pytest.mark.parametrize("f", [41, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ell", "bsp_small_tiles", "bsp_default_tiles"])
def test_cuda_kernel_matches_plain(cuda_device, kernel, dtype, f):
    _, _, g = _hub_graph()
    if kernel == "ell":
        pair = t_ell.EllPair.from_host(g, device=cuda_device)
        for tables in (pair.fwd, pair.bwd):  # the hub row splits into pieces
            assert t_ellk.work_list(tables, f).n_split > 0
        fn, plain = t_ellk.EllAggregate.apply, lambda b, v: b.plain(v)
    else:
        # default tiles: one dst tile, split into several pieces
        dt, vt = (32, 64) if kernel == "bsp_small_tiles" else (512, 4096)
        pair = t_bsp.BspEllPair.from_host(g, dt=dt, vt=vt, device=cuda_device)
        for tables in (pair.fwd, pair.bwd):  # a dst tile runs in several pieces
            assert _split_tiles(tables, f) > 0
        fn, plain = t_bsp.BspAggregate.apply, t_bsp.bsp_tables_aggregate
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32))
    x = x.to(cuda_device, tdt).requires_grad_(True)
    c = c.to(cuda_device, tdt)
    out = fn(x, pair.fwd, pair.bwd)
    out.backward(c)
    torch.cuda.synchronize()
    assert out.dtype == tdt and x.grad.dtype == tdt
    for got, want in ((out, plain(pair.fwd, x.detach())), (x.grad, plain(pair.bwd, c))):
        want = _np(want)
        tol = BF16_TOL
        if dtype == "float32":
            tol = F32_TOL if kernel == "ell" else dict(
                rtol=F32_TOL["rtol"], atol=4e-5 * float(np.sqrt(np.mean(np.square(want)))))
        np.testing.assert_allclose(_np(got), want, **tol)


def test_cuda_wrappers_count_their_launches(cuda_device):
    _, _, g = _hub_graph()
    ell = t_ell.EllPair.from_host(g, device=cuda_device).fwd
    bsp = t_bsp.BspEllPair.from_host(g, device=cuda_device).fwd
    x = torch.ones((V, 8), device=cuda_device)
    e0, b0 = t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches
    t_ellk.ell_level_aggregate(ell, x)
    t_bsp.bsp_aggregate(bsp, x)
    torch.cuda.synchronize()
    # one launch over all levels, and the split rows' reduction
    assert t_ellk.work_list(ell, 8).n_split > 0
    assert t_ellk.ell_level_aggregate.launches - e0 == 2
    # no row over the cap: the one launch alone
    flat = t_ell.EllPair.from_host(_hub_graph(hub=0)[2], device=cuda_device).fwd
    assert t_ellk.work_list(flat, 8).n_split == 0
    t_ellk.ell_level_aggregate(flat, x)
    assert t_ellk.ell_level_aggregate.launches - e0 == 3
    # two kernels: the aggregation over the pieces, then the combine's cast
    assert _split_tiles(bsp, 8) > 0
    assert t_bsp.bsp_aggregate.launches - b0 == 2
    empty = np.zeros(0, np.uint32)
    g0 = build_graph(empty, empty, V)
    out = t_bsp.bsp_aggregate(t_bsp.BspEllPair.from_host(g0, device=cuda_device).fwd, x)
    assert t_bsp.bsp_aggregate.launches - b0 == 3  # no piece: the cast alone
    torch.cuda.synchronize()
    assert out.shape == (V, 8) and not out.any()


@pytest.mark.parametrize("f", [41, 130, 602])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bsp_geometry_and_occupancy(cuda_device, dtype, f):
    """The exported geometry the piece list reads, and the occupancy the
    launch gets: no shared memory, and at least the three CTAs per SM the
    kernel's launch bounds ask for."""
    geo = t_bsp.geometry()
    assert _build.kernel_cols("bsp_ell") == 128 and geo.max_k >= t_bsp.DEFAULT_K
    occ = t_bsp.occupancy(getattr(torch, dtype), f)
    assert occ["smem_bytes"] == 0
    assert occ["ctas_per_sm"] >= 3 and occ["regs"] <= 80


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ell_matches_plain_at_602(cuda_device, dtype):
    """The main path's widest layer: f = 602 rows start 4-byte aligned, so
    the gathers load in 4-byte halves."""
    test_cuda_kernel_matches_plain(cuda_device, "ell", dtype, 602)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles", ["bsp_small_tiles", "bsp_default_tiles"])
def test_cuda_bsp_matches_plain_at_602(cuda_device, tiles, dtype):
    """The GIN and CommNet bsp routes' widest layer, f32 at 602 (f % 4 ==
    2: 4-byte halves), on small and default tiles."""
    test_cuda_kernel_matches_plain(cuda_device, tiles, dtype, 602)


@pytest.mark.parametrize("f", [41, 130, 602])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ell_geometry_and_occupancy(cuda_device, dtype, f):
    """The exported geometry the work list reads, and the occupancy the
    launch gets: no shared memory, and at least the six 4-warp CTAs per SM
    the kernel's launch bounds ask for."""
    geo = t_ellk.geometry()
    assert _build.kernel_cols("ell_level") == 128 and geo.warps_per_cta == 4
    assert 0 < geo.min_cap <= geo.max_cap and geo.target_warps > 0
    occ = t_ellk.occupancy(getattr(torch, dtype), f)
    assert occ["smem_bytes"] == 0
    assert occ["ctas_per_sm"] >= 6 and occ["regs"] <= 80


@pytest.mark.parametrize("f", [41, 602])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ell_two_calls_bitwise_equal(cuda_device, dtype, f):
    """Split rows combine in piece order, without atomics: the same call
    twice gives the same bits."""
    _, _, g = _hub_graph()
    ell = t_ell.EllPair.from_host(g, device=cuda_device).fwd
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((V, f), dtype=np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    a = t_ellk.ell_level_aggregate(ell, x)
    b = t_ellk.ell_level_aggregate(ell, x)
    torch.cuda.synchronize()
    assert t_ellk.work_list(ell, f).n_split > 0
    assert torch.equal(a, b)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    _, _, g = _hub_graph()
    ell = t_ell.EllPair.from_host(g, device=cuda_device).fwd
    bsp = t_bsp.BspEllPair.from_host(g, device=cuda_device).fwd
    x = torch.ones((V, 8), device=cuda_device)
    for fn, tables in ((t_ellk.ell_level_aggregate, ell), (t_bsp.bsp_aggregate, bsp)):
        with pytest.raises(TypeError):
            fn(tables, x.double())
        with pytest.raises(ValueError):
            fn(tables, torch.ones((8, V), device=cuda_device).t())  # not contiguous
    with pytest.raises(ValueError):  # tables on the CPU, x on the card
        t_ellk.ell_level_aggregate(t_ell.EllPair.from_host(g).fwd, x)
    with pytest.raises(ValueError):
        t_bsp.bsp_aggregate(t_bsp.BspEllPair.from_host(g).fwd, x)


@pytest.mark.parametrize("route", ["bsp", "ell"])
def test_cuda_trainer_route_matches_plain_route(cuda_device, monkeypatch, route):
    """f32, same seeded parameters, no dropout: a kernel route's loss curve
    follows the plain scatter route's on the card."""
    src, dst, g = _hub_graph()
    rng = np.random.default_rng(0)
    datum = GNNDatum(
        feature=rng.standard_normal((V, 24), dtype=np.float32),
        label=rng.integers(0, 5, size=V, dtype=np.int32),
        mask=(np.arange(V) % 3).astype(np.int32),
    )

    def losses(r):
        monkeypatch.setenv("NTS_PALLAS_RESIDENT", "1" if r == "ell" else "0")
        cfg = InputInfo(
            algorithm="GCN", vertices=V, layer_string="24-16-5", epochs=3,
            drop_rate=0.0, optim_kernel=r != "plain", pallas_kernel=r != "plain",
        )
        tr = GCNTrainer.from_arrays(cfg, src, dst, datum, seed=0, device=cuda_device,
                                    host_graph=g)
        tr.run()
        return np.asarray(tr.loss_history)

    want = losses("plain")
    launches = {"bsp": t_bsp.bsp_aggregate, "ell": t_ellk.ell_level_aggregate}[route]
    before = launches.launches
    got = losses(route)
    assert launches.launches > before
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---- the ELL kernel on runtime weights (GAT's attention) ---------------------

def _gat_pair(cuda_device):
    src, dst, _ = _hub_graph()
    return t_ell_gat.GatEllPair.from_host(build_graph(src, dst, V, weight="ones"),
                                          device=cuda_device)


def _alphas(gep, seed):
    """Attention-like runtime weights: positive, each row's live slots
    summing to one, 0 on padding."""
    rng = np.random.default_rng(seed)
    out = []
    for n, real in zip(gep.pair.fwd.nbr, gep.fwd_real):
        a = torch.from_numpy(rng.random(n.shape, dtype=np.float32)).to(n.device) * real
        out.append((a / a.sum(dim=1, keepdim=True).clamp_min(1e-20)).contiguous())
    return out


def _assert_sum_close(got, want, abs_sum):
    """f32 sums of many terms in two orders: rtol 1e-5, and an atol of
    1e-4 of each output's absolute sum of terms (``abs_sum``): the kernel
    adds a row in pieces of up to ~4k slots one after another, so a sum
    that cancels keeps an error of that order (chip_smoke.py's
    F32_SUM_TOL)."""
    got, want, abs_sum = _np(got), _np(want), _np(abs_sum)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-4 * abs_sum + 1e-30)


def _assert_dot_close(got, want, abs_sum, f):
    """f32 dots of length f in two orders: each side's sum is within
    (f - 1) * 2^-24 of its terms' absolute sum (``abs_sum``) of the exact
    one, so the two lie within twice that, plus rtol 1e-6 for the last
    rounding."""
    got, want, abs_sum = _np(got), _np(want), _np(abs_sum)
    tol = 2 * max(f - 1, 1) * 2.0 ** -24 * abs_sum + 1e-6 * np.abs(want) + 1e-30
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("f", [41, 128])
def test_cuda_ell_runtime_weights_match_plain(cuda_device, f):
    """Forward over the CSC tables with runtime alphas, and the paired
    backward: x's gradient over the CSR tables with the same alphas, the
    alphas' gradient from the grad_alpha kernel against the plain version;
    f32, the hub row split."""
    gep = _gat_pair(cuda_device)
    fwd, bwd = gep.pair.fwd, gep.pair.bwd
    assert t_ellk.work_list(fwd, f).n_split > 0 and t_ellk.work_list(bwd, f).n_split > 0
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32)).to(cuda_device)
    c = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32)).to(cuda_device)
    alphas = [a.requires_grad_(True) for a in _alphas(gep, 13)]
    x.requires_grad_(True)
    before = t_ellk.ell_level_aggregate.launches
    out = t_ell_gat.runtime_weighted_aggregate(gep, alphas, x)
    out.backward(c)
    torch.cuda.synchronize()
    assert t_ellk.ell_level_aggregate.launches - before == 4  # two calls, rows split
    a = [t.detach() for t in alphas]
    xd = x.detach()
    for got, tables, w, v in ((out, fwd, a, xd), (x.grad, bwd, gep.transpose_alphas(a), c)):
        want = t_ell.ell_tables_aggregate(v, tables.nbr, w)[tables.inv_perm]
        abs_sum = t_ell.ell_tables_aggregate(v.abs(), tables.nbr, w)[tables.inv_perm]
        _assert_sum_close(got, want, abs_sum)
    # the alphas' gradient from the kernel, against the plain version
    for got, want, abs_sum in zip(alphas, gep.plain_grad_alphas(c, xd),
                                  gep.plain_grad_alphas(c.abs(), xd.abs())):
        _assert_dot_close(got.grad, want, abs_sum, f)


def _grad_alpha_graph():
    """A hub of 3000 in-edges (a K=4096 level, whose row splits into pieces
    on the work list), random edges among the first 250 vertices and no
    self loops: the last 50 have no in-edge (the K=0 level)."""
    rng = np.random.default_rng(20)
    src = rng.integers(0, 250, size=1500, dtype=np.uint32)
    dst = rng.integers(0, 250, size=1500, dtype=np.uint32)
    many = rng.integers(0, V, size=3000, dtype=np.uint32)
    src = np.concatenate([src, many])
    dst = np.concatenate([dst, np.full(3000, 5, np.uint32)])
    return build_graph(src, dst, V, weight="ones")


@pytest.mark.parametrize("f", [1, 7, 41, 128, 130, 602])
def test_cuda_grad_alpha_kernel_matches_plain(cuda_device, f):
    """The grad_alpha kernel against the plain ``grad_alpha_level`` on the
    same f32 inputs, within the f32 dot's bound; padding slots exactly 0;
    one launch per call; two calls back to back bitwise equal;
    ``grad_alphas`` the flat slots per level."""
    gep = t_ell_gat.GatEllPair.from_host(_grad_alpha_graph(), device=cuda_device)
    fwd = gep.pair.fwd
    assert t_ellk.work_list(fwd, f).n_split > 0
    assert any(n.shape[1] == 0 and n.shape[0] > 0 for n in fwd.nbr)  # zero-degree rows
    rng = np.random.default_rng(21)
    g = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32)).to(cuda_device)
    h = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32)).to(cuda_device)
    before = gep.grad_alpha_launches
    flat = gep._grad_alpha_kernel(g, h)
    again = gep._grad_alpha_kernel(g, h)
    levels = gep.grad_alphas(g, h)
    torch.cuda.synchronize()
    assert gep.grad_alpha_launches - before == 3
    assert flat.dtype == torch.float32 and torch.equal(flat, again)
    parts = torch.split(flat, [n.numel() for n in fwd.nbr])
    for n, real, part, lv, want, abs_sum in zip(
            fwd.nbr, gep.fwd_real, parts, levels, gep.plain_grad_alphas(g, h),
            gep.plain_grad_alphas(g.abs(), h.abs())):
        got = part.view(n.shape)
        assert lv.dtype == torch.float32 and torch.equal(lv, got)
        assert not got[~real].any()  # padding exactly 0
        _assert_dot_close(got, want, abs_sum, f)


def test_cuda_grad_alpha_raises_instead_of_falling_back(cuda_device):
    """What the kernel does not take raises: a dtype other than f32 (bf16
    too, for g, h or both), a strided g, a shape that is not the tables', h
    left on the CPU."""
    gep = t_ell_gat.GatEllPair.from_host(_grad_alpha_graph(), device=cuda_device)
    g = torch.ones((V, 8), device=cuda_device)
    for a, b in ((g.double(), g.double()), (g.bfloat16(), g.bfloat16()), (g, g.bfloat16()),
                 (g.bfloat16(), g)):
        with pytest.raises(TypeError):
            gep.grad_alphas(a, b)
    with pytest.raises(ValueError):
        gep.grad_alphas(torch.ones((8, V), device=cuda_device).t(), g)
    with pytest.raises(ValueError):
        gep.grad_alphas(g[:-1], g)
    with pytest.raises(ValueError):
        gep.grad_alphas(g, g.cpu())
    assert gep.grad_alpha_launches == 0


def test_cuda_ell_runtime_weights_two_calls_in_a_row(cuda_device):
    """Two calls on different alphas, launched back to back before any
    synchronisation, are each right (no stale level pointer), and the
    tables' own weights still serve a call without runtime weights."""
    gep = _gat_pair(cuda_device)
    fwd = gep.pair.fwd
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((V, 41), dtype=np.float32))
    x = x.to(cuda_device)
    a1, a2 = _alphas(gep, 15), _alphas(gep, 16)
    own_levels = t_ellk.work_list(fwd, 41).levels.clone()
    o1 = t_ellk.ell_level_aggregate(fwd, x, a1)
    o2 = t_ellk.ell_level_aggregate(fwd, x, a2)
    o3 = t_ellk.ell_level_aggregate(fwd, x)
    torch.cuda.synchronize()
    for got, w in ((o1, a1), (o2, a2), (o3, fwd.wgt)):
        want = t_ell.ell_tables_aggregate(x, fwd.nbr, list(w))[fwd.inv_perm]
        abs_sum = t_ell.ell_tables_aggregate(x.abs(), fwd.nbr, list(w))[fwd.inv_perm]
        _assert_sum_close(got, want, abs_sum)
    assert not torch.allclose(o1, o2)
    assert torch.equal(t_ellk.work_list(fwd, 41).levels, own_levels)
    with pytest.raises(ValueError, match="runtime weights"):
        t_ellk.ell_level_aggregate(fwd, x, [w.double() for w in a1])


def test_cuda_gat_ell_layer_bitwise_repeatable(cuda_device):
    """Forward and every gradient of the GAT ELL layer, twice: the same bits
    (the kernel combines split rows in piece order, the al transpose is a
    row reduction)."""
    gep = _gat_pair(cuda_device)
    rng = np.random.default_rng(17)
    W0 = torch.from_numpy(rng.standard_normal((24, 41), dtype=np.float32) * 0.2)
    a0 = torch.from_numpy(rng.standard_normal((82, 1), dtype=np.float32) * 0.2)
    x0 = torch.from_numpy(rng.standard_normal((V, 24), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((V, 41), dtype=np.float32)).to(cuda_device)
    runs = []
    for _ in range(2):
        W, a, x = (t.to(cuda_device).requires_grad_(True) for t in (W0, a0, x0))
        out = gat_layer_ell(gep, W, a, x, last=False)
        (out * c).sum().backward()
        torch.cuda.synchronize()
        runs.append([out.detach(), W.grad, a.grad, x.grad])
    for first, second in zip(*runs):
        assert torch.equal(first, second)


# ---- the blocked ELL route and the fused edge op (plain PyTorch) -------------


def _rms_close(got, want):
    got, want = _np(got), _np(want)
    rms = float(np.sqrt((want.astype(np.float64) ** 2).mean()))
    assert np.all(np.abs(got - want) <= 1e-5 * rms + 1e-5 * np.abs(want)), (
        float(np.abs(got - want).max()), rms)


def _fused_run(pair, ins, c, slope, device):
    ins = [t.detach().to(device).requires_grad_(True) for t in ins]
    out = t_fused.fused_edge_attention_aggregate(pair, *ins, slope)
    out.backward(c.to(device))
    return [out.detach()] + [t.grad for t in ins]


@pytest.mark.parametrize("channels,slope", [(1, 0.01), (0, 0.2)], ids=["GAT", "GGCN"])
def test_cuda_fused_edge_matches_cpu_and_repeats_bitwise(cuda_device, channels, slope):
    """Forward and the gradients of h, asrc and adst on the card against the
    CPU (several tiles, a hub destination), and two runs on the card with
    the same bits; neither hand-written kernel is launched."""
    src, dst, _ = _hub_graph()
    g = build_graph(src, dst, V, weight="ones")
    f = 24
    ch = channels or f
    rng = np.random.default_rng(21)
    ins = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
           for s in ((V, f), (V, ch), (V, ch))]
    c = torch.from_numpy(rng.standard_normal((V, f), dtype=np.float32))
    want = _fused_run(t_fused.FusedEdgePair.from_host(g, vt=64), ins, c, slope, "cpu")
    pair = t_fused.FusedEdgePair.from_host(g, vt=64, device=cuda_device)
    assert pair.fwd.n_tiles > 1
    e0, b0 = t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches
    runs = [_fused_run(pair, ins, c, slope, cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    assert (t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches) == (e0, b0)
    for got, ref in zip(runs[0], want):
        _rms_close(got.cpu(), ref)
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_blocked_aggregate_matches_cpu_and_repeats_bitwise(cuda_device, dtype):
    src, dst, g = _hub_graph()
    dt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((V, 41), dtype=np.float32))
    x = x.to(dt)
    want = t_blocked.BlockedEllPair.from_host(g, 64).fwd.aggregate(x)
    tables = t_blocked.BlockedEllPair.from_host(g, 64, device=cuda_device).fwd
    xd = x.to(cuda_device)
    first, second = tables.aggregate(xd), tables.aggregate(xd)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and first.dtype == dt
    if dtype == "float32":
        _rms_close(first.cpu(), want)
    else:
        np.testing.assert_allclose(_np(first.cpu()), _np(want), **BF16_TOL)


def _small_datum(f, classes):
    rng = np.random.default_rng(0)
    return GNNDatum(
        feature=rng.standard_normal((V, f), dtype=np.float32),
        label=rng.integers(0, classes, size=V, dtype=np.int32),
        mask=(np.arange(V) % 3).astype(np.int32),
    )


def test_cuda_blocked_trainer_route_matches_plain_route(cuda_device, monkeypatch):
    """GCN f32 through OPTIM_KERNEL:1 KERNEL_TILE:64 follows the plain
    scatter route's loss curve on the card and launches neither kernel."""
    monkeypatch.setenv("NTS_PALLAS_RESIDENT", "0")
    src, dst, g = _hub_graph()
    datum = _small_datum(24, 5)

    def losses(blocked):
        cfg = InputInfo(algorithm="GCN", vertices=V, layer_string="24-16-5", epochs=3,
                        drop_rate=0.0, optim_kernel=blocked, kernel_tile=64 if blocked else 0)
        tr = GCNTrainer.from_arrays(cfg, src, dst, datum, seed=0, device=cuda_device,
                                    host_graph=g)
        assert isinstance(tr.compute_graph, t_blocked.BlockedEllPair) == blocked
        tr.run()
        return np.asarray(tr.loss_history)

    want = losses(False)
    e0, b0 = t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches
    got = losses(True)
    torch.cuda.synchronize()
    assert (t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches) == (e0, b0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("cls", [GATTrainer, GGCNTrainer], ids=["GAT", "GGCN"])
def test_cuda_fused_trainer_route_matches_edge_chain(cuda_device, cls):
    """KERNEL:fused_edge follows the edge chain's loss curve on the card
    (same seeded parameters, no dropout) and launches neither kernel."""
    src, dst, _ = _hub_graph()
    g = build_graph(src, dst, V, weight="ones")
    datum = _small_datum(24, 5)

    def losses(kernel):
        cfg = InputInfo(algorithm=cls.__name__[:-7], vertices=V, layer_string="24-16-5",
                        epochs=3, drop_rate=0.0, kernel=kernel, kernel_tile=64)
        tr = cls.from_arrays(cfg, src, dst, datum, seed=0, device=cuda_device, host_graph=g)
        assert isinstance(tr.compute_graph, t_fused.FusedEdgePair) == bool(kernel)
        tr.run()
        return np.asarray(tr.loss_history)

    want = losses("")
    e0, b0 = t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches
    got = losses("fused_edge")
    torch.cuda.synchronize()
    assert (t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches) == (e0, b0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---- checkpoints and the supervisor on the card (the ELL route) ---------------

def _ell_gcn(cuda_device, monkeypatch, epochs, **kw):
    monkeypatch.setenv("NTS_PALLAS_RESIDENT", "1")
    src, dst, g = _hub_graph()
    cfg = InputInfo(algorithm="GCN", vertices=V, layer_string="24-16-5", epochs=epochs,
                    drop_rate=0.5, precision="bfloat16", optim_kernel=True,
                    pallas_kernel=True, **kw)
    tr = GCNTrainer.from_arrays(cfg, src, dst, _small_datum(24, 5), seed=0,
                                device=cuda_device, host_graph=g)
    assert isinstance(tr.compute_graph, t_ell.EllPair)
    return tr


def _leaves(tr):
    from neutronstarlite_torch.utils import tree as tree_util

    return [leaf.detach().cpu() if torch.is_tensor(leaf) else torch.tensor(int(leaf))
            for leaf in tree_util.leaves(tr.checkpoint_state())]


def test_cuda_ell_route_resume_is_bitwise(cuda_device, monkeypatch, tmp_path):
    """bf16 GCN with dropout 0.5 on the ELL kernel: 6 straight epochs
    against 3 + save + a new trainer restored + 3, bitwise (the kernel is
    repeatable; each epoch's dropout generator is seeded from (seed,
    epoch))."""
    straight = _ell_gcn(cuda_device, monkeypatch, 6)
    before = t_ellk.ell_level_aggregate.launches
    straight.run()
    assert t_ellk.ell_level_aggregate.launches > before
    ck = str(tmp_path / "ck")
    first = _ell_gcn(cuda_device, monkeypatch, 3, checkpoint_dir=ck)
    first.run()
    second = _ell_gcn(cuda_device, monkeypatch, 6, checkpoint_dir=ck)
    before = t_ellk.ell_level_aggregate.launches
    second.run()
    assert t_ellk.ell_level_aggregate.launches > before
    assert first.loss_history + second.loss_history == straight.loss_history
    for a, b in zip(_leaves(second), _leaves(straight)):
        assert torch.equal(a, b)


def test_cuda_rollback_equals_the_straight_run(cuda_device, monkeypatch, tmp_path):
    """supervised_run under nan_loss@epoch=3, a checkpoint each epoch: one
    nonfinite_loss fault, one rollback, and the straight run's losses and
    parameters bitwise."""
    from neutronstarlite_torch.resilience import events, faults
    from neutronstarlite_torch.resilience.supervisor import supervised_run

    straight = _ell_gcn(cuda_device, monkeypatch, 6)
    straight.run()
    records = []

    class Sink:
        def event(self, event_kind, **fields):
            records.append((event_kind, fields.get("kind") or fields.get("action"),
                            fields.get("epoch")))

    tr = _ell_gcn(cuda_device, monkeypatch, 6, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1)
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=3")
    faults.reset()
    events.set_sink(Sink())
    try:
        supervised_run(tr, backoff_base_s=0.0)
    finally:
        events.set_sink(None)
        monkeypatch.delenv("NTS_FAULT_SPEC")
        faults.reset()
    assert records == [("fault", "nonfinite_loss", 3), ("recovery", "rollback", 3)]
    assert tr.loss_history == straight.loss_history
    for a, b in zip(_leaves(tr), _leaves(straight)):
        assert torch.equal(a, b)


# ---- the sampled trainer (GCNSAMPLE) on the card, Cora size -------------------

def _cora_sampled(cuda_device, monkeypatch, mode, epochs=3, **kw):
    import os

    from neutronstarlite_torch.graph.storage import load_edges
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer

    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    monkeypatch.setenv("NTS_FINAL_EVAL", "0")
    monkeypatch.delenv("NTS_SAMPLE_PIPELINE", raising=False)
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "cora")
    src, dst = load_edges(os.path.join(fix, "cora.2708.edge.self"))
    datum = GNNDatum.read_feature_label_mask(
        "", os.path.join(fix, "cora.labeltable"), os.path.join(fix, "cora.mask"), 2708,
        1433, seed=0,
    )
    cfg = InputInfo(algorithm="GCNSAMPLESINGLE", vertices=2708, layer_string="1433-16-7",
                    fanout_string="3-3", batch_size=32, epochs=epochs, decay_epoch=-1,
                    drop_rate=0.5, sample_pipeline=mode, **kw)
    return GCNSampleTrainer.from_arrays(cfg, src, dst, datum, seed=0, device=cuda_device)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cuda_sampled_sync_equals_pipelined_bitwise(cuda_device, monkeypatch, precision):
    """The step is repeatable on the card (minibatch_gather sums over a slot
    axis; its backward's index_put_ sorts): pipelined equals sync,
    losses and parameters, with dropout on."""
    runs = []
    for mode in ("sync", "pipelined"):
        tr = _cora_sampled(cuda_device, monkeypatch, mode, precision=precision)
        tr.run()
        runs.append(tr)
    a, b = runs
    assert a.loss_history == b.loss_history and all(np.isfinite(a.loss_history))
    assert a.loss_history[-1] < a.loss_history[0]
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("mode", ["device", "fused"])
def test_cuda_sampled_device_modes_train_and_repeat(cuda_device, monkeypatch, mode):
    """device and fused: finite, falling losses, two runs bitwise; fused:
    one capture, one replay per batch, no batch payload from the host."""
    runs = []
    for _ in range(2):
        tr = _cora_sampled(cuda_device, monkeypatch, mode)
        tr.run()
        runs.append(tr)
    a, b = runs
    assert a.loss_history == b.loss_history and all(np.isfinite(a.loss_history))
    assert a.loss_history[-1] < a.loss_history[0]
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)
    if mode == "fused":
        r = a._fused
        assert (r.captures, r.replays) == (1, 3 * r.n_batches)
        assert a.counts["sample.h2d_bytes"] == 0


def test_cuda_minibatch_gather_repeats_and_matches_cpu(cuda_device):
    from neutronstarlite_torch.ops.minibatch import minibatch_gather

    rng = np.random.default_rng(0)
    n_src, n_dst, k, f = 5000, 600, 25, 130
    src = rng.integers(0, n_src, size=n_dst * k)
    dst = np.repeat(np.arange(n_dst), k)
    w = rng.uniform(0.01, 1, size=n_dst * k).astype(np.float32)
    w[rng.random(n_dst * k) < 0.2] = 0.0  # dead slots
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    g = rng.standard_normal((n_dst, f)).astype(np.float32)

    def run(device):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        out = minibatch_gather(*(torch.from_numpy(a).to(device) for a in (src, dst, w)), xt,
                               n_dst)
        out.backward(torch.from_numpy(g).to(device))
        return out.detach().cpu(), xt.grad.cpu()

    one, two, cpu = run(cuda_device), run(cuda_device), run("cpu")
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    for a, b in zip(one, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_cuda_fused_subgraph_matches_cpu_bitwise(cuda_device):
    from neutronstarlite_torch.sample.device_sampler import DeviceUniformSampler, fold
    from neutronstarlite_torch.sample.fused import degree_tables, fused_sample_subgraph

    src, dst, g = _hub_graph()
    seeds = torch.arange(0, 64 * 3, 3)
    subs = []
    for device in (cuda_device, torch.device("cpu")):
        ds = DeviceUniformSampler.from_host(g, max_width=64, device=device)
        tables = (ds.nbr, ds.eff_deg) + degree_tables(g, device)
        nodes, hops = fused_sample_subgraph(*tables, seeds.to(device), 60, fold(5, 1, 2),
                                            (64 * 50, 64 * 10, 64), (5, 10))
        subs.append([t.cpu() for t in nodes] + [t.cpu() for h in hops for t in h])
    for a, b in zip(*subs):
        assert torch.equal(a, b)


# ---- the obs plane on the card ----------------------------------------------------


def test_cuda_numerics_leaves_the_ell_route_bitwise(cuda_device, monkeypatch, tmp_path):
    """NTS_NUMERICS=1 on the ELL route: the same losses and parameters,
    bitwise, and every group's stats each epoch, finite."""
    import glob
    import json

    runs = []
    for numerics in ("0", "1"):
        monkeypatch.setenv("NTS_NUMERICS", numerics)
        monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / numerics))
        tr = _ell_gcn(cuda_device, monkeypatch, 4)
        tr.run()
        runs.append(tr)
    a, b = runs
    assert a.loss_history == b.loss_history and all(np.isfinite(a.loss_history))
    for p, q in zip(_leaves(a), _leaves(b)):
        assert torch.equal(p, q)
    (path,) = glob.glob(str(tmp_path / "1" / "*.jsonl"))
    with open(path) as fh:
        stats = [r for r in map(json.loads, fh) if r["event"] == "tensor_stats"]
    assert len(stats) == 4 * 8 and all(r["finite_fraction"] == 1.0 for r in stats)


def test_cuda_numerics_leaves_the_fused_step_bitwise(cuda_device, monkeypatch):
    """The fused sampled step with its stats as outputs of the captured
    graph: the same losses and parameters, bitwise, one capture."""
    runs = []
    for numerics in ("0", "1"):
        monkeypatch.setenv("NTS_NUMERICS", numerics)
        tr = _cora_sampled(cuda_device, monkeypatch, "fused")
        tr.run()
        runs.append(tr)
    a, b = runs
    assert a.loss_history == b.loss_history
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)
    assert b._fused.captures == 1 and b._fused.stats is not None


def test_cuda_memory_collector_reads_the_allocator(cuda_device, monkeypatch):
    from neutronstarlite_torch.obs.collectors import device_memory_stats

    x = torch.empty(1 << 20, dtype=torch.float32, device=cuda_device)
    got = device_memory_stats(cuda_device)
    assert got["available"] is True
    assert got["bytes_in_use"] == torch.cuda.memory_allocated() >= x.numel() * 4
    assert got["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert got["devices"][0]["bytes_limit"] == torch.cuda.mem_get_info()[1]
    tr = _ell_gcn(cuda_device, monkeypatch, 2)
    tr.run()
    summary = tr.run_summary_record
    assert summary["memory"]["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()


# ---- serving on the card: one captured CUDA graph per bucket -------------------

@pytest.mark.parametrize("mode", ["sync", "fused"])
def test_cuda_captured_buckets_equal_the_eager_forward(cuda_device, monkeypatch, tmp_path, mode):
    """Each bucket's captured graph against the eager forward on the same
    operands, bitwise (sync: the same sampled batch; fused: the same seeds
    and draw key); one capture per bucket, a clone captures nothing."""
    from neutronstarlite_torch.models.gcn_sample import batch_forward
    from neutronstarlite_torch.serve.batcher import ServeOptions
    from neutronstarlite_torch.serve.engine import InferenceEngine, batch_device_arrays, unflatten

    tr = _cora_sampled(cuda_device, monkeypatch, mode, epochs=1,
                       checkpoint_dir=str(tmp_path / "ck"))
    tr.run()
    opts = ServeOptions(max_batch=16, buckets=(1, 4, 16), sample_pipeline=mode)
    eng = InferenceEngine(tr, str(tmp_path / "ck"), options=opts,
                          rng=np.random.default_rng(0))
    eng.warmup()
    clone = eng.clone(rng=np.random.default_rng(1))
    rng = np.random.default_rng(2)
    for b in (1, 4, 16):
        ids = rng.choice(2708, size=b, replace=False)
        if mode == "fused":
            served = clone.execute_fused_prepared(clone.prepare_fused(ids, b, key=99), b)
            buf = torch.tensor(list(ids) + [b, 99], device=cuda_device)
            want = clone.fused_forward(buf, b)
        else:
            batch = clone.sampler.sample(b, ids)
            served = clone.forward_batch(batch, b)
            arrays = [torch.from_numpy(a).to(cuda_device) for a in batch_device_arrays(batch)]
            with torch.no_grad():
                want = batch_forward(clone.weights, clone.feature,
                                     *unflatten(arrays, len(clone.fanouts)),
                                     clone.sampler.node_caps(b), clone.compute_dtype)
        assert served.shape == (b, 7) and np.isfinite(served).all()
        np.testing.assert_array_equal(served, want.cpu().numpy())
    assert eng.compile_counts == {1: 1, 4: 1, 16: 1}


def test_cuda_concurrent_replays_equal_lone_replays(cuda_device, monkeypatch, tmp_path):
    """Flushes of different buckets replayed from several threads at once
    answer bitwise what each answers alone: the graphs share one cuBLAS
    workspace, so replays on the card are serialized
    (``serve/engine.py`` ``_REPLAY_LOCK``)."""
    import threading

    from neutronstarlite_torch.serve.batcher import ServeOptions
    from neutronstarlite_torch.serve.engine import InferenceEngine

    tr = _cora_sampled(cuda_device, monkeypatch, "sync", epochs=1,
                       checkpoint_dir=str(tmp_path / "ck"))
    tr.run()
    opts = ServeOptions(max_batch=16, buckets=(1, 4, 16), sample_pipeline="sync")
    eng = InferenceEngine(tr, str(tmp_path / "ck"), options=opts, rng=np.random.default_rng(0))
    eng.warmup()
    rng = np.random.default_rng(3)
    jobs = []
    for b in (4, 16, 4, 16, 1, 16):
        batch = eng.sampler.sample(b, rng.choice(2708, size=b, replace=False))
        jobs.append((batch, b, eng.forward_batch(batch, b)))
    got = {}

    def run(i):
        clone = eng.clone(rng=np.random.default_rng(i))
        batch, b, _ = jobs[i % len(jobs)]
        got[i] = [clone.forward_batch(batch, b) for _ in range(20)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for i, outs in got.items():
        for out in outs:
            np.testing.assert_array_equal(out, jobs[i][2])
    assert len(got) == len(jobs)


# ---- the rectangular per-shard tables of the distributed trainers --------------


def _shard_tables(kernel, device, P=4):
    """Per-shard rectangular tables (vp rows over P*vp sources) of the hub
    graph, forward and transposed, on ``device``."""
    from neutronstarlite_torch.parallel.dist_bsp import build_dist_bsp
    from neutronstarlite_torch.parallel.dist_ell import build_dist_ell
    from neutronstarlite_torch.parallel.dist_graph import DistGraph

    _, _, g = _hub_graph()
    d = DistGraph.build(g, P)
    if kernel == "ell_level":
        return d, build_dist_ell(d, range(P), device=device), t_ellk.ell_level_aggregate, \
            lambda t, v: t.plain(v)
    return d, build_dist_bsp(d, range(P), vt=64, device=device, dt=32), \
        t_bsp.bsp_aggregate, t_bsp.bsp_tables_aggregate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ell_level", "bsp_ell"])
def test_cuda_rectangular_kernel_matches_plain_on_every_shard(cuda_device, kernel, dtype):
    """Each shard's kernel call over the gathered [P*vp, f] x against its
    plain version, both directions; the kernel writes vp rows."""
    d, tables, wrapper, plain = _shard_tables(kernel, cuda_device)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (d.partitions * d.vp, 41), dtype=np.float32)).to(cuda_device, tdt)
    for direction in ("fwd", "bwd"):
        for p, t in getattr(tables, direction).items():
            got = wrapper(t, x)
            torch.cuda.synchronize()
            assert got.shape == (d.vp, 41) and got.dtype == tdt
            want = _np(plain(t, x))
            tol = BF16_TOL if dtype == "bfloat16" else dict(
                rtol=F32_TOL["rtol"], atol=4e-5 * float(np.sqrt(np.mean(np.square(want)))))
            np.testing.assert_allclose(_np(got), want, **tol)


def test_cuda_tuner_measures_and_replays_on_the_card(cuda_device, monkeypatch, tmp_path):
    """The autotuner once on the card: GCNDIST on the twin with DIST_PATH,
    WIRE_DTYPE and MESH auto under NTS_TUNE=measure times its candidates
    there, then NTS_TUNE=cached replays the same pick without a trial."""
    from neutronstarlite_torch.models import get_algorithm

    for var in ("NTS_MESH", "NTS_WIRE_DTYPE", "NTS_METRICS_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    monkeypatch.setenv("NTS_TUNE_DIR", str(tmp_path))
    monkeypatch.setenv("NTS_TUNE_STEPS", "1")
    src, dst, g = _hub_graph()
    rng = np.random.default_rng(4)
    datum = GNNDatum(feature=rng.standard_normal((V, 16), dtype=np.float32),
                     label=rng.integers(0, 4, size=V, dtype=np.int32),
                     mask=(np.arange(V) % 3).astype(np.int32))
    picks = []
    for mode in ("measure", "cached"):
        monkeypatch.setenv("NTS_TUNE", mode)
        cfg = InputInfo(algorithm="GCNDIST", vertices=V, layer_string="16-8-4", epochs=1,
                        drop_rate=0.0, partitions=4, dist_path="auto", wire_dtype="auto",
                        mesh="auto")
        tr = get_algorithm("GCNDIST").from_arrays(cfg, src, dst, datum, device=cuda_device,
                                                  host_graph=g)
        gauges = tr.metrics.snapshot()["gauges"]
        picks.append((gauges["tune.decision"], gauges["tune.decision_source"]))
        if mode == "measure":
            rows = tr.tune_rows
            assert len(rows) == 6 and sum(r["seconds"] is not None for r in rows) == 4
            assert gauges["tune.trial_peak_bytes"] > 0
        assert np.isfinite(tr.run()["loss"])
    assert picks[0][1] == "measured" and picks[1] == (picks[0][0], "cached")


@pytest.mark.parametrize("name", ["bsp_streamed_bf16", "pallas_ell_resident_bf16",
                                  "pallas_ell_fchunked_602_bf16"])
def test_cuda_micro_bench_kernel_ops_launch_and_match_plain(cuda_device, name):
    """micro_bench's three kernel ops at a small shape: each launches its
    kernel (its wrapper's counter rises) and equals its plain version on the
    same card at the bf16 tolerance."""
    from neutronstarlite_torch.tools import micro_bench

    bench = micro_bench.MicroBench(3000, 60000, 7, cuda_device)
    counter = {"bsp_ell": t_bsp.bsp_aggregate, "ell_level": t_ellk.ell_level_aggregate}[
        micro_bench.KERNEL_OPS[name]]
    before = counter.launches
    got = bench.op(name)(1.0)
    torch.cuda.synchronize()
    assert counter.launches > before
    x = bench.need("xw" if "602" in name else "x")
    if name.startswith("bsp"):
        want = t_bsp.bsp_tables_aggregate(bench.need("bsp").fwd, x)
    else:
        want = bench.need("ell").fwd.plain(x)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    out = micro_bench.run(bench, [name], iters=2)
    assert out["platform"] == "gpu" and out["ops"][name]["ms"] > 0


def test_cuda_bitmap_and_nbr_table_equal_the_cpu(cuda_device):
    from neutronstarlite_torch.ops.aggregate import ScatterGraph
    from neutronstarlite_torch.ops.edge_tensor import NbrTable
    from neutronstarlite_torch.utils.bitmap import VertexSubset, process_vertices

    rng = np.random.default_rng(3)
    src = rng.integers(0, V, 2000).astype(np.uint32)
    dst = rng.integers(0, V, 2000).astype(np.uint32)
    g = build_graph(src, dst, V)
    x = torch.from_numpy(rng.standard_normal((V, 8)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        tab = NbrTable.build(g, cap=6, device=dev)
        blocks = tab.vertex_view(ScatterGraph.from_host(g, device=dev), x.to(dev))
        active = VertexSubset.of(V, [1, 5, 7, 200], device=dev).union(
            VertexSubset.of(V, [9], device=dev))
        out[str(dev)] = (tab.reduce_sum(blocks).cpu(),
                         process_vertices(lambda i: x.to(dev)[i, 0], active, "max").cpu())
    a, b = out.values()
    torch.testing.assert_close(a[0], b[0], **F32_TOL)
    assert a[1].item() == b[1].item()
