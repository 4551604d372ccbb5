"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible: a CUDA kernel has no CPU mode. On the CPU,
``test_torch_kernels.py`` holds the plain versions against the JAX
package's Pallas kernels. This file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed. The suite's
``conftest.py`` imports jax, so there it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel against plain version on the same card: float32
rtol=1e-5, atol=1e-6 (the two sum in different orders); bfloat16
rtol=atol=2**-7 (both accumulate in f32 and round once, so the order can
move a result by one bf16 ulp).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops import bsp_ell as t_bsp
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.ops import ell_kernel as t_ellk
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


def _hub_graph():
    """Random edges plus one vertex with 3000 in- and out-edges (a K=4096
    ELL level, which runs split-K) and self loops."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, V, size=1200, dtype=np.uint32)
    dst = rng.integers(0, V, size=1200, dtype=np.uint32)
    many = rng.integers(0, V, size=3000, dtype=np.uint32)
    loops = np.arange(V, dtype=np.uint32)
    src = np.concatenate([src, many, np.full(3000, 5, np.uint32), loops])
    dst = np.concatenate([dst, np.full(3000, 5, np.uint32), many, loops])
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
        n_rows, k = pair.fwd.nbr[-1].shape
        # the hub level runs split-K
        assert t_ellk.split_count(n_rows, k, f, _build.kernel_cols("ell_level")) > 1
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
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(plain(pair.fwd, x.detach())), **tol)
    np.testing.assert_allclose(_np(x.grad), _np(plain(pair.bwd, c)), **tol)


def test_cuda_wrappers_count_their_launches(cuda_device):
    _, _, g = _hub_graph()
    ell = t_ell.EllPair.from_host(g, device=cuda_device).fwd
    bsp = t_bsp.BspEllPair.from_host(g, device=cuda_device).fwd
    x = torch.ones((V, 8), device=cuda_device)
    e0, b0 = t_ellk.ell_level_aggregate.launches, t_bsp.bsp_aggregate.launches
    t_ellk.ell_level_aggregate(ell, x)
    t_bsp.bsp_aggregate(bsp, x)
    torch.cuda.synchronize()
    cols = _build.kernel_cols("ell_level")
    # one launch per non-empty level, two (sums, reduction) for a split one
    want = sum(
        2 if t_ellk.split_count(*n.shape, 8, cols) > 1 else 1
        for n in ell.nbr if n.shape[0] and n.shape[1]
    )
    assert want > sum(1 for n in ell.nbr if n.shape[0] and n.shape[1])
    assert t_ellk.ell_level_aggregate.launches - e0 == want
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
