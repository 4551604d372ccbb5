"""The blocked ELL route and the fused edge op of the torch port against the
JAX package: tables bitwise, the blocked aggregation and the fused op with
their gradients, edge cases, the absence of edge-sized tensors, and the
trainers that run them (GAT and GGCN under ``KERNEL:fused_edge``; GCN, GIN
and CommNet under ``OPTIM_KERNEL:1 KERNEL_TILE``).

One host graph per edge-weight mode (NumPy build) is shared by the two
packages, so both see the same edge order. The JAX trainer runs are cached
at module scope. Tolerances, port against JAX on the same inputs:

- float32: |got - ref| <= 1e-5 * rms(ref) + 1e-5 * |ref| (the sums run in
  another order);
- bfloat16 outputs: one bf16 ulp, 2^-7 * |ref|, plus 1e-5 * rms(ref) for
  sums that cancel (both sides compute in f32 and round once);
- trainers: the per-epoch loss within 1e-4, the eval forward at JAX's
  trained parameters within 1e-3, predictions agreeing at >= 98 %
  (tests/test_torch_models.py says why the trained logits are not held at
  1e-3).
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.commnet import CommNetTrainer as JCommNet
from neutronstarlite_tpu.models.gat import GATTrainer as JGAT
from neutronstarlite_tpu.models.gcn import GCNTrainer as JGCN
from neutronstarlite_tpu.models.ggcn import GGCNTrainer as JGGCN
from neutronstarlite_tpu.models.gin import GINTrainer as JGIN
from neutronstarlite_tpu.ops import blocked_ell as j_blocked
from neutronstarlite_tpu.ops import fused_edge as j_fused
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.commnet import CommNetTrainer
from neutronstarlite_torch.models.gat import GATTrainer
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.models.ggcn import GGCNTrainer
from neutronstarlite_torch.models.gin import GINTrainer
from neutronstarlite_torch.ops import aggregate as t_aggregate
from neutronstarlite_torch.ops import blocked_ell as t_blocked
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.ops import fused_edge as t_fused
from neutronstarlite_torch.ops.aggregate import ScatterGraph
from neutronstarlite_torch.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
GAT_SLOPE, GGCN_SLOPE = 0.01, 0.2


def _assert_f32(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    rms = float(np.sqrt((want.astype(np.float64) ** 2).mean())) if want.size else 0.0
    err = np.abs(got - want)
    limit = 1e-5 * rms + 1e-5 * np.abs(want)
    assert (err <= limit).all(), f"{name}: max err {err.max():.3e}, rms {rms:.3e}"


def _assert_bf16(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    rms = float(np.sqrt((want.astype(np.float64) ** 2).mean())) if want.size else 0.0
    err = np.abs(got - want)
    limit = 2.0 ** -7 * np.abs(want) + 1e-5 * rms
    assert (err <= limit).all(), f"{name}: max err {err.max():.3e}, rms {rms:.3e}"


ASSERT = {"float32": _assert_f32, "bfloat16": _assert_bf16}


def _np(t):
    return t.detach().float().numpy()


# ---- graphs shared by the two packages --------------------------------------


def _edges(name):
    """(src, dst, v_num) of the named test graph."""
    if name == "cora":
        src, dst = j_load_edges(EDGES)
        return src, dst, V
    rng = np.random.default_rng(5)
    if name == "hub":  # random edges, one vertex with 3000 in- and out-edges
        v = 300
        src = rng.integers(0, v, size=1200, dtype=np.uint32)
        dst = rng.integers(0, v, size=1200, dtype=np.uint32)
        many = rng.integers(0, v, size=3000, dtype=np.uint32)
        loops = np.arange(v, dtype=np.uint32)
        return (np.concatenate([src, many, np.full(3000, 5, np.uint32), loops]),
                np.concatenate([dst, np.full(3000, 5, np.uint32), many, loops]), v)
    if name == "edgeless":
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), 50
    if name == "empty_tile":  # no edge touches vertices 128..191 (tile 2 of vt=64)
        v = 300
        ids = np.setdiff1d(np.arange(v), np.arange(128, 192)).astype(np.uint32)
        return rng.choice(ids, 900), rng.choice(ids, 900), v
    raise KeyError(name)


_GRAPHS = {}


def _graphs(name, weight):
    """(JAX host graph, port host graph) of one test graph, NumPy builds."""
    key = (name, weight)
    if key not in _GRAPHS:
        src, dst, v = _edges(name)
        _GRAPHS[key] = (j_build_graph(src, dst, v, weight=weight, use_native=False),
                        build_graph(src, dst, v, weight, use_native=False))
    return _GRAPHS[key]


def _assert_tables_equal(j, t):
    assert (j.vt, j.v_num, j.n_tiles) == (t.vt, t.v_num, t.n_tiles)
    assert len(j.nbr) == len(t.nbr)
    for name in ("nbr", "wgt", "dst_row"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


TABLE_CASES = [("cora", 512), ("cora", 2708), ("hub", 64), ("edgeless", 16),
               ("empty_tile", 64)]


@pytest.mark.parametrize("levels", ["pow2", "binned"])
@pytest.mark.parametrize("graph,vt", TABLE_CASES,
                         ids=[f"{g}-{vt}" for g, vt in TABLE_CASES])
def test_blocked_tables_bitwise_equal_jax(graph, vt, levels):
    jg, tg = _graphs(graph, "gcn_norm")
    for direction in ("forward", "backward"):
        if direction == "forward":
            args = (jg.column_offset, jg.row_indices, jg.edge_weight_forward)
        else:
            args = (jg.row_offset, jg.column_indices, jg.edge_weight_backward)
        j = j_blocked.BlockedEll.build(jg.v_num, *args, vt, levels=levels)
        targs = ((tg.column_offset, tg.row_indices, tg.edge_weight_forward)
                 if direction == "forward" else
                 (tg.row_offset, tg.column_indices, tg.edge_weight_backward))
        t = t_blocked.BlockedEll.build(tg.v_num, *targs, vt, levels=levels)
        _assert_tables_equal(j, t)
    if graph == "empty_tile":
        assert not any(int((d[2] < tg.v_num).sum()) for d in t.dst_row)
    if graph == "edgeless":
        assert t.nbr == [] and t.aggregate(torch.ones(50, 3)).abs().sum() == 0


@pytest.mark.parametrize("levels", ["", "pow2"])
@pytest.mark.parametrize("graph,vt", [("cora", 512), ("hub", 64)])
def test_fused_pair_tables_bitwise_equal_jax(graph, vt, levels):
    jg, tg = _graphs(graph, "ones")
    j = j_fused.FusedEdgePair.from_host(jg, vt=vt, levels=levels)
    t = t_fused.FusedEdgePair.from_host(tg, vt=vt, levels=levels)
    _assert_tables_equal(j.fwd, t.fwd)
    _assert_tables_equal(j.bwd, t.bwd)
    assert j.slot_count() == t.slot_count()


def test_levels_and_default_tile():
    assert t_blocked.resolve_levels("binned") == "binned"
    with pytest.raises(ValueError):
        t_blocked.resolve_levels("auto")
    assert t_fused.default_fused_vt(V) == j_fused.default_fused_vt(V) == 2708
    assert t_fused.default_fused_vt(10 ** 6) == t_fused.DEFAULT_FUSED_VT == 4096
    assert t_fused.default_fused_vt(V, 512) == 512
    assert t_fused.NEG_INF == j_fused.NEG_INF


# ---- the blocked aggregation -----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["dst_from_src", "src_from_dst"])
@pytest.mark.parametrize("graph,vt", [("cora", 512), ("hub", 64)])
def test_blocked_aggregate_and_gradient_match_jax(graph, vt, direction, dtype):
    jg, tg = _graphs(graph, "gcn_norm")
    jp = j_blocked.BlockedEllPair.from_host(jg, vt)
    tp = t_blocked.BlockedEllPair.from_host(tg, vt)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((tg.v_num, 24)).astype(np.float32)
    c = rng.standard_normal((tg.v_num, 24)).astype(np.float32)
    jfn = getattr(j_blocked, f"blocked_gather_{direction}")
    jd = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a: jfn(jp, a), jnp.asarray(x, jd))
    (grad,) = vjp(jnp.asarray(c, jd))
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = getattr(t_aggregate, f"gather_{direction}")(tp, xt)
    assert got.dtype == xt.dtype
    got.backward(torch.tensor(c).to(xt.dtype))
    ASSERT[dtype](_np(got), out, "forward")
    ASSERT[dtype](_np(xt.grad), grad, "gradient")
    tfn = getattr(t_blocked, f"blocked_gather_{direction}")
    assert torch.equal(tfn(tp, xt.detach()), got.detach())


def test_blocked_aggregate_chunks_do_not_change_the_result(monkeypatch):
    _, tg = _graphs("cora", "gcn_norm")
    tp = t_blocked.BlockedEllPair.from_host(tg, 512)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((V, 9)).astype(np.float32))
    whole = tp.fwd.aggregate(x)
    monkeypatch.setattr(t_ell, "_PLAIN_CHUNK_ELEMS", 2000)
    assert torch.equal(tp.fwd.aggregate(x), whole)


# ---- the fused op -----------------------------------------------------------


def _fused_inputs(v, f, channels, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((v, f), (v, channels), (v, channels), (v, f)))


def _jax_fused(pair, h, asrc, adst, c, slope, dtype="float32"):
    jd = getattr(jnp, dtype)
    out, vjp = jax.vjp(
        lambda *a: j_fused.fused_edge_attention_aggregate(pair, *a, slope),
        *(jnp.asarray(a, jd) for a in (h, asrc, adst)),
    )
    return (out, *vjp(jnp.asarray(c, jd)))


_CORA_JAX = {}


def _cora_jax_fused(channels, slope, dtype="float32", f=16):
    """JAX's forward and three gradients on Cora at vt=512 (6 tiles) for
    ``_fused_inputs(V, f, C)``, computed once per case in this module."""
    key = (channels, slope, dtype, f)
    if key not in _CORA_JAX:
        jp = j_fused.FusedEdgePair.from_host(_graphs("cora", "ones")[0], vt=512)
        ins = _fused_inputs(V, f, channels or f)
        _CORA_JAX[key] = _jax_fused(jp, *ins, slope, dtype)
    return _CORA_JAX[key]


def _torch_fused(pair, h, asrc, adst, c, slope, dtype="float32"):
    td = getattr(torch, dtype)
    ins = [torch.tensor(a).to(td).requires_grad_(True) for a in (h, asrc, adst)]
    out = t_fused.fused_edge_attention_aggregate(pair, *ins, slope)
    out.backward(torch.tensor(c).to(td))
    for a in [out] + [i.grad for i in ins]:
        assert a.dtype == td
    return tuple(_np(a) for a in [out] + [i.grad for i in ins])


FUSED_CASES = [("GAT", 1, GAT_SLOPE), ("GGCN", 0, GGCN_SLOPE)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,channels,slope", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_fused_forward_and_gradients_match_jax(family, channels, slope, dtype):
    """vt=512: Cora has 6 source tiles, so the (m, l, acc) carry crosses
    tiles; C=1 (GAT) and C=f (GGCN)."""
    tp = t_fused.FusedEdgePair.from_host(_graphs("cora", "ones")[1], vt=512)
    assert tp.fwd.n_tiles == 6
    want = _cora_jax_fused(channels, slope, dtype)
    got = _torch_fused(tp, *_fused_inputs(V, 16, channels or 16), slope, dtype)
    for name, a, b in zip(("out", "grad_h", "grad_asrc", "grad_adst"), got, want):
        ASSERT[dtype](a, b, name)


def test_fused_empty_destinations_give_exact_zeros():
    """Vertices past ``hub`` have no in-edges: exact zeros forward, and no
    NaN anywhere in the gradients (JAX's pinned convention). Each
    destination's in-edges here share the sign of their score, so
    grad_adst cancels to rounding noise: the outputs are held at
    rtol 1e-5 and atol 1e-6 (the summed terms are O(1)), not against
    their own rms."""
    v, hub = 40, 7
    src = np.arange(v, dtype=np.uint32) % hub + np.uint32(hub)
    dst = np.arange(v, dtype=np.uint32) % hub
    jg = j_build_graph(src % v, dst, v, weight="ones", use_native=False)
    tg = build_graph(src % v, dst, v, "ones", use_native=False)
    ins = _fused_inputs(v, 5, 1, seed=0)
    want = _jax_fused(j_fused.FusedEdgePair.from_host(jg, vt=8), *ins, GAT_SLOPE)
    got = _torch_fused(t_fused.FusedEdgePair.from_host(tg, vt=8), *ins, GAT_SLOPE)
    np.testing.assert_array_equal(got[0][hub:], 0.0)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def test_fused_tile_size_invariance():
    """vt=256 (11 tiles, the state rescaled across them) and vt=V (one
    tile) agree with each other and with JAX's 6-tile result."""
    tg = _graphs("cora", "ones")[1]
    ins = _fused_inputs(V, 16, 1)
    want = _cora_jax_fused(1, GAT_SLOPE)
    runs = [_torch_fused(t_fused.FusedEdgePair.from_host(tg, vt=vt), *ins, GAT_SLOPE)
            for vt in (256, 2708)]
    for a, b, ref in zip(*runs, want):
        _assert_f32(a, b)
        _assert_f32(a, ref)
        _assert_f32(b, ref)


def test_fused_backward_passes_match_jax_pass_by_pass():
    """Passes A (T1), B (grad_adst) and C (grad_h, grad_asrc) each against
    JAX's, from the same forward statistics."""
    jg, tg = _graphs("hub", "ones")
    jp = j_fused.FusedEdgePair.from_host(jg, vt=64)
    tp = t_fused.FusedEdgePair.from_host(tg, vt=64)
    v, f, ch = tg.v_num, 6, 6
    h, asrc, adst, g = _fused_inputs(v, f, ch, seed=4)
    js = j_fused.fused_forward_into(jp.fwd, j_fused.fused_init_state(v, ch, f),
                                    *map(jnp.asarray, (h, asrc, adst)), GGCN_SLOPE)
    ts = t_fused.fused_forward_into(tp.fwd, t_fused.fused_init_state(v, ch, f, "cpu"),
                                    *map(torch.tensor, (h, asrc, adst)), GGCN_SLOPE)
    for a, b in zip(ts, js):
        _assert_f32(_np(a), b)
    m, l = (np.asarray(a) for a in js[:2])
    J = [jnp.asarray(a) for a in (h, asrc, adst, m, l, g)]
    jt1 = j_fused.fused_bwd_t1_into(jp.fwd, jnp.zeros((v, ch)), *J, GGCN_SLOPE)
    T = [torch.tensor(a) for a in (h, asrc, adst, m, l, g)]
    tt1 = t_fused.fused_bwd_t1_into(tp.fwd, torch.zeros(v, ch), *T, GGCN_SLOPE)
    _assert_f32(_np(tt1), jt1)
    t1 = np.asarray(jt1)
    jgad = j_fused.fused_bwd_gadst_into(jp.fwd, jnp.zeros((v, ch)), *J[:5], jt1, J[5],
                                        GGCN_SLOPE)
    tgad = t_fused.fused_bwd_gadst_into(tp.fwd, torch.zeros(v, ch), *T[:5],
                                        torch.tensor(t1), T[5], GGCN_SLOPE)
    _assert_f32(_np(tgad), jgad)
    jgh, jgas = j_fused.fused_bwd_src_into(jp.bwd, (jnp.zeros((v, f)), jnp.zeros((v, ch))),
                                           *J[:5], jt1, J[5], GGCN_SLOPE)
    tgh, tgas = t_fused.fused_bwd_src_into(tp.bwd, (torch.zeros(v, f), torch.zeros(v, ch)),
                                           *T[:5], torch.tensor(t1), T[5], GGCN_SLOPE)
    _assert_f32(_np(tgh), jgh)
    _assert_f32(_np(tgas), jgas)


class _Shapes(TorchDispatchMode):
    """Records the shape of every floating-point tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("family,channels,slope", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_fused_holds_no_edge_sized_tensor(monkeypatch, family, channels, slope):
    """With the chunk bound patched small, no floating-point tensor made by
    the fused forward or backward has more elements than the larger of the
    bound and a V-sized [V, max(f, C)] state, and none has E rows and f
    columns; the edge chain over the same graph does (the control). The
    torch twin of JAX's test_fused_jaxpr_has_no_edge_feature_aval."""
    _, tg = _graphs("cora", "ones")
    tp = t_fused.FusedEdgePair.from_host(tg, vt=512)
    f = 16
    width = max(f, channels or f)
    k_max = max(n.shape[2] for n in tp.fwd.nbr + tp.bwd.nbr)
    bound = 2 * k_max * width
    assert bound < tg.e_num * f
    monkeypatch.setattr(t_ell, "_PLAIN_CHUNK_ELEMS", bound)
    h, asrc, adst, c = map(torch.tensor, _fused_inputs(V, f, channels or f))
    for t in (h, asrc, adst):
        t.requires_grad_(True)
    with _Shapes() as rec:
        out = t_fused.fused_edge_attention_aggregate(tp, h, asrc, adst, slope)
        out.backward(c)
    sizes = [int(np.prod(s)) for s in rec.shapes]
    assert len(rec.shapes) > 100  # the recorder saw the streamed blocks
    assert max(sizes) <= max(bound, V * width), max(rec.shapes, key=np.prod)
    assert not [s for s in rec.shapes if len(s) >= 2 and s[0] >= tg.e_num and s[-1] == f]

    sg = ScatterGraph.from_host(tg)
    with _Shapes() as ctl:
        score = torch.nn.functional.leaky_relu(asrc[sg.csc_src] + adst[sg.csc_dst], slope)
        aggregate_edge_to_dst_weighted(sg, edge_softmax(sg, score), h).sum().backward()
    assert [s for s in ctl.shapes if len(s) >= 2 and s[0] >= tg.e_num and s[-1] == f]


# ---- trainers ----------------------------------------------------------------

TRAINERS = {
    # family: (JAX trainer, port trainer, edge weights, epochs, route keys)
    "GAT": (JGAT, GATTrainer, "ones", 20, dict(kernel="fused_edge", kernel_tile=512)),
    "GGCN": (JGGCN, GGCNTrainer, "ones", 20, dict(kernel="fused_edge", kernel_tile=512)),
    "GCN": (JGCN, GCNTrainer, "gcn_norm", 30, dict(optim_kernel=True, kernel_tile=512)),
    "GIN": (JGIN, GINTrainer, "gcn_norm", 20, dict(optim_kernel=True, kernel_tile=512)),
    "COMMNET": (JCommNet, CommNetTrainer, "gcn_norm", 20,
                dict(optim_kernel=True, kernel_tile=512)),
}
# GIN's loss curve is held at 5e-3 after its first two epochs (those at
# 1e-5): at this init its first batch-norm gets a column that is 92 % dead
# (variance 2.4e-4, so rounding is amplified ~60x), and Adam compounds a
# rounding difference from epoch to epoch. The blocked sum adds each
# tile's run in another order than XLA's (both within 3e-8 of an f64 sum),
# and the curves part by up to 2.7e-3 by epoch 19; JAX's own ELL route
# parts from its scatter and blocked routes by 1.2e-3 on the same run. The
# two trained GIN models then predict the same class on 90 % of vertices,
# so GIN's agreement is held at 85 %; its eval forward at JAX's trained
# parameters is held at 1e-3 like every family's.
CURVE_ATOL = {"GIN": 5e-3}
AGREE = {"GIN": 0.85}


def _cfg(cls, family):
    _, _, _, epochs, keys = TRAINERS[family]
    cfg = cls()
    cfg.algorithm = family
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = epochs
    cfg.decay_epoch = 10  # the stepped decay fires within the run
    cfg.drop_rate = 0.0
    for k, v in keys.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


@pytest.fixture(scope="module")
def jax_runs():
    """JAX trainer on the same route from its own init: (initial params,
    losses, trained params, eval logits) per family."""
    cache = {}

    def get(family):
        if family not in cache:
            jcls, _, weight, _, _ = TRAINERS[family]
            src, dst = j_load_edges(EDGES)
            tr = jcls.from_arrays(_cfg(JInfo, family), src, dst, _data(JDatum),
                                  host_graph=_graphs("cora", weight)[0])
            p0 = jax.tree.map(np.asarray, tr.params)
            tr.run()
            logits = np.asarray(tr._eval_logits(
                tr.params, tr.compute_graph, tr.feature, jax.random.PRNGKey(0)
            ))
            cache[family] = (type(tr.compute_graph).__name__, p0,
                             np.asarray(tr.loss_history),
                             jax.tree.map(np.asarray, tr.params), logits)
        return cache[family]

    return get


@pytest.mark.parametrize("family", list(TRAINERS))
def test_trainer_loss_curve_matches_jax(jax_runs, monkeypatch, family):
    monkeypatch.setenv("NTS_PALLAS_RESIDENT", "0")
    j_route, p0, j_losses, j_params, j_logits = jax_runs(family)
    _, cls, weight, epochs, _ = TRAINERS[family]
    src, dst = j_load_edges(EDGES)
    tr = cls.from_arrays(_cfg(InputInfo, family), src, dst, _data(GNNDatum), device="cpu",
                         host_graph=_graphs("cora", weight)[1])
    want = {"ones": t_fused.FusedEdgePair, "gcn_norm": t_blocked.BlockedEllPair}[weight]
    assert isinstance(tr.compute_graph, want)
    assert type(tr.compute_graph).__name__ == j_route
    params_from_jax(p0, tr)
    out = tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (epochs,)
    np.testing.assert_allclose(losses[:2], j_losses[:2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=CURVE_ATOL.get(family, 1e-4))
    assert losses[-1] < losses[0]
    agree = (tr.eval_logits().numpy().argmax(1) == j_logits.argmax(1)).mean()
    assert agree >= AGREE.get(family, 0.98), agree
    params_from_jax(j_params, tr)
    np.testing.assert_allclose(tr.eval_logits().numpy(), j_logits, rtol=0, atol=1e-3)
    assert set(out["acc"]) == {"train", "eval", "test"}


def test_gat_refuses_blocked_tables(monkeypatch):
    """GAT under OPTIM_KERNEL:1 KERNEL_TILE (the blocked tables) refuses
    with JAX's reason; its fused route takes KERNEL_TILE instead."""
    monkeypatch.setenv("NTS_PALLAS_RESIDENT", "0")
    src, dst = j_load_edges(EDGES)
    cfg = _cfg(InputInfo, "GAT")
    cfg.kernel, cfg.optim_kernel = "", True
    with pytest.raises(ValueError, match="KERNEL_TILE/PALLAS layouts"):
        GATTrainer.from_arrays(cfg, src, dst, _data(GNNDatum), device="cpu",
                               host_graph=_graphs("cora", "ones")[1])


def test_fused_smoke_cfg_trains_through_the_cli():
    cfg = os.path.join(REPO, "configs", "gat_cora_fused_smoke.cfg")
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.run", cfg, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("loaded graph |V|=2708 |E|=13566", "KERNEL:fused_edge", "Epoch 1 loss",
                 "Train Acc:", "Test Acc:", "--avg epoch time"):
        assert line in proc.stdout, line
