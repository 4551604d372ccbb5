"""The port's distributed plane against the JAX package's.

- ``DistGraph`` (the [P, P, Eb] blocks, the ring's step-major layout, the
  padding statistics, the padded vertex space) and the per-shard ELL, bsp
  and blocked tables are bitwise JAX's: the port keeps one table set per
  shard where JAX stacks them to one shape for ``shard_map``, so each
  shard's live part is held against JAX's ``[p]`` slice (ELL row by row,
  since the port has its own level ladder).
- The rectangular plain aggregations (the port's CPU path of the
  ``ell_level`` and ``bsp_ell`` kernels, and the blocked tables) and the
  ring twin match JAX's ``dist_{ell,bsp,blocked}_gather_simulated`` and
  ``ring_aggregate_simulated`` at P 1, 2 and 4, forward and transposed
  (f32, rtol 1e-5, atol 1e-6: the sums add in other orders).
- The sim trainers' 20-epoch f32 loss curves (drop 0) from JAX's initial
  parameters match within 1e-4: the ELL and blocked routes against JAX's
  ``GCNDIST`` on its 8-device CPU mesh (P=4), the bsp and ring routes
  against the port's ELL curve, and ``GCNEAGERDIST``, ``GINDIST`` and
  ``COMMNETDIST`` on the ELL route against JAX's (``GINDIST`` from seed 1
  at 1e-4; from seed 0 at 5e-3, and at 1e-4 against JAX's single-device
  GIN: see its test). The ``wire.*`` gauges and counters equal JAX's.
- The program cost prices every shard's kernel call with the shard's own
  tables.
- A 2-process gloo run at P=2 (ELL and ring routes) matches the sim twin
  within 1e-5.
- The refusals of this slice.

JAX builds its host graphs with NumPy (``use_native=False``) and its bsp
tables without the native fill, so both sides see the same edge order.
The JAX runs are cached at module scope; torch runs on one thread.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.base import get_algorithm as j_get_algorithm
from neutronstarlite_tpu.parallel import dist_blocked as j_blocked
from neutronstarlite_tpu.parallel import dist_bsp as j_bsp
from neutronstarlite_tpu.parallel import dist_ell as j_ell
from neutronstarlite_tpu.parallel import dist_ops as j_ops
from neutronstarlite_tpu.parallel.dist_graph import DistGraph as JDistGraph
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.gcn_dist import DistGCNTrainer
from neutronstarlite_torch.obs import cost as t_cost
from neutronstarlite_torch.parallel import dist_blocked as t_blocked
from neutronstarlite_torch.parallel import dist_bsp as t_bsp
from neutronstarlite_torch.parallel import dist_ell as t_ell
from neutronstarlite_torch.parallel import dist_ops as t_ops
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.utils import config as t_config
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 20
P_TRAIN = 4
SIM_TOL = dict(rtol=1e-5, atol=1e-6)
# GINDIST against JAX's GINDIST from seed 0: a limit of parity, one ReLU kink
# that rounding decides (test_gindist_seed0_gap_is_one_relu_kink)
GIN_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """The twin, and JAX's NumPy table fills."""
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    for name in ("NTS_PALLAS_RESIDENT", "NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_ELASTIC",
                 "NTS_WIRE_DTYPE", "NTS_MESH", "NTS_METRICS_DIR", "NTS_LEDGER_DIR",
                 "NTS_QUANT_PROBE", "NTS_OVERLAP_PROBE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def _tiny_graph(seed=3, v_num=300, e_num=2400):
    """A random multigraph with a hub (in- and out-degree 200) and loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    many = rng.integers(0, v_num, size=200, dtype=np.uint32)
    loops = np.arange(v_num, dtype=np.uint32)
    src = np.concatenate([src, many, np.full(200, 5, np.uint32), loops])
    dst = np.concatenate([dst, np.full(200, 5, np.uint32), many, loops])
    return (j_build_graph(src, dst, v_num, use_native=False),
            build_graph(src, dst, v_num, use_native=False))


@pytest.fixture(scope="module")
def tiny():
    return _tiny_graph()


@pytest.fixture(scope="module")
def cora():
    src, dst = j_load_edges(EDGES)
    return src, dst, j_build_graph(src, dst, V, use_native=False), build_graph(src, dst, V, use_native=False)


# ---- DistGraph and the per-shard tables, bitwise ---------------------------------


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_dist_graph_is_bitwise_jax(tiny, P):
    jg, tg = tiny
    j, t = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    assert (t.vp, t.eb, t.edge_chunk, t.e_num, t.v_num) == (j.vp, j.eb, j.edge_chunk,
                                                             j.e_num, j.v_num)
    for name in ("offsets", "block_src", "block_dst", "block_weight", "block_count"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert t.padding_stats() == j.padding_stats()
    assert t.step_padding_stats() == j.step_padding_stats()
    jr, tr = j.step_blocks(), t.step_blocks()
    for name in ("src", "dst", "wgt"):
        for a, b in zip(getattr(tr, name), getattr(jr, name)):
            assert np.array_equal(a, b), name
    x = np.random.default_rng(0).standard_normal((tg.v_num, 3)).astype(np.float32)
    assert np.array_equal(t.pad_vertex_array(x), j.pad_vertex_array(x))
    assert np.array_equal(t.unpad_vertex_array(t.pad_vertex_array(x)), x)
    assert np.array_equal(t.valid_mask(), j.valid_mask())


def _dense_rows(nbrs, wgts, inv, k_max):
    """[rows, k_max] neighbour ids and weights of every vertex's table row
    (levels concatenated, padded with zeros, put in vertex order)."""
    n = np.concatenate([np.pad(np.asarray(a), ((0, 0), (0, k_max - a.shape[1])))
                        for a in nbrs])
    w = np.concatenate([np.pad(np.asarray(a), ((0, 0), (0, k_max - a.shape[1])))
                        for a in wgts])
    inv = np.asarray(inv)
    return n[inv], w[inv]


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ell_tables_match_jax_row_by_row(tiny, P):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    jp = j_ell.DistEllPair.build(jd)
    tp = t_ell.build_dist_ell(td, range(P))
    assert tp.partitions == P and tp.vp == jd.vp
    for direction in ("fwd", "bwd"):
        jt = getattr(jp, direction)
        k_max = max(int(n.shape[-1]) for n in jt.nbr)
        for p in range(P):
            tt = getattr(tp, direction)[p]
            assert tt.v_num == jd.vp and tt.n_src == P * jd.vp
            jn, jw = _dense_rows([n[p] for n in jt.nbr], [w[p] for w in jt.wgt],
                                 jt.inv_perm[p], k_max)
            tn, tw = _dense_rows([n.numpy() for n in tt.nbr], [w.numpy() for w in tt.wgt],
                                 tt.inv_perm.numpy(), k_max)
            assert np.array_equal(tn, jn) and np.array_equal(tw, jw), (direction, p)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_bsp_tables_are_bitwise_jax(tiny, P):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    jp = j_bsp.DistBspPair.build(jd, vt=128)
    tp = t_bsp.build_dist_bsp(td, range(P), vt=128)
    for direction in ("fwd", "bwd"):
        jt = getattr(jp, direction)
        assert jt.n_seg == 1
        for p in range(P):
            tt = getattr(tp, direction)[p]
            assert (tt.v_num, tt.n_src, tt.t_src) == (jd.vp, P * jd.vp, -(-P * jd.vp // 128))
            b = tt.nbr.shape[0]
            for name in ("nbr", "wgt", "ldst", "blk_key"):
                got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name)[p])
                assert np.array_equal(got, want[:b]), (direction, p, name)
            # JAX's stacking pad: weight 0, the shard's last key
            assert not np.asarray(jt.wgt[p][b:]).any()
            assert (np.asarray(jt.blk_key[p][b:]) == tt.blk_key[-1].item()).all()


@pytest.mark.parametrize("P", [2, 4])
def test_dist_blocked_tables_are_bitwise_jax(tiny, P):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    jp = j_blocked.DistBlockedEllPair.build(jd, vt=96)
    tp = t_blocked.build_dist_blocked(td, range(P), vt=96)
    for direction in ("fwd", "bwd"):
        jt = getattr(jp, direction)
        j_by_k = {int(n.shape[-1]): i for i, n in enumerate(jt.nbr)}
        for p in range(P):
            tt = getattr(tp, direction)[p]
            assert (tt.n_tiles, tt.v_num, tt.src_num) == (jt.n_tiles, jd.vp, P * jd.vp)
            for n, w, d in zip(tt.nbr, tt.wgt, tt.dst_row):
                i = j_by_k[n.shape[-1]]
                rows = n.shape[1]
                jn, jw, jdr = (np.asarray(a[i][p]) for a in (jt.nbr, jt.wgt, jt.dst_row))
                assert np.array_equal(n.numpy(), jn[:, :rows])
                assert np.array_equal(w.numpy(), jw[:, :rows])
                assert np.array_equal(d.numpy(), jdr[:, :rows])
                assert (jdr[:, rows:] == jd.vp).all() and not jw[:, rows:].any()


# ---- the rectangular plain aggregations against JAX's twins ----------------------


def _twins(route, jd, td, P):
    """(port twin(direction, x), JAX twin(direction, x))."""
    if route == "ring":
        tables = t_ops.RingTables.build(td, range(P))

        @jax.jit
        def jring_bwd(x):
            _, vjp = jax.vjp(lambda a: j_ops.ring_aggregate_simulated(jd, a), x)
            return vjp(x)[0]

        jring = {"fwd": jax.jit(lambda x: j_ops.ring_aggregate_simulated(jd, x)),
                 "bwd": jring_bwd}
        port = {"fwd": lambda x: t_ops.ring_aggregate_simulated(tables, x),
                "bwd": lambda x: t_ops.RingExchange(tables, None).run(x, "bwd")}
        return (lambda d, x: port[d](x)), (lambda d, x: jring[d](x))
    build, sim, jbuild, jsim = {
        "ell": (t_ell.build_dist_ell, t_ell.dist_ell_gather_simulated,
                j_ell.DistEllPair.build, j_ell.dist_ell_gather_simulated),
        "bsp": (lambda d, s: t_bsp.build_dist_bsp(d, s, vt=128),
                t_bsp.dist_bsp_gather_simulated,
                lambda d: j_bsp.DistBspPair.build(d, vt=128), j_bsp.dist_bsp_gather_simulated),
        "blocked": (lambda d, s: t_blocked.build_dist_blocked(d, s, vt=96),
                    t_blocked.dist_blocked_gather_simulated,
                    lambda d: j_blocked.DistBlockedEllPair.build(d, vt=96),
                    j_blocked.dist_blocked_gather_simulated),
    }[route]
    tp, jp = build(td, range(P)), jbuild(jd)
    # the JAX twin under jit: one compile instead of one per eager scan
    return (lambda d, x: sim(getattr(tp, d), x)), \
        (lambda d, x: jax.jit(lambda v: jsim(getattr(jp, d), v))(x))


@pytest.mark.parametrize("route", ["ell", "bsp", "blocked", "ring"])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_rectangular_plain_versions_match_jax_twins(tiny, route, P):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    port, ref = _twins(route, jd, td, P)
    rng = np.random.default_rng(P)
    for direction in ("fwd", "bwd"):
        x = rng.standard_normal((P * td.vp, 13)).astype(np.float32)
        got = port(direction, torch.from_numpy(x))
        want = np.asarray(ref(direction, jnp.asarray(x)))
        assert got.shape == (P * td.vp, 13)
        np.testing.assert_allclose(got.numpy(), want, **SIM_TOL)
        # and both are the graph's own aggregation, unpadded
        a = np.zeros((tg.v_num, tg.v_num), np.float64)
        np.add.at(a, (tg.dst_of_edge, tg.row_indices), tg.edge_weight_forward)
        xs = td.unpad_vertex_array(x).astype(np.float64)
        dense = a @ xs if direction == "fwd" else a.T @ xs
        np.testing.assert_allclose(td.unpad_vertex_array(got.numpy()), dense, rtol=1e-4,
                                   atol=1e-5)


def test_rectangular_tables_check_the_source_rows(tiny):
    """A rectangular table set reads x of P*vp rows and writes vp rows."""
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    _, tg = tiny
    td = DistGraph.build(tg, 2)
    x = torch.ones((2 * td.vp, 4))
    for build, kernel in ((t_ell.build_dist_ell, ell_level_aggregate),
                          (t_bsp.build_dist_bsp, bsp_aggregate)):
        tables = build(td, [1]).fwd[1]
        assert kernel(tables, x).shape == (td.vp, 4)


# ---- the trainers against JAX ----------------------------------------------------


def _cfg(cls, algorithm, route, P=P_TRAIN, **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = EPOCHS
    cfg.decay_epoch = 10  # the stepped decay fires in 20 epochs
    cfg.drop_rate = 0.0
    cfg.partitions = P
    if route == "ring":
        cfg.comm_layer = "ring"
    else:
        cfg.optim_kernel = True
        cfg.pallas_kernel = route == "bsp"
        cfg.kernel_tile = {"ell": 0, "blocked": 512, "bsp": 512}[route]
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


WIRE = ("wire.comm_layer", "wire.rows_per_layer", "wire.bytes_per_epoch_fwd",
        "wire.peak_resident_rows", "dist.active_partitions")


@pytest.fixture(scope="module")
def jax_runs(cora):
    """JAX's dist trainer on its CPU mesh, from its own init: (initial
    params, initial eval logits, losses, wire gauges, wire counters)."""
    cache = {}

    def get(algorithm: str, route: str, seed: int = 0):
        key = (algorithm, route, seed)
        if key not in cache:
            src, dst, jg, _ = cora
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("NTS_DIST_SIMULATE", raising=False)
                tr = j_get_algorithm(algorithm).from_arrays(
                    _cfg(JInfo, algorithm, route), src, dst, _data(JDatum), host_graph=jg,
                    seed=seed)
                p0 = jax.tree.map(np.asarray, tr.params)
                logits0 = np.asarray(tr._eval_logits(tr.params, tr.blocks, tr.feature_p,
                                                      tr.valid_p, jax.random.PRNGKey(0)))
                tr.run()
            m = tr.metrics
            cache[key] = (p0, logits0, np.asarray(tr.loss_history),
                          {k: m._gauges.get(k) for k in WIRE},
                          {k: m._counters.get(k) for k in ("wire.bytes_fwd", "wire.exchanges")})
        return cache[key]

    return get


def _port(cora, algorithm, route, p0=None, **kw):
    src, dst, _, tg = cora
    tr = get_algorithm(algorithm).from_arrays(_cfg(InputInfo, algorithm, route, **kw), src,
                                              dst, _data(GNNDatum), device="cpu",
                                              host_graph=tg)
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


@pytest.fixture(scope="module")
def port_ell_curve(cora, jax_runs):
    p0 = jax_runs("GCNDIST", "ell")[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_DIST_SIMULATE", "1")
        tr = _port(cora, "GCNDIST", "ell", p0)
        tr.run()
    return np.asarray(tr.loss_history)


def test_jax_initial_params_start_the_port_trainer(cora, jax_runs):
    """JAX's initial dist parameters, carried over by params_from_jax,
    give the port's twin JAX's first eval logits over the padded space."""
    p0, logits0 = jax_runs("GCNDIST", "ell")[:2]
    tr = _port(cora, "GCNDIST", "ell", p0)
    got = tr.eval_logits().numpy()
    assert got.shape == logits0.shape == (P_TRAIN * tr.dist.vp, C)
    np.testing.assert_allclose(got, logits0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algorithm,route,seed", [
    *(pytest.param(a, r, 0, id=f"{a}-{r}") for a, r in (
        ("GCNDIST", "ell"), ("GCNDIST", "blocked"), ("GCNEAGERDIST", "ell"),
        ("GINDIST", "ell"), ("COMMNETDIST", "ell"))),
    pytest.param("GINDIST", "ell", 1, id="GINDIST-ell-seed1"),
])
def test_sim_trainer_curve_matches_jax(cora, jax_runs, algorithm, route, seed):
    """GIN from JAX's seed-0 init is held at GIN_TOL against JAX's
    GINDIST: there JAX's own GINDIST and GIN curves part (up to 1.9e-3)
    through one ReLU kink that rounding decides
    (test_gindist_seed0_gap_is_one_relu_kink), while the port stays with
    JAX's GIN. So
    every GIN case is also held at 1e-4 against JAX's single-device GIN
    from the same initial parameters, and GIN from seed 1, where JAX's two
    curves agree, at 1e-4 against JAX's GINDIST."""
    p0, _, j_losses, j_gauges, j_counters = jax_runs(algorithm, route, seed)
    tr = _port(cora, algorithm, route, p0)
    assert isinstance(tr, DistGCNTrainer) and tr.group is None
    out = tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=0,
                               atol=GIN_TOL if (algorithm, seed) == ("GINDIST", 0) else 1e-4)
    if algorithm == "GINDIST":
        src, dst, jg, _ = cora
        cfg = _cfg(JInfo, "GIN", "ell", P=0, optim_kernel=False)
        single = j_get_algorithm("GIN").from_arrays(cfg, src, dst, _data(JDatum),
                                                    host_graph=jg, seed=seed)
        for a, b in zip(jax.tree.leaves(single.params), jax.tree.leaves(p0)):
            assert np.array_equal(np.asarray(a), b)
        single.run()
        np.testing.assert_allclose(losses, single.loss_history, rtol=0, atol=1e-4)
    assert {k: tr.metrics._gauges.get(k) for k in WIRE} == j_gauges
    assert {k: tr.metrics._counters.get(k) for k in j_counters} == j_counters
    assert set(out["acc"]) == {"train", "eval", "test"}


def _jax_gindist_grads(cora, P):
    """JAX's GINDIST at P partitions from its seed-0 init, epoch 0: (loss,
    layer-0 aggregation, layer outputs, d loss / d layer outputs), each
    over the real rows, and the trainer."""
    from neutronstarlite_tpu.models.gcn_dist import dist_gcn_forward as j_forward
    from neutronstarlite_tpu.parallel.dist_ell import dist_ell_gather_dst_from_src

    src, dst, jg, _ = cora
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NTS_DIST_SIMULATE", raising=False)
        tr = j_get_algorithm("GINDIST").from_arrays(_cfg(JInfo, "GINDIST", "ell", P=P), src,
                                                    dst, _data(JDatum), host_graph=jg, seed=0)
    n = P * tr.dist.vp

    def loss_fn(probes):
        acts = []

        def tap(i, x):
            acts.append(x)
            return x + probes[i]

        logits = j_forward(tr.mesh, tr.dist, tr.blocks, tr.params, tr.feature_p, tr.valid_p,
                           jax.random.PRNGKey(0), 0.0, True, type(tr).layer_nn, False, tap=tap)
        return tr.masked_nll_loss(logits, tr.label_p, tr.train01_p), acts

    probes = [jnp.zeros((n, H)), jnp.zeros((n, C))]
    (loss, acts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(probes)
    agg0 = jax.jit(lambda x: dist_ell_gather_dst_from_src(tr.mesh, tr.blocks, x))(tr.feature_p)
    real = tr.dist.unpad_vertex_array
    return (float(loss), real(np.asarray(agg0)), [real(np.asarray(a)) for a in acts],
            [real(np.asarray(g)) for g in grads], tr)


def test_gindist_seed0_gap_is_one_relu_kink(cora):
    """Why JAX's GINDIST (P >= 2) and JAX's GIN part from seed 0, while the
    port's twin and JAX's GINDIST at P=1 stay with GIN: a limit of parity,
    not a fault. The first op that differs is layer 0's aggregation, whose
    ELL levels sum in an order that the partitioning sets (P=1 against P=4:
    at most 3e-8 apart, never more than f32 rounding). Layer 0's outputs
    then differ by ~1e-6, and vertex 1351's layer-1 pre-activation of hidden
    unit 1 sits within that of 0 (2e-8): its ReLU passes the gradient under
    one rounding and not the other. So epoch 0's gradient at layer 0's
    output differs at vertex 1351 and its two in-neighbours only, by 1 % of
    the largest; Adam's normalised first step moves layer 0's weights 3.5e-4
    apart, and the curves part by up to 1.9e-3 in 20 epochs. The port's
    twin takes P=1's branch (its GINDIST curve holds 1e-4 against JAX's
    GIN)."""
    l1, agg1, acts1, g1, tr1 = _jax_gindist_grads(cora, 1)
    l4, agg4, acts4, g4, _ = _jax_gindist_grads(cora, 4)
    assert abs(l1 - l4) <= 1e-6
    d_agg = np.abs(agg1 - agg4).max()
    assert 0 < d_agg <= 1e-7  # the first op that differs, by rounding
    for a, b in zip(acts1, acts4):
        assert np.abs(a - b).max() <= 1e-5  # the forward stays at rounding
    assert np.abs(g1[1] - g4[1]).max() <= 1e-8  # d loss / d logits agree
    d_grad = np.abs(g1[0] - g4[0])
    rows = np.where(d_grad.max(axis=1) > 1e-7)[0]
    assert rows.tolist() == [900, 1351, 1498]
    assert d_grad.max() >= 0.005 * np.abs(g1[0]).max()  # 1 % of the largest
    # the kink: vertex 1351's in-neighbours are exactly those rows, and its
    # layer-1 pre-activation (float64 from P=1's layer-0 output) is ~0
    _, _, jg, _ = cora
    a = np.zeros((V, V))
    np.add.at(a, (jg.dst_of_edge, jg.row_indices), jg.edge_weight_forward)
    assert np.nonzero(a[1351])[0].tolist() == [900, 1351, 1498]
    x = acts1[0].astype(np.float64)
    pre = (a[1351] @ x + x[1351]) @ np.asarray(tr1.params[1]["W1"], np.float64)
    assert np.abs(pre).min() < 1e-6 and int(np.abs(pre).argmin()) == 1


@pytest.mark.parametrize("route", ["bsp", "ring"])
def test_sim_trainer_curve_matches_the_ell_route(cora, jax_runs, port_ell_curve, route):
    tr = _port(cora, "GCNDIST", route, jax_runs("GCNDIST", "ell")[0])
    tr.run()
    np.testing.assert_allclose(tr.loss_history, port_ell_curve, rtol=0, atol=1e-4)


def test_ring_wire_gauges_equal_jax(cora):
    src, dst, jg, tg = cora
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NTS_DIST_SIMULATE", raising=False)
        j = j_get_algorithm("GCNDIST").from_arrays(_cfg(JInfo, "GCNDIST", "ring"), src, dst,
                                                   _data(JDatum), host_graph=jg)
    t = _port(cora, "GCNDIST", "ring")
    assert {k: t.metrics._gauges.get(k) for k in WIRE} == \
        {k: j.metrics._gauges.get(k) for k in WIRE}
    assert t.metrics._gauges["wire.comm_layer"] == "ring"


@pytest.mark.parametrize("route,kernel", [("ell", "ell_level"), ("bsp", "bsp_ell")])
def test_program_cost_prices_every_shard_kernel_call(cora, monkeypatch, route, kernel):
    """One record per (direction, width, shard), priced by aggregation_cost
    over the shard's edges and vp rows read from P*vp sources; the shards'
    forward edges add up to the graph's, and the step's kernel flops are
    the records' sum."""
    monkeypatch.setenv("NTS_PROGRAM_COST", "1")
    tr = _port(cora, "GCNDIST", route, epochs=1)
    tr.run()
    step, *recs = tr.metrics.program_costs
    assert step["label"] == "dist.train_step/DistGCNTrainer"
    vp = tr.dist.vp
    calls = [("fwd", F), ("fwd", H), ("bwd", H)]
    assert sorted((r["direction"], r["width"], r["shard"]) for r in recs) == sorted(
        (d, f, p) for d, f in calls for p in range(P_TRAIN))
    for r in recs:
        assert r["label"] == (f"kernel.{kernel}/{r['direction']}/f{r['width']}/float32"
                              f"/shard{r['shard']}")
        assert (r["vertices"], r["sources"], r["calls_per_step"]) == (vp, P_TRAIN * vp, 1)
        assert (r["flops"], r["bytes_accessed"]) == t_cost.aggregation_cost(
            r["edges"], vp, r["width"], 4, n_src=P_TRAIN * vp)
    for d, f in calls:
        assert sum(r["edges"] for r in recs
                   if (r["direction"], r["width"]) == (d, f)) == tr.host_graph.e_num
    assert step["kernel_calls"] == len(recs)
    assert step["kernel_flops"] == sum(r["flops"] for r in recs)


def test_bf16_dist_training_learns(cora):
    """PRECISION:bfloat16 on the twin: finite, falling loss, f32 logits."""
    tr = _port(cora, "GCNDIST", "ell", precision="bfloat16", epochs=5)
    tr.run()
    assert np.isfinite(tr.loss_history).all() and tr.loss_history[-1] < tr.loss_history[0]
    assert tr.eval_logits().dtype == torch.float32


def test_dist_checkpoint_resume_is_bitwise(cora, tmp_path):
    """6 epochs straight against 3 + save + a new trainer restored + 3."""
    straight = _port(cora, "GCNDIST", "ell", epochs=6)
    straight.run()
    first = _port(cora, "GCNDIST", "ell", epochs=3, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1)
    first.run()
    second = _port(cora, "GCNDIST", "ell", epochs=6, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1)
    second.run()
    assert first.loss_history + second.loss_history == straight.loss_history


# ---- gloo: two ranks against the twin --------------------------------------------


def test_two_gloo_ranks_match_the_sim_twin():
    """P=2 as two processes over gloo on 127.0.0.1 (tools/dist_parity:
    GCNDIST on the ELL and ring routes, dropout 0.5, each rank keeping its
    rows of the twin's masks) against the twin in another process, within
    1e-5, with the limit of 120 s on the whole run."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NTS_DIST_SIMULATE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.tools.dist_parity", "--partitions",
         "2", "--device", "cpu", "--routes", "ell,ring", "--atol", "1e-5",
         "--timeout", "110"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["partitions"] == 2
    for route in ("ell", "ring"):
        r = report["routes"][route]
        assert r["max_loss_gap"] <= 1e-5, (route, r["max_loss_gap"])
        rank, twin = r["rank0"], r["twin"]
        assert rank["rows"] == twin["vp"] and len(rank["losses"]) == 8
        assert twin["losses"][-1] < twin["losses"][0]
        for split, acc in twin["acc"].items():
            assert abs(rank["acc"][split] - acc) <= 1e-3, (route, split)


def test_two_process_resume_with_nonshared_ckpt_dir():
    """JAX's ``tests/test_multihost.py:123`` over gloo: two ranks, one
    CHECKPOINT_DIR each (not shared). Two epochs: only rank 0's directory
    fills. Then to four: both ranks resume at 2 (the epoch and the state
    broadcast from rank 0) and run 2 more, with equal losses (1e-6) and
    accuracies, on the twin's straight 4-epoch curve (1e-5). Without the
    broadcast rank 1 starts at 0 and the collectives hang: the limit of
    120 s ends it. The sharded backend (``CKPT_BACKEND:orbax``, every rank
    saving; rank 0's directory alone holds a completed step) resumes the
    same way."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NTS_DIST_SIMULATE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.tools.dist_parity", "--partitions",
         "2", "--device", "cpu", "--routes", "resume,resume_orbax", "--vertices", "400",
         "--edges",
         "4000", "--layers", "31-15-7", "--epochs", "4", "--atol", "1e-5", "--timeout",
         "110"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    routes = json.loads(proc.stdout.strip().splitlines()[-1])["routes"]
    for r in (routes["resume"], routes["resume_orbax"]):
        assert r["ok"] and r["max_loss_gap"] <= 1e-5
        assert r["dir_filled"] == [True, False]
        assert r["resumed_at"] == [2, 2] and r["epochs_run"] == [2, 2]
        assert abs(r["final_loss"][0] - r["final_loss"][1]) <= 1e-6 * abs(r["final_loss"][0])
        assert r["acc"][0] == r["acc"][1]
        assert len(r["rank0"]["losses"]) == 4


# ---- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("line,match", [
    # auto parses; with the autotuner off the trainer's funnel refuses it
    pytest.param("MESH:auto", "NTS_TUNE", id="MESH:auto-tune slice"),
    pytest.param("WIRE_DTYPE:auto", "NTS_TUNE", id="WIRE_DTYPE:auto-tune slice"),
    ("WIRE_DTYPE:fp8", "WIRE_DTYPE must be"), ("MESH:2;2", "MESH must be"),
    ("COMM_LAYER:mirrored", "COMM_LAYER must be"), ("PROC_REP:1", "DepCache GCN"),
    ("ALGORITHM:GCNCPU", "read only by the distributed trainers"),
])
def test_cfg_refuses_what_later_slices_bring(tmp_path, line, match):
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNDIST\nVERTICES:10\nLAYERS:4-2\nPARTITIONS:4\n" + line + "\n")
    with pytest.raises(ValueError, match=match):
        cfg = t_config.InputInfo.read_from_cfg_file(str(p))
        get_algorithm(cfg.algorithm).check_cfg(cfg)


@pytest.mark.parametrize("line,cls_name", [
    ("ALGORITHM:GATDIST", "DistGATTrainer"), ("ALGORITHM:GGCNDIST", "DistGGCNTrainer"),
    ("ALGORITHM:GCNDISTCACHE", "DistGCNCacheTrainer"),
])
def test_cfg_parses_the_mirror_family(tmp_path, line, cls_name):
    """The ALGORITHM lines earlier slices refused parse, with PARTITIONS,
    and name their trainer."""
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNDIST\nVERTICES:10\nLAYERS:4-2\nPARTITIONS:4\n" + line + "\n")
    cfg = t_config.InputInfo.read_from_cfg_file(str(p))
    assert cfg.algorithm == line.partition(":")[2] and cfg.partitions == 4
    assert get_algorithm(cfg.algorithm).__name__ == cls_name


def test_cfg_parses_the_dist_keys(tmp_path):
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNEAGERDIST\nVERTICES:10\nLAYERS:4-2\nPARTITIONS:8\n"
                 "COMM_LAYER:Ring\nDIST_PATH:all_gather\n")
    cfg = t_config.InputInfo.read_from_cfg_file(str(p))
    assert (cfg.partitions, cfg.comm_layer, cfg.dist_path) == (8, "ring", "all_gather")


@pytest.mark.parametrize("env,kw,match", [
    ({"NTS_PALLAS_RESIDENT": "1"}, {}, "resident"),
    # the distributed plane's switches, refused until the elastic slice:
    # DEBUGINFO, NUMERICS and QUANT_PROBE now run and write their report or
    # records; NTS_ELASTIC refuses where JAX refuses it (GATDIST)
    pytest.param({"NTS_DEBUGINFO": "1"}, {}, "runs:#nn_time=",
                 id="env1-kw1-distributed trainer"),
    pytest.param({"NTS_NUMERICS": "1"}, {}, "runs:tensor_stats",
                 id="env2-kw2-distributed trainer"),
    pytest.param({"NTS_ELASTIC": "1"}, {"algorithm": "GATDIST"},
                 "NTS_ELASTIC=1 is not available for ALGORITHM 'GATDIST'",
                 id="env3-kw3-distributed trainer"),
    # NTS_MESH=auto with the autotuner off; NTS_WIRE_DTYPE takes no auto
    pytest.param({"NTS_MESH": "auto"}, {}, "NTS_TUNE", id="env4-kw4-tune slice"),
    pytest.param({"NTS_WIRE_DTYPE": "auto"}, {}, "not from the env",
                 id="env5-kw5-tune slice"),
    ({"NTS_DIST_SIMULATE": "0"}, {}, "NTS_DIST_SIMULATE=1"),
    pytest.param({"NTS_QUANT_PROBE": "1"},
                 {"optim_kernel": False, "kernel_tile": 0, "dist_path": "ring_blocked_sim",
                  "wire_dtype": "bf16"}, "runs:wire.payload/l0",
                 id="env7-kw7-distributed trainer"),
    ({}, {"optim_kernel": False, "comm_layer": "mirror", "mesh": "2,2"}, "ring-only"),
    ({}, {"comm_layer": "ring"}, "all_gather family"),
    ({}, {"sublinear": True}, "SUBLINEAR"),
])
def test_dist_trainer_refusals(cora, monkeypatch, tmp_path, caplog, env, kw, match):
    """The funnel's refusals; a ``runs:`` case (a switch an earlier slice
    refused) trains two epochs and must leave its report line or record."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(kw)
    algorithm = kw.pop("algorithm", "GCNDIST")
    if not match.startswith("runs:"):
        with pytest.raises(ValueError, match=match):
            _port(cora, algorithm, "ell", **kw)
        return
    import logging

    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="nts_torch"):
            tr = _port(cora, algorithm, "ell", epochs=2, **kw)
            tr.run()
    finally:
        lg.removeHandler(caplog.handler)
    assert np.isfinite(tr.loss_history[-1])
    with open(glob.glob(str(tmp_path / "*.jsonl"))[0]) as fh:
        names = [r.get("name") for r in map(json.loads, fh) if r["event"] == "tensor_stats"]
    want = match[len("runs:"):]
    if want.startswith("#"):
        assert want in caplog.text and "#graph_time=" in caplog.text
    elif want == "tensor_stats":
        assert {"params/l0", "grads/l1", "acts/l0", "logits"} <= set(names)
    else:
        assert names.count(want) == 2
