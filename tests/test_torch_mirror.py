"""The port's uniform mirror exchange, its edge ops and the trainers over it
(GATDIST, GGCNDIST, TEST_GETDEP) against the JAX package's.

- Tables, bitwise: ``MirrorGraph`` and ``estimate_mb`` (P 1, 2, 4, 8) and
  ``chunk_edge_list`` at several targets, one below the hub's in-degree.
- Ops: every op of the uniform exchange (the mirror fetch, the masked
  scatters, softmax, sum, max and min, the two-input weighted sum with
  C = 1 and C = f, the weighted aggregation) and the fused ring (C = 1 and
  C = f), forward and backward, against ``jax.vjp`` of JAX's twins, f32,
  rtol 1e-5 and atol 1e-6 (the sums add in other orders).
- The chunked chain equals the whole chain on every rank, forward and
  gradients, at every chunk target (a hub longer than the target widens
  its chunk).
- ``TEST_GETDEP`` passes on the twin, and its mirror rows equal JAX's.
- Trainers: 20-epoch f32 loss curves (drop 0) from JAX's initial
  parameters within 1e-4 of JAX's twins for GATDIST and GGCNDIST, with the
  wire gauges equal; GATDIST and GGCNDIST fused on ``ring_blocked_sim``
  held against the port's chain at rtol 2e-3 and atol 2e-4 (the bound of
  JAX's ``test_dist_sim_fused_matches_eager_mirror``); bf16 tracks f32
  under the bound of JAX's ``test_dist_gat_bf16_tracks_f32``; JAX's npz
  checkpoints load into the port and the port's into JAX.
- Ranks: one spawn of 4 gloo ranks (``tools/dist_parity``, started before
  the first test): TEST_GETDEP passing with every rank's mirror rows
  bitwise the twin's, and GATDIST on the chunked chain (at least 2 chunks
  per rank), GGCNDIST, GATDIST fused on ``ring_blocked`` and GCNDISTCACHE
  with ``PROC_REP:1 CACHE_REFRESH:2`` within 1e-5 of the twin, dropout 0.5.
- The registry resolves every ALGORITHM JAX registers; the CLI trains the
  new trainers on the CPU; the refusals.

JAX builds its host graphs with NumPy; its runs are cached at module
scope; torch runs on one thread.
"""

from __future__ import annotations

import glob
import json
import logging
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
from neutronstarlite_tpu.models import base as j_base
from neutronstarlite_tpu.models.base import get_algorithm as j_get_algorithm
from neutronstarlite_tpu.parallel import dist_edge_ops as j_edge
from neutronstarlite_tpu.parallel import dist_fused_edge as j_fused
from neutronstarlite_tpu.parallel import mirror as j_mirror
from neutronstarlite_tpu.parallel.dist_graph import DistGraph as JDistGraph
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.gat_dist import DistGATTrainer
from neutronstarlite_torch.models.ggcn_dist import DistGGCNTrainer
from neutronstarlite_torch.parallel import dist_edge_ops as t_edge
from neutronstarlite_torch.parallel import dist_fused_edge as t_fused
from neutronstarlite_torch.parallel import mirror as t_mirror
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.utils import config as t_config
from neutronstarlite_torch.utils import tree as t_tree
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 20
P_TRAIN = 4
SIM_TOL = dict(rtol=1e-5, atol=1e-6)
CURVE_TOL = 1e-4
FUSED_TOL = dict(rtol=2e-3, atol=2e-4)
WIRE = ("wire.comm_layer", "wire.rows_per_layer", "wire.bytes_per_epoch_fwd",
        "wire.simulated", "kernel.path", "kernel.edge_hbm_bytes_per_epoch")
ENV = ("NTS_PALLAS_RESIDENT", "NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_ELASTIC", "NTS_WIRE_DTYPE",
       "NTS_MESH", "NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_QUANT_PROBE", "NTS_OVERLAP_PROBE",
       "NTS_ELL_LEVELS", "NTS_DIST_SIMULATE", "NTS_TUNE", "NTS_EDGE_CHUNK")
# the gloo leg: the uniform mirror family's five routes
GLOO_ROUTES = ("getdep", "mirror:GATDIST", "mirror:GGCNDIST", "fused_ring:GATDIST",
               "depcache")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def background():
    """The 4 gloo ranks (``tools/dist_parity``), started before the first
    test so that they run beside the in-process ones: widths 31-15-7,
    dropout 0.5, 3 epochs, NTS_EDGE_CHUNK 256 (5 chunks per rank)."""
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=REPO, NTS_PROGRAM_COST="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "neutronstarlite_torch.tools.dist_parity", "--partitions",
         "4", "--device", "cpu", "--routes", ",".join(GLOO_ROUTES), "--vertices", "400",
         "--edges", "4000", "--layers", "31-15-7", "--epochs", "3", "--atol", "1e-5",
         "--edge-chunk", "256", "--timeout", "80"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True)
def _env(monkeypatch, background):
    """The twin, JAX's NumPy table fills; every other switch unset."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def _graphs(src, dst, v_num, weight="ones"):
    return (j_build_graph(src, dst, v_num, weight=weight, use_native=False),
            build_graph(src, dst, v_num, weight=weight, use_native=False))


@pytest.fixture(scope="module")
def tiny():
    """A random multigraph with self loops and a hub (vertex 5: in- and
    out-degree 200), unit weights."""
    rng = np.random.default_rng(3)
    v_num = 300
    src = rng.integers(0, v_num, size=2400, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=2400, dtype=np.uint32)
    many = rng.integers(0, v_num, size=200, dtype=np.uint32)
    loops = np.arange(v_num, dtype=np.uint32)
    src = np.concatenate([src, many, np.full(200, 5, np.uint32), loops])
    dst = np.concatenate([dst, np.full(200, 5, np.uint32), many, loops])
    return _graphs(src, dst, v_num)


@pytest.fixture(scope="module")
def cora():
    src, dst = j_load_edges(EDGES)
    return (src, dst) + _graphs(src, dst, V)


# ---- tables, bitwise --------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_mirror_graph_is_bitwise_jax(tiny, cora, P):
    for jg, tg in (tiny, cora[2:]):
        assert t_mirror.MirrorGraph.estimate_mb(tg, P) == \
            j_mirror.MirrorGraph.estimate_mb(jg, P)
        j, t = j_mirror.MirrorGraph.build(jg, P), t_mirror.MirrorGraph.build(tg, P)
        assert (t.partitions, t.vp, t.mb, t.e_num, t.v_num, t.el) == \
            (j.partitions, j.vp, j.mb, j.e_num, j.v_num, j.el)
        for name in ("offsets", "need_ids", "edge_src_slot", "edge_dst", "edge_weight",
                     "edge_mask"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert np.array_equal(t.valid_mask(), j.valid_mask())


@pytest.mark.parametrize("ec", [1, 16, 120, 4096])
def test_chunk_edge_list_is_bitwise_jax(tiny, ec):
    jg, tg = tiny
    j = j_mirror.chunk_edge_list(j_mirror.MirrorGraph.build(jg, 4), ec)
    t = t_mirror.chunk_edge_list(t_mirror.MirrorGraph.build(tg, 4), ec)
    assert t.dp == j.dp
    for name in ("slot", "dstl", "dstr", "mask", "base"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if ec < 200:  # the hub's 201 in-edges stay in one widened chunk
        assert t.slot.shape[2] >= 201 and t.n_chunks > 1


# ---- the ops against JAX's twins ------------------------------------------------------


def _vjp(fn, args, cot):
    @jax.jit
    def both(c, *a):
        y, vjp = jax.vjp(fn, *a)
        return (y,) + tuple(vjp(c))

    return [np.asarray(t) for t in both(jnp.asarray(cot), *[jnp.asarray(a) for a in args])]


def _port_vjp(fn, args, cot):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*ts)
    y.backward(torch.from_numpy(cot))
    return [y.detach().numpy()] + [t.grad.numpy() for t in ts]


def _assert_all_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **SIM_TOL)


def _rig(tiny, P):
    jg, tg = tiny
    jm, tm = j_mirror.MirrorGraph.build(jg, P), t_mirror.MirrorGraph.build(tg, P)
    return jm, tm, t_edge.UniformMirror(tm, None)


OPS = ("dep_nbr", "scatter_src", "scatter_dst", "softmax", "sum", "max", "min",
       "fuse_weight_1", "fuse_weight_f", "gather_mirror")


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_uniform_ops_match_jax_twins(tiny, P, op):
    jm, tm, ex = _rig(tiny, P)
    rng = np.random.default_rng(P * 10 + OPS.index(op))
    f, El, mb, vp = 6, tm.el, tm.mb, tm.vp

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, mir, ev = arr(P * vp, f), arr(P, P * mb, f), arr(P, El, f)
    if op == "dep_nbr":
        jfn = lambda a: j_edge.dist_get_dep_nbr_sim(jm, a)  # noqa: E731
        tfn = lambda a: t_edge.dist_get_dep_nbr(ex, a).reshape(P, P * mb, f)  # noqa: E731
        args, out = (x,), (P, P * mb, f)
    elif op == "scatter_src":
        jfn = lambda m: j_edge.dist_scatter_src_sim(jm, m)  # noqa: E731
        tfn = lambda m: t_edge.dist_scatter_src(ex, m.reshape(-1, f)).reshape(P, El, f)  # noqa: E731
        args, out = (mir,), (P, El, f)
    elif op == "scatter_dst":
        jfn = lambda a: j_edge.dist_scatter_dst_sim(jm, a)  # noqa: E731
        tfn = lambda a: t_edge.dist_scatter_dst(ex, a).reshape(P, El, f)  # noqa: E731
        args, out = (x,), (P, El, f)
    elif op == "softmax":
        jfn = lambda s: j_edge.dist_edge_softmax_sim(jm, s)  # noqa: E731
        tfn = lambda s: t_edge.dist_edge_softmax(ex, s.reshape(-1, f)).reshape(P, El, f)  # noqa: E731
        args, out = (ev * 3,), (P, El, f)
    elif op in ("sum", "max", "min"):
        jfn = {"sum": j_edge.dist_aggregate_dst_sim, "max": j_edge.dist_aggregate_dst_max_sim,
               "min": j_edge.dist_aggregate_dst_min_sim}[op]
        tfn0 = {"sum": t_edge.dist_aggregate_dst, "max": t_edge.dist_aggregate_dst_max,
                "min": t_edge.dist_aggregate_dst_min}[op]
        jfn = (lambda fn: lambda e: fn(jm, e))(jfn)
        tfn = lambda e: tfn0(ex, e.reshape(-1, f))  # noqa: E731
        args, out = (ev,), (P * vp, f)
    elif op.startswith("fuse_weight"):
        w = np.abs(arr(P, El, 1 if op.endswith("1") else f))
        jfn = lambda a, m: j_edge.dist_aggregate_dst_fuse_weight_sim(jm, a, m)  # noqa: E731
        tfn = lambda a, m: t_edge.dist_aggregate_dst_fuse_weight(  # noqa: E731
            ex, a.reshape(P * El, -1), m.reshape(-1, f))
        args, out = (w, mir), (P * vp, f)
    else:
        jfn = lambda a: j_edge.dist_gather_dst_from_src_mirror_sim(jm, a)  # noqa: E731
        tfn = lambda a: t_edge.dist_gather_dst_from_src_mirror(ex, a)  # noqa: E731
        args, out = (x,), (P * vp, f)
    cot = arr(*out)
    want = _vjp(jfn, args, cot)
    got = _port_vjp(tfn, args, cot)
    _assert_all_close(got, want)
    if op == "softmax":  # a padded slot weighs 0 and passes no gradient
        pad = tm.edge_mask.reshape(P, El) == 0
        assert pad.any() and not got[0][pad].any() and not got[1][pad].any()


@pytest.mark.parametrize("channels", ["1", "f"])
def test_fused_ring_twin_matches_jax(tiny, channels):
    P, f = 2, 5
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    vt = td.vp // 2  # two source tiles per step table (JAX's twin unrolls every tile)
    jp = j_fused.RingFusedEdgePair.build(jd, vt)
    tp = t_fused.RingFusedEdgePair.build(td, vt, range(P))
    c = 1 if channels == "1" else f
    rng = np.random.default_rng(c)
    h, a_s, a_d = (rng.standard_normal((P * td.vp, w)).astype(np.float32)
                   for w in (f, c, c))
    cot = rng.standard_normal((P * td.vp, f)).astype(np.float32)
    want = _vjp(lambda *t: j_fused.dist_fused_edge_aggregate(None, jp, *t, 0.2),
                (h, a_s, a_d), cot)
    got = _port_vjp(lambda *t: t_fused.dist_fused_edge_aggregate(tp, None, *t, 0.2),
                    (h, a_s, a_d), cot)
    _assert_all_close(got, want)
    assert t_fused.fused_wire_cols(f, c) == j_fused.fused_wire_cols(f, c)


@pytest.mark.parametrize("ec", [1, 16, 150, 100_000])
def test_chunked_chain_equals_the_whole_chain(tiny, ec):
    """Per rank, GGCN's chain (C = f) chunked at ``ec`` against the whole
    chain over the rank's edge list: forward and the gradients of the
    mirror rows and of the destination half."""
    P, f = 4, 5
    _, tm, _ = _rig(tiny, P)
    ch = t_mirror.chunk_edge_list(tm, ec)
    rng = np.random.default_rng(ec)
    for p in range(P):
        mir = rng.standard_normal((P * tm.mb, 2 * f)).astype(np.float32)
        hd = rng.standard_normal((tm.vp, f)).astype(np.float32)
        cot = rng.standard_normal((tm.vp, f)).astype(np.float32)
        whole = _port_vjp(lambda m, d: t_edge.gated_chain_body(
            t_edge.EdgeLists.of_rank(tm, p), m, d, f, 0.2), (mir, hd), cot)
        chunked = _port_vjp(lambda m, d: t_edge.gated_chain_chunked_body(
            t_edge.ChunkTables.of_rank(ch, p), tm.vp, m, d, f, 0.2), (mir, hd), cot)
        _assert_all_close(chunked, whole)


def test_getdep_passes_and_its_mirrors_are_jax_s(cora):
    src, dst, jg, tg = cora
    cfg = _cfg(InputInfo, "TEST_GETDEP")
    tr = get_algorithm("TEST_GETDEP").from_arrays(cfg, src, dst, _data(GNNDatum),
                                                  device="cpu", host_graph=tg)
    out = tr.run()
    assert out == {"pass": True, "fwd_err": 0.0, "bwd_err": 0.0, "partitions": P_TRAIN}
    jm = j_mirror.MirrorGraph.build(jg, P_TRAIN)
    ids = jm.pad_vertex_array(np.arange(V, dtype=np.float32)[:, None].repeat(4, axis=1))
    want = np.asarray(j_edge.dist_get_dep_nbr_sim(jm, jnp.asarray(ids)))
    assert np.array_equal(tr.mirrors.numpy().reshape(want.shape), want)


# ---- the trainers against JAX -------------------------------------------------------


def _cfg(cls, algorithm, P=P_TRAIN, **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = EPOCHS
    cfg.decay_epoch = 10  # the stepped decay fires in 20 epochs
    cfg.drop_rate = 0.0
    cfg.partitions = P
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"), V, F,
        seed=0)


@pytest.fixture(scope="module")
def jax_runs(cora, tmp_path_factory):
    """JAX's twin trainer from its own init, 20 epochs with a checkpoint
    at the end: (initial params, losses, gauges, trainer, checkpoint dir)."""
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            src, dst, jg, _ = cora
            ck = str(tmp_path_factory.mktemp(f"jax-{algorithm}"))
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NTS_DIST_SIMULATE", "1")
                mp.setenv("NTS_FINAL_EVAL", "0")
                tr = j_get_algorithm(algorithm).from_arrays(
                    _cfg(JInfo, algorithm, checkpoint_dir=ck), src, dst, _data(JDatum),
                    host_graph=jg)
                p0 = jax.tree.map(np.asarray, tr.params)
                tr.run()
            cache[algorithm] = (p0, np.asarray(tr.loss_history),
                                {k: tr.metrics._gauges.get(k) for k in WIRE}, tr, ck)
        return cache[algorithm]

    return get


def _port(cora, algorithm, p0=None, **kw):
    src, dst, _, tg = cora
    tr = get_algorithm(algorithm).from_arrays(_cfg(InputInfo, algorithm, **kw), src, dst,
                                              _data(GNNDatum), device="cpu", host_graph=tg)
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


@pytest.fixture(scope="module")
def port_chains(cora, jax_runs):
    """The port's chain curves from JAX's initial parameters."""
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NTS_DIST_SIMULATE", "1")
                tr = _port(cora, algorithm, jax_runs(algorithm)[0])
                tr.run()
            cache[algorithm] = tr
        return cache[algorithm]

    return get


@pytest.mark.parametrize("algorithm,cls", [("GATDIST", DistGATTrainer),
                                           ("GGCNDIST", DistGGCNTrainer)])
def test_sim_trainer_curve_matches_jax(jax_runs, port_chains, algorithm, cls):
    _, j_losses, j_gauges, _, _ = jax_runs(algorithm)
    tr = port_chains(algorithm)
    assert type(tr) is cls and tr.group is None
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=CURVE_TOL)
    assert {k: tr.metrics._gauges.get(k) for k in WIRE} == j_gauges
    assert tr.metrics._counters["wire.bytes_fwd"] == \
        EPOCHS * j_gauges["wire.bytes_per_epoch_fwd"]


@pytest.mark.parametrize("algorithm", ["GATDIST", "GGCNDIST"])
def test_fused_ring_trainer_matches_the_chain(cora, jax_runs, port_chains, algorithm):
    tr = _port(cora, algorithm, jax_runs(algorithm)[0], kernel="fused_edge",
               dist_path="ring_blocked_sim")
    assert isinstance(tr.compute_graph, __import__(
        "neutronstarlite_torch.models.gat_dist", fromlist=["FusedRing"]).FusedRing)
    tr.run()
    np.testing.assert_allclose(tr.loss_history, port_chains(algorithm).loss_history,
                               **FUSED_TOL)
    g = tr.metrics._gauges
    assert g["kernel.edge_hbm_bytes_per_epoch"] == 0 and g["kernel.path"] == "fused_edge"
    assert g["wire.comm_layer"] == "ring_fused"
    c = 1 if algorithm == "GATDIST" else None
    cols = sum(t_fused.fused_wire_cols(w, c or w)["fwd"] for w in (H, C))
    assert g["wire.bytes_per_epoch_fwd"] == (P_TRAIN - 1) * tr.dist.vp * cols * 4


def test_bf16_tracks_f32():
    """JAX's ``test_dist_gat_bf16_tracks_f32`` on the port: a planted
    partition graph, 10 epochs at P=4; the bf16 run against the port's f32
    run (the reference sums the softmax denominator in bf16, the port in
    f32 everywhere)."""
    from neutronstarlite_tpu.graph.synthetic import planted_partition_graph

    v_num, classes, f = 96, 3, 8
    src, dst, feature, label = planted_partition_graph(v_num, classes, avg_degree=10,
                                                       feature_size=f, seed=17)
    datum = GNNDatum(feature=feature, label=label.astype(np.int32),
                     mask=(np.arange(v_num) % 3).astype(np.int32))

    def run(precision):
        cfg = InputInfo(vertices=v_num, layer_string=f"{f}-10-{classes}", epochs=10,
                        learn_rate=0.02, drop_rate=0.0, decay_epoch=-1, partitions=4,
                        precision=precision, algorithm="GATDIST")
        tr = DistGATTrainer.from_arrays(cfg, src, dst, datum, device="cpu")
        return tr.run(), tr

    out32, _ = run("float32")
    out16, tr16 = run("bfloat16")
    assert np.isfinite(out16["loss"])
    np.testing.assert_allclose(out16["loss"], out32["loss"], rtol=0.05, atol=0.02)
    assert out16["acc"]["train"] >= out32["acc"]["train"] - 0.05
    assert tr16.metrics._gauges["wire.bytes_per_epoch_fwd"] * 2 == \
        (P_TRAIN - 1) * tr16.dist.mb * (11 + 4) * 4


def _named(state) -> dict:
    return {name + path: (leaf.detach().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for name, tree in state.items() for path, leaf in t_tree.flatten_with_path(tree)}


def _jax_named(state) -> dict:
    return {name + jax.tree_util.keystr(path): np.asarray(leaf)
            for name, tree in state.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("algorithm", ["GATDIST", "GGCNDIST"])
def test_checkpoints_cross_between_the_packages(cora, jax_runs, tmp_path, algorithm):
    """JAX's final checkpoint restores into the port bitwise; the port's
    restores into JAX's trainer bitwise."""
    _, _, _, jtr, ck = jax_runs(algorithm)
    want = _jax_named(jtr.checkpoint_state())
    tr = _port(cora, algorithm)
    assert tr.restore(ck) == EPOCHS
    got = _named(tr.checkpoint_state())
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    mine = str(tmp_path / "ck")
    tr.save(mine, EPOCHS + 1)
    assert jtr.restore(mine) == EPOCHS + 1
    back = _jax_named(jtr.checkpoint_state())
    for k in want:
        assert np.array_equal(back[k], got[k]), k


# ---- registry, CLI, refusals --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(j_base._REGISTRY))
def test_registry_resolves_every_jax_algorithm(name):
    cls = get_algorithm(name)
    assert cls.__name__.replace("Trainer", "") in (
        j_base._REGISTRY[name].__name__.replace("Trainer", ""),
        "GetDepNbrCheck") or name in t_config.SUPPORTED_ALGORITHMS
    assert name in t_config.SUPPORTED_ALGORITHMS


@pytest.mark.parametrize("algorithm,extra", [
    ("GATDIST", ""), ("GGCNCPUDIST", ""), ("GATDIST", "KERNEL:fused_edge\n"),
    ("TEST_GETDEP", ""),
])
def test_cli_trains_on_the_cpu(tmp_path, monkeypatch, algorithm, extra):
    from neutronstarlite_torch import run

    cfg = tmp_path / "x.cfg"
    cfg.write_text(
        f"ALGORITHM:{algorithm}\nVERTICES:{V}\nLAYERS:{F}-16-{C}\nEPOCHS:2\n"
        f"EDGE_FILE:{EDGES}\nLABEL_FILE:{FIX}/cora.labeltable\nMASK_FILE:{FIX}/cora.mask\n"
        f"PARTITIONS:2\nDROP_RATE:0.5\n{extra}")
    seen = {}
    original = run.supervised_run

    def spy(toolkit, *a, **k):
        seen["tr"] = toolkit
        seen["out"] = original(toolkit, *a, **k)
        return seen["out"]

    monkeypatch.setattr(run, "supervised_run", spy)
    assert run.main([str(cfg), "--device", "cpu"]) == 0
    out = seen["out"]
    if algorithm == "TEST_GETDEP":
        assert out["pass"]
    else:
        assert len(seen["tr"].loss_history) == 2 and np.isfinite(out["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([str(cfg)])


@pytest.mark.parametrize("kw,env,match", [
    (dict(mesh="2,2"), {}, "MESH"),
    (dict(dist_path="ring_blocked"), {}, "DIST_PATH"),
    (dict(kernel="fused_edge", dist_path="all_gather"), {}, "ring schedule"),
    (dict(comm_layer="ring"), {}, "uniform mirror"),
    (dict(kernel_tile=256), {}, "KERNEL_TILE"),
    # NTS_DEBUGINFO now runs on GATDIST (below); the switch of the plane that
    # GATDIST refuses, as JAX does, is NTS_ELASTIC
    pytest.param({}, {"NTS_ELASTIC": "1"}, "NTS_ELASTIC=1 is not available",
                 id="kw5-env5-distributed trainer"),
    ({}, {"NTS_DIST_SIMULATE": "0"}, "NTS_DIST_SIMULATE=1"),
])
def test_edge_family_refusals(cora, monkeypatch, kw, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        _port(cora, "GATDIST", **kw)


@pytest.mark.parametrize("algorithm", ["GATDIST", "GGCNDIST"])
def test_edge_family_debuginfo_and_numerics_as_jax(cora, monkeypatch, tmp_path, caplog,
                                                   algorithm):
    """JAX's edge-family dist trainers print the DEBUGINFO report with the
    nn / graph split (the nn-only forward: a zero aggregate per layer) and
    run no stats step: NTS_NUMERICS and NTS_QUANT_PROBE leave no record."""
    for k in ("NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_QUANT_PROBE"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="nts_torch"):
            tr = _port(cora, algorithm, epochs=2)
            tr.run()
    finally:
        lg.removeHandler(caplog.handler)
    for key in ("#nn_time=", "#graph_time=", "#forward_time=", "#backward_time=",
                "#update_time=", "#all_train_step_time="):
        assert key in caplog.text
    with open(glob.glob(str(tmp_path / "*.jsonl"))[0]) as fh:
        kinds = {json.loads(line)["event"] for line in fh if line.strip()}
    assert "epoch" in kinds and "tensor_stats" not in kinds
    assert tr.numerics_replay(0) is None  # no layer taps: the provenance is unattributed


def test_optim_kernel_is_ignored_with_a_warning(cora, caplog):
    """The reference's GAT dist cfgs set OPTIM_KERNEL:1, which JAX
    ignores: the port warns and runs the chain."""
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="nts_torch"):
            tr = _port(cora, "GATDIST", epochs=1, optim_kernel=True)
    finally:
        lg.removeHandler(caplog.handler)
    assert "ignores them, as JAX does" in caplog.text
    assert isinstance(tr.compute_graph, t_edge.UniformMirror)


def test_wire_dtype_is_ignored_on_the_fused_ring(cora, monkeypatch, caplog):
    monkeypatch.setenv("NTS_WIRE_DTYPE", "bf16")
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="nts_torch"):
            tr = _port(cora, "GATDIST", epochs=1, kernel="fused_edge",
                       dist_path="ring_blocked_sim")
    finally:
        lg.removeHandler(caplog.handler)
    assert "ignored by the fused edge ring" in caplog.text
    assert tr.group is None and tr.comm_layer == "ring_fused"


# ---- gloo: four ranks against the twin -----------------------------------------------


def test_four_gloo_ranks_match_the_twin(background):
    """tools/dist_parity at P=4 over gloo on 127.0.0.1 (limit 90 s)."""
    out, err = background.communicate(timeout=90)
    assert background.returncode == 0, (out[-2000:], err[-3000:])
    report = json.loads(out.strip().splitlines()[-1])
    assert report["ok"] and report["partitions"] == 4
    getdep = report["routes"]["getdep"]
    assert getdep["exchange_bitwise"] and getdep["rank0"]["pass"]
    assert getdep["fwd_err"] == 0.0 and getdep["bwd_err"] == 0.0
    for route in GLOO_ROUTES[1:]:
        r = report["routes"][route]
        assert r["max_loss_gap"] <= 1e-5, (route, r["max_loss_gap"])
        assert r["rank0"]["rows"] == r["twin"]["vp"] and len(r["rank0"]["losses"]) == 3
        if route != "depcache":  # 3 epochs of dropout 0.5 need not fall there
            assert r["twin"]["losses"][-1] < r["twin"]["losses"][0]
    assert report["routes"]["mirror:GATDIST"]["rank0"]["chunks"] >= 2
    assert report["routes"]["fused_ring:GATDIST"]["rank0"]["tables"] == "FusedRing"
