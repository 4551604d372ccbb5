"""The port's DepCache (hot mirror rows replicated and cached) and the
GCNDISTCACHE trainer against the JAX package's.

- ``CachedMirrorGraph`` is bitwise JAX's at P 2 and 4 over thresholds from
  0 (every slot hot) to above the largest out-degree (none),
  ``choose_replication_threshold`` picks JAX's threshold over a range of
  budgets, and ``replicate_rows`` fills JAX's cache.
- The partial fetch (cold rows exchanged, hot rows spliced in with no
  gradient) and the refresh fetch match JAX's twins, forward and
  backward (``jax.vjp``), f32, rtol 1e-5 and atol 1e-6.
- 20-epoch f32 loss curves (drop 0) from JAX's initial parameters within
  1e-4 of JAX's twin for PROC_REP 0, a fixed threshold, ``auto`` (a 1 MiB
  budget, so the choice is not trivial) and CACHE_REFRESH:3, with the wire
  gauges and counters equal and the refresh on JAX's epochs.
- JAX's npz checkpoint loads into the port and the port's into JAX; the
  CLI trains on the CPU; the cfg keys parse, and are refused on the other
  trainers; PRECISION:bfloat16 warns and runs f32.

The 4-rank gloo leg of this trainer is in ``test_torch_mirror.py``.
"""

from __future__ import annotations

import logging
import os

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
from neutronstarlite_tpu.parallel import feature_cache as j_fc
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.gcn_dist_cache import DistGCNCacheTrainer
from neutronstarlite_torch.parallel import feature_cache as t_fc
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
WIRE = ("wire.comm_layer", "wire.rows_per_layer_full", "wire.rows_per_layer_partial",
        "wire.simulated")
ENV = ("NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_ELASTIC", "NTS_WIRE_DTYPE", "NTS_MESH",
       "NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_QUANT_PROBE", "NTS_DIST_SIMULATE")
# the curves held against JAX: cfg fields per name
RUNS = {
    "comm": {},
    "fixed": dict(process_rep=True, rep_threshold=4),
    "auto": dict(process_rep=True, rep_threshold=-1, cache_budget_mib=1),
    "refresh3": dict(process_rep=True, rep_threshold=4, cache_refresh=3),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


@pytest.fixture(scope="module")
def cora():
    src, dst = j_load_edges(EDGES)
    return (src, dst, j_build_graph(src, dst, V, use_native=False), build_graph(src, dst, V, use_native=False))


@pytest.fixture(scope="module")
def tiny():
    """A random multigraph with self loops and a hub (vertex 5)."""
    rng = np.random.default_rng(5)
    v_num = 200
    src = rng.integers(0, v_num, size=1500, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=1500, dtype=np.uint32)
    many = rng.integers(0, v_num, size=120, dtype=np.uint32)
    loops = np.arange(v_num, dtype=np.uint32)
    src = np.concatenate([src, np.full(120, 5, np.uint32), loops])
    dst = np.concatenate([dst, many, loops])
    return j_build_graph(src, dst, v_num, use_native=False), build_graph(src, dst, v_num, use_native=False)


# ---- tables, bitwise --------------------------------------------------------------

FIELDS = ("offsets", "need_ids", "edge_src_slot", "edge_dst", "edge_weight", "edge_mask",
          "cached_global", "cached_ids", "fetch_ids", "fetch_real")


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("threshold", [0, 3, 10, 1000])
def test_cached_mirror_graph_is_bitwise_jax(tiny, P, threshold):
    jg, tg = tiny
    j = j_fc.CachedMirrorGraph.build(jg, P, threshold)
    t = t_fc.CachedMirrorGraph.build(tg, P, threshold)
    assert (t.vp, t.mb, t.mc, t.mf, t.el, t.replication_threshold) == \
        (j.vp, j.mb, j.mc, j.mf, j.el, j.replication_threshold)
    for name in FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert t.cached_fraction == j.cached_fraction
    x = np.random.default_rng(P).standard_normal((tg.v_num, 3)).astype(np.float32)
    assert np.array_equal(t.replicate_rows(x), j.replicate_rows(x))
    assert np.array_equal(t_fc.hot_vertex_mask(tg, threshold),
                          j_fc.hot_vertex_mask(jg, threshold))


@pytest.mark.parametrize("budget", [0, 4096, 60_000, 1 << 20, 1 << 30])
def test_choose_replication_threshold_is_jax_s(tiny, cora, budget):
    for jg, tg in (tiny, cora[2:]):
        for P, f in ((2, 16), (4, 96)):
            assert t_fc.CachedMirrorGraph.choose_replication_threshold(tg, P, f, budget) == \
                j_fc.CachedMirrorGraph.choose_replication_threshold(jg, P, f, budget)


# ---- the exchanges against JAX's twins ----------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_partial_and_refresh_fetches_match_jax_twins(tiny, P):
    jg, tg = tiny
    j = j_fc.CachedMirrorGraph.build(jg, P, 10)
    t = t_fc.CachedMirrorGraph.build(tg, P, 10)
    assert 0 < t.mc and 0 < t.cached_fraction < 1
    ce = t_fc.CacheExchange(t, None)
    rng = np.random.default_rng(P)
    f = 5
    x = rng.standard_normal((P * t.vp, f)).astype(np.float32)
    cached = rng.standard_normal((P, P * t.mc, f)).astype(np.float32)
    cot = rng.standard_normal((P, P * t.mb, f)).astype(np.float32)

    @jax.jit
    def jax_side(xa, ca, co):
        y, vjp = jax.vjp(lambda a, c: j_fc.dist_get_dep_nbr_partial_sim(j, a, c), xa, ca)
        gx, gc = vjp(co)
        return y, gx, gc, j_fc.dist_fetch_cached_rows_sim(j, xa)

    want = [np.asarray(a) for a in jax_side(jnp.asarray(x), jnp.asarray(cached),
                                            jnp.asarray(cot))]
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cached.reshape(-1, f)).requires_grad_(True)
    y = t_fc.dist_get_dep_nbr_partial(ce, xt, ct)
    y.backward(torch.from_numpy(cot.reshape(-1, f)))
    assert ct.grad is None and not want[2].any()  # the cached rows pass no gradient
    np.testing.assert_allclose(y.detach().numpy().reshape(want[0].shape), want[0], **SIM_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want[1], **SIM_TOL)
    fresh = t_fc.dist_fetch_cached_rows(ce, torch.from_numpy(x)).numpy()
    assert np.array_equal(fresh.reshape(want[3].shape), want[3])
    # the refresh of raw features is the replica
    assert np.array_equal(
        fresh.reshape(P, P * t.mc, f)[t.cached_global.reshape(P, -1) >= 0],
        t.replicate_rows(t.unpad_vertex_array(x))[t.cached_global.reshape(P, -1) >= 0])


# ---- the trainer against JAX ---------------------------------------------------------


def _cfg(cls, P=P_TRAIN, **kw):
    cfg = cls()
    cfg.algorithm = "GCNDISTCACHE"
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = EPOCHS
    cfg.decay_epoch = 10
    cfg.drop_rate = 0.0
    cfg.partitions = P
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"), V, F,
        seed=0)


def _record_flags(tr):
    """Keep the ``cache_refresh`` field of every epoch record the trainer
    writes in ``tr.flags``."""
    tr.flags = []
    write = tr.metrics.epoch_event

    def spy(epoch, seconds, loss=None, **extra):
        tr.flags.append(bool(extra.get("cache_refresh")))
        return write(epoch, seconds, loss, **extra)

    tr.metrics.epoch_event = spy
    return tr


@pytest.fixture(scope="module")
def jax_runs(cora, tmp_path_factory):
    """JAX's twin from its own init: (initial params, losses, gauges,
    counters, trainer, checkpoint dir)."""
    cache = {}

    def get(name):
        if name not in cache:
            src, dst, jg, _ = cora
            ck = str(tmp_path_factory.mktemp(f"jax-{name}"))
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NTS_DIST_SIMULATE", "1")
                mp.setenv("NTS_FINAL_EVAL", "0")
                tr = j_get_algorithm("GCNDISTCACHE").from_arrays(
                    _cfg(JInfo, checkpoint_dir=ck, **RUNS[name]), src, dst, _data(JDatum),
                    host_graph=jg)
                p0 = jax.tree.map(np.asarray, tr.params)
                tr.run()
            m = tr.metrics
            cache[name] = (p0, np.asarray(tr.loss_history),
                           {k: m._gauges.get(k) for k in WIRE},
                           {k: m._counters.get(k) for k in ("wire.bytes_fwd",
                                                            "wire.exchanges")}, tr, ck)
        return cache[name]

    return get


def _port(cora, p0=None, **kw):
    src, dst, _, tg = cora
    tr = get_algorithm("GCNDISTCACHE").from_arrays(_cfg(InputInfo, **kw), src, dst,
                                                   _data(GNNDatum), device="cpu",
                                                   host_graph=tg)
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


@pytest.mark.parametrize("name", list(RUNS))
def test_sim_trainer_curve_matches_jax(cora, jax_runs, name):
    p0, j_losses, j_gauges, j_counters, jtr, _ = jax_runs(name)
    tr = _record_flags(_port(cora, p0, **RUNS[name]))
    assert isinstance(tr, DistGCNCacheTrainer) and tr.group is None
    assert (tr.dist.mc, tr.dist.mf, tr.threshold) == (jtr.cmg.mc, jtr.cmg.mf,
                                                      jtr.cmg.replication_threshold)
    if name != "comm":
        assert 0 < tr.dist.cached_fraction < 1
    tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=CURVE_TOL)
    assert {k: tr.metrics._gauges.get(k) for k in WIRE} == j_gauges
    assert {k: tr.metrics._counters.get(k) for k in j_counters} == j_counters
    assert tr.flags == [name == "refresh3" and e % 3 == 0 for e in range(EPOCHS)]


def test_refresh_every_epoch_is_the_fresh_fetch(cora, jax_runs):
    """CACHE_REFRESH:1 keeps no historical cache: the hot threshold changes
    only the wire, so the curve is PROC_REP:0's."""
    p0 = jax_runs("comm")[0]
    a = _port(cora, p0, epochs=5)
    b = _port(cora, p0, epochs=5, **RUNS["fixed"])
    a.run()
    b.run()
    np.testing.assert_allclose(b.loss_history, a.loss_history, rtol=0, atol=1e-6)
    assert b.metrics._counters["wire.bytes_fwd"] < a.metrics._counters["wire.bytes_fwd"]


def _named(state) -> dict:
    return {name + path: (leaf.detach().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for name, tree in state.items() for path, leaf in t_tree.flatten_with_path(tree)}


def _jax_named(state) -> dict:
    return {name + jax.tree_util.keystr(path): np.asarray(leaf)
            for name, tree in state.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_checkpoints_cross_between_the_packages(cora, jax_runs, tmp_path):
    _, _, _, _, jtr, ck = jax_runs("refresh3")
    want = _jax_named(jtr.checkpoint_state())
    tr = _port(cora, **RUNS["refresh3"])
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


# ---- CLI, cfg, precision ------------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    from neutronstarlite_torch import run

    cfg = tmp_path / "x.cfg"
    cfg.write_text(
        f"ALGORITHM:GCNDISTCACHE\nVERTICES:{V}\nLAYERS:{F}-16-{C}\nEPOCHS:4\n"
        f"EDGE_FILE:{EDGES}\nLABEL_FILE:{FIX}/cora.labeltable\nMASK_FILE:{FIX}/cora.mask\n"
        "PARTITIONS:2\nPROC_REP:1\nREP_THRESHOLD:auto\nCACHE_BUDGET_MIB:1\n"
        "CACHE_REFRESH:2\n")
    seen = {}
    original = run.supervised_run

    def spy(toolkit, *a, **k):
        seen["tr"] = _record_flags(toolkit)
        return original(toolkit, *a, **k)

    monkeypatch.setattr(run, "supervised_run", spy)
    assert run.main([str(cfg), "--device", "cpu"]) == 0
    tr = seen["tr"]
    assert len(tr.loss_history) == 4 and np.isfinite(tr.loss_history).all()
    assert tr.dist.mc > 0 and tr.flags == [True, False, True, False]


@pytest.mark.parametrize("line,field,value", [
    ("PROC_REP:1", "process_rep", True), ("REP_THRESHOLD:auto", "rep_threshold", -1),
    ("REP_THRESHOLD:12", "rep_threshold", 12), ("CACHE_BUDGET_MIB:64", "cache_budget_mib", 64),
    ("CACHE_REFRESH:5", "cache_refresh", 5),
])
def test_cfg_parses_the_depcache_keys(tmp_path, line, field, value):
    p = tmp_path / "x.cfg"
    p.write_text(f"ALGORITHM:GCNDISTCACHE\nVERTICES:10\nLAYERS:4-2\nPARTITIONS:2\n{line}\n")
    assert getattr(t_config.InputInfo.read_from_cfg_file(str(p)), field) == value
    p.write_text(f"ALGORITHM:GCNDIST\nVERTICES:10\nLAYERS:4-2\nPARTITIONS:2\n{line}\n")
    with pytest.raises(ValueError, match="DepCache GCN"):
        t_config.InputInfo.read_from_cfg_file(str(p))


def test_bf16_warns_and_runs_f32(cora, jax_runs, caplog):
    p0 = jax_runs("comm")[0]
    a = _port(cora, p0, epochs=3, **RUNS["fixed"])
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="nts_torch"):
            b = _port(cora, p0, epochs=3, precision="bfloat16", **RUNS["fixed"])
    finally:
        lg.removeHandler(caplog.handler)
    assert "not implemented for the DepCache" in caplog.text
    a.run()
    b.run()
    assert a.loss_history == b.loss_history
    assert b.metrics._gauges["wire.rows_per_layer_full"] == \
        (P_TRAIN - 1) * b.dist.mb


def test_dist_plane_switches_as_jax(cora, monkeypatch, tmp_path, caplog):
    """JAX's DepCache trainer reads none of NTS_DEBUGINFO, NTS_NUMERICS and
    NTS_QUANT_PROBE (no report, no tensor_stats) and refuses NTS_ELASTIC at
    the funnel; the port's does the same."""
    import glob
    import json

    for k in ("NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_QUANT_PROBE"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    lg = logging.getLogger("nts_torch")
    lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="nts_torch"):
            tr = _port(cora, epochs=2, process_rep=True, rep_threshold=4)
            tr.run()
    finally:
        lg.removeHandler(caplog.handler)
    assert "DEBUGINFO" not in caplog.text and np.isfinite(tr.loss_history[-1])
    with open(glob.glob(str(tmp_path / "*.jsonl"))[0]) as fh:
        kinds = {json.loads(line)["event"] for line in fh if line.strip()}
    assert "epoch" in kinds and "tensor_stats" not in kinds
    assert tr.numerics_replay(0) is None
    monkeypatch.setenv("NTS_ELASTIC", "1")
    assert not getattr(j_get_algorithm("GCNDISTCACHE"), "supports_elastic", False)
    with pytest.raises(ValueError, match="NTS_ELASTIC=1 is not available"):
        _port(cora, epochs=1)
