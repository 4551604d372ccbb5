"""The port's live graph (``neutronstarlite_torch/serve/delta.py`` and the
engine, server, fleet and device-table paths under it) against the JAX
package's, on the CPU.

- Plans: the rebuilt CSC, both dirty sets, the counts and the post-delta
  digest bitwise JAX's ``plan_delta`` on the same graph and delta (edge
  churn, a multi-edge removal, a vertex append, the bitset closure hook);
  the refusals word for word.
- The device neighbour table after ``apply_delta``: bitwise a fresh
  ``from_host`` table over the post-delta graph and bitwise JAX's patched
  table, for a row patch, a margin append, a thinned table and the
  rebuilds; written in place wherever the shape holds.
- Serving: after a delta an engine (sync, device, fused) serves bitwise
  what a fresh port engine over the post-delta graph serves from one seed;
  a flush prepared before a delta answers pre-delta (engine level, and a
  pipelined server whose executor is held while the delta waits); the
  cache keeps its clean rows; a vertex append past the slab drops both
  ladders; the digest bump misses the tune cache; a fleet applies one plan
  to every replica; ``serve_bench --delta-rate`` runs on the CPU.

The serving tests restore the JAX package's npz checkpoint of
tests/test_torch_serve.py (its planted 300-vertex graph); torch runs on one
intra-op thread.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.sample import device_sampler as j_device_sampler
from neutronstarlite_tpu.serve import delta as j_delta
from neutronstarlite_tpu.stream.ingest import BitsetDirtyTracker as JBitset
from tests.test_torch_serve import (  # noqa: F401  (module fixtures)
    CLASSES,
    REPO,
    V,
    _opts,
    _serve_cfg,
    _smoke_cfg,
    jax_trained,
    planted,
)

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
from neutronstarlite_torch.sample import device_sampler as t_device_sampler
from neutronstarlite_torch.serve import batcher as t_batcher
from neutronstarlite_torch.serve import delta as t_delta
from neutronstarlite_torch.serve.delta import GraphDelta, plan_delta
from neutronstarlite_torch.serve.engine import InferenceEngine
from neutronstarlite_torch.serve.fleet import ReplicaSet
from neutronstarlite_torch.serve.server import InferenceServer
from neutronstarlite_torch.stream.ingest import BitsetDirtyTracker
from neutronstarlite_torch.utils.config import InputInfo

CSC_FIELDS = ("column_offset", "row_indices", "dst_of_edge", "edge_weight_forward",
              "row_offset", "column_indices", "src_of_edge", "edge_weight_backward",
              "out_degree", "in_degree")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("NTS_SERVE_", "NTS_STREAM_")) or k in (
                "NTS_SAMPLE_PIPELINE", "NTS_METRICS_PORT", "NTS_METRICS_DIR", "NTS_SLO_SPEC",
                "NTS_LEDGER_DIR", "NTS_NUMERICS", "NTS_SAMPLE_DEVICE_MAX_DEG", "NTS_TUNE_DIR"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")


def _rand_graphs(v=50, e=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.uint32)
    dst = rng.integers(0, v, e).astype(np.uint32)
    return src, dst, build_graph(src, dst, v, use_native=False), j_build_graph(src, dst, v, use_native=False)


def _deltas(src, dst, v):
    """(name, kwargs of GraphDelta.edges) against ``_rand_graphs``."""
    return {
        "churn": dict(add=[(3, 7), (49, 0), (10, 10)],
                      remove=[(int(src[0]), int(dst[0])), (int(src[5]), int(dst[5]))]),
        "add_only": dict(add=[(1, 2), (2, 1), (1, 2)]),
        "remove_only": dict(remove=[(int(src[9]), int(dst[9]))]),
        "append": dict(add=[(4, v), (v, 4), (v + 1, 0)], add_vertices=2,
                       add_features=np.ones((2, 3), np.float32)),
    }


def _assert_graphs_equal(a, b):
    assert (a.v_num, a.e_num) == (b.v_num, b.e_num)
    for field in CSC_FIELDS:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype and np.array_equal(x, y), field


# ---- plans -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["churn", "add_only", "remove_only", "append"])
@pytest.mark.parametrize("hops", [1, 2])
def test_plan_is_bitwise_jax(name, hops):
    src, dst, g, jg = _rand_graphs()
    kw = _deltas(src, dst, g.v_num)[name]
    t = plan_delta(g, GraphDelta.edges(**kw), hops=hops)
    j = j_delta.plan_delta(jg, j_delta.GraphDelta.edges(**kw), hops=hops)
    _assert_graphs_equal(t.graph, j.graph)
    assert t.digest == j.digest == graph_digest(t.graph) != graph_digest(g)
    for field in ("src", "dst", "dirty_rows", "dirty"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (t.v_num, t.added_edges, t.removed_edges, t.added_vertices, t.hops) == \
        (j.v_num, j.added_edges, j.removed_edges, j.added_vertices, j.hops)
    # the oracle's ground: the plan's graph is a fresh build of its edge list
    _assert_graphs_equal(t.graph, build_graph(t.src, t.dst, t.v_num, use_native=False))


@pytest.mark.parametrize("n_rm", [1, 50, 500])
def test_removal_mask_is_isin_both_ways(n_rm):
    """The binary-search removal mask equals ``np.isin`` in both directions
    (the reference's two calls), duplicates and absent keys included."""
    rng = np.random.default_rng(n_rm)
    keys = t_delta._edge_keys(rng.integers(0, 300, 5000), rng.integers(0, 300, 5000))
    rm = np.unique(np.concatenate([rng.choice(keys, n_rm),
                                   t_delta._edge_keys(rng.integers(300, 400, 5),
                                                      rng.integers(0, 300, 5))]))
    keep, present = t_delta._removal_mask(keys, rm)
    np.testing.assert_array_equal(keep, ~np.isin(keys, rm))
    np.testing.assert_array_equal(present, np.isin(rm, keys))
    assert not present.all() and not keep.all()


def test_plan_with_the_bitset_closure_is_bitwise_jax():
    src, dst, g, jg = _rand_graphs(v=120, e=600, seed=4)
    rng = np.random.default_rng(7)
    tt, jt = BitsetDirtyTracker(g, buckets=16), JBitset(jg, buckets=16)
    for _ in range(4):
        pairs = [(int(rng.integers(0, 120)), int(rng.integers(0, 120))) for _ in range(5)]
        td, jd = GraphDelta.edges(add=pairs), j_delta.GraphDelta.edges(add=pairs)
        tt.observe_delta(td)
        jt.observe_delta(jd)
        t = plan_delta(g, td, hops=2, dirty_closure=tt.closure)
        j = j_delta.plan_delta(jg, jd, hops=2, dirty_closure=jt.closure)
        assert np.array_equal(t.dirty, j.dirty) and t.digest == j.digest
        assert np.array_equal(tt.adj, jt.adj)
        assert not len(np.setdiff1d(plan_delta(g, td, hops=2).dirty, t.dirty))


def test_dirty_sets_on_a_ring():
    """JAX's ring case: adding (4, 1) on 0->1->...->7->0 patches row 1 and
    dirties the out-closure {1, 5}, then {2, 6} one hop further."""
    ring = np.arange(8, dtype=np.uint32)
    g = build_graph(ring, np.roll(ring, -1), 8)
    plan = plan_delta(g, GraphDelta.edges(add=[(4, 1)]), hops=2)
    assert plan.dirty_rows.tolist() == [1]
    assert sorted(plan.dirty.tolist()) == [1, 2, 5, 6]
    assert sorted(plan_delta(g, GraphDelta.edges(add=[(4, 1)]), hops=1).dirty.tolist()) == [1, 5]


@pytest.mark.parametrize("case", ["missing", "outside", "no_features", "mismatch"])
def test_refusals_equal_jax(case):
    ring = np.arange(4, dtype=np.uint32)
    g, jg = build_graph(ring, np.roll(ring, -1), 4, use_native=False), \
        j_build_graph(ring, np.roll(ring, -1), 4, use_native=False)

    def outcome(mod, graph):
        try:
            if case == "missing":
                mod.plan_delta(graph, mod.GraphDelta.edges(remove=[(2, 0), (1, 1)]), hops=2)
            elif case == "outside":
                mod.plan_delta(graph, mod.GraphDelta.edges(add=[(0, 99)]), hops=2)
            elif case == "no_features":
                mod.GraphDelta(add_vertices=1)
            else:
                mod.GraphDelta(add_src=np.array([1]), add_dst=np.array([1, 2]))
        except ValueError as e:
            return str(e)
        return None

    got = outcome(t_delta, g)
    assert got is not None and got == outcome(j_delta, jg)
    # removal drops EVERY occurrence of a listed pair
    g2 = build_graph(np.array([0, 0, 1], np.uint32), np.array([1, 1, 2], np.uint32), 3)
    plan = plan_delta(g2, GraphDelta.edges(remove=[(0, 1)]), hops=1)
    assert plan.removed_edges == 2 and plan.graph.e_num == 1


# ---- the device neighbour table ----------------------------------------------------------

def _table_case(case, monkeypatch):
    """(src, dst, v, deltas, margin) of one table scenario; every delta is
    applied in turn."""
    src = np.array([0, 1, 2, 3, 4, 5, 6, 7, 2, 4, 6], np.uint32)
    dst = np.array([1, 2, 3, 4, 5, 6, 7, 0, 0, 0, 0], np.uint32)
    f1 = np.ones((1, 2), np.float32)
    if case == "patch":  # the table is 4 wide: an edge delta into 1 fits
        return src, dst, 8, [dict(add=[(4, 1), (5, 1)], remove=[(0, 1)])], 0
    if case == "append_rebuild":  # no margin: a new V rebuilds
        return src, dst, 8, [dict(add=[(0, 8), (8, 3)], add_vertices=1, add_features=f1)], 0
    if case == "width":  # vertex 3 outgrows the 4-wide table
        return src, dst, 8, [dict(add=[(1, 3), (2, 3), (5, 3), (6, 3)])], 0
    if case == "margin":  # the append lands in reserved rows
        return src, dst, 8, [dict(add=[(0, 8), (8, 3)], add_vertices=1, add_features=f1),
                             dict(add=[(8, 1)], remove=[(0, 1)])], 4
    # thinned: a 2-wide cap pre-thins vertex 0; every delta rebuilds
    monkeypatch.setenv("NTS_SAMPLE_DEVICE_MAX_DEG", "2")
    return src, dst, 8, [dict(add=[(3, 5)], remove=[(2, 3)]),
                         dict(add=[(0, 8), (8, 3)], add_vertices=1, add_features=f1)], 4


@pytest.mark.parametrize("case", ["patch", "append_rebuild", "width", "margin", "thinned"])
def test_patched_table_is_a_fresh_table_and_jax(case, monkeypatch):
    src, dst, v, deltas, margin = _table_case(case, monkeypatch)
    g, jg = build_graph(src, dst, v, use_native=False), j_build_graph(src, dst, v, use_native=False)
    ts = t_device_sampler.DeviceUniformSampler.from_host(g)
    js = j_device_sampler.DeviceUniformSampler.from_host(jg)
    ts.reserve_capacity(margin)
    js.reserve_capacity(margin)
    for kw in deltas:
        ptr, width, before = ts.nbr.data_ptr(), ts.width, ts.nbr.clone()
        tp = plan_delta(g, GraphDelta.edges(**kw), hops=2)
        jp = j_delta.plan_delta(jg, j_delta.GraphDelta.edges(**kw), hops=2)
        n_t = ts.apply_delta(tp.graph, tp.dirty_rows)
        n_j = js.apply_delta(jp.graph, jp.dirty_rows)
        assert n_t == n_j
        g, jg = tp.graph, jp.graph
        fresh = t_device_sampler.DeviceUniformSampler.from_host(g)
        vn = g.v_num
        assert (ts.width, ts.thinned) == (fresh.width, fresh.thinned) == (js.width, js.thinned)
        assert torch.equal(ts.nbr[:vn], fresh.nbr) and torch.equal(ts.eff_deg[:vn], fresh.eff_deg)
        assert np.array_equal(ts.nbr[:vn].numpy(), np.asarray(js.nbr)[:vn])
        assert np.array_equal(ts.eff_deg[:vn].numpy(), np.asarray(js.eff_deg)[:vn])
        assert not ts.eff_deg[vn:].any() and not ts.nbr[vn:].any()  # slack stays slack
        in_place = ts.width == width and vn <= before.shape[0]
        assert (ts.nbr.data_ptr() == ptr) == in_place, case
        if case == "patch":  # only row 1 was rewritten
            assert n_t == 1 and torch.equal(ts.nbr[2:], before[2:])
    assert {"patch": 1, "append_rebuild": 9, "width": 8, "margin": 1, "thinned": 9}[case] == n_t


# ---- serving ---------------------------------------------------------------------------

def _toolkit(src, dst, datum, g, ckpt, mode="", drop_rate=None):
    cfg = _serve_cfg(InputInfo, ckpt)
    cfg.sample_pipeline = mode
    if drop_rate is not None:
        cfg.drop_rate = drop_rate
    td = GNNDatum(feature=datum.feature, label=datum.label, mask=datum.mask)
    return GCNSampleTrainer.from_arrays(cfg, src, dst, td, device="cpu", host_graph=g)


def _engine(planted, ckpt, mode, seed=123, **kw):
    src, dst, datum, g, _ = planted
    return InferenceEngine(_toolkit(src, dst, datum, g, ckpt, mode), ckpt,
                           options=_opts(t_batcher, sample_pipeline=mode, **kw),
                           rng=np.random.default_rng(seed))


def _fresh_engine(plan, datum, ckpt, mode, seed=123, feature_rows=None):
    """A new toolkit over the post-delta edge list (the appended vertices'
    feature rows added to the datum), restored from the same checkpoint."""
    if feature_rows is not None:
        k = len(feature_rows)
        datum = GNNDatum(feature=np.concatenate([datum.feature, feature_rows]),
                         label=np.concatenate([datum.label, np.zeros(k, np.int32)]),
                         mask=np.concatenate([datum.mask, np.full(k, 2, np.int32)]))
    g = build_graph(plan.src, plan.dst, plan.v_num, use_native=False)
    cfg = _serve_cfg(InputInfo, ckpt)
    cfg.sample_pipeline = mode
    cfg.vertices = plan.v_num
    tk = GCNSampleTrainer.from_arrays(cfg, plan.src.astype(np.uint32),
                                      plan.dst.astype(np.uint32), datum, device="cpu",
                                      host_graph=g)
    return InferenceEngine(tk, ckpt, options=_opts(t_batcher, sample_pipeline=mode),
                           rng=np.random.default_rng(seed))


def _mk_delta(graph):
    """JAX's mixed delta: 3 inserts and the removal of a real edge."""
    u, w = int(graph.row_indices[0]), int(graph.dst_of_edge[0])
    return GraphDelta.edges(add=[(5, 17), (200, 17), (17, 42)], remove=[(u, w)])


@pytest.mark.parametrize("mode", ["sync", "device", "fused"])
def test_served_logits_after_a_delta_are_a_fresh_engines(planted, jax_trained, mode):
    _, ckpt = jax_trained
    src, dst, datum, _, _ = planted
    eng = _engine(planted, ckpt, mode)
    eng.warmup()
    counts = dict(eng.compile_counts)
    plan = eng.apply_delta(_mk_delta(eng.sampler.graph))
    assert eng.graph_digest() == plan.digest
    assert eng.compile_counts == counts  # an edge-only delta captures nothing
    fresh = _fresh_engine(plan, GNNDatum(feature=datum.feature, label=datum.label,
                                         mask=datum.mask), ckpt, mode)
    if mode != "sync":
        hs, fs = eng.sampler.hop_sampler, fresh.sampler.hop_sampler
        assert torch.equal(hs.nbr[:V], fs.nbr) and torch.equal(hs.eff_deg[:V], fs.eff_deg)
    rng = np.random.default_rng(9)
    for _ in range(5):
        seeds = rng.integers(0, V, size=int(rng.integers(1, 16)))
        np.testing.assert_array_equal(eng.predict(seeds), fresh.predict(seeds))
    # every dirty vertex and some clean ones, one flush each
    clean = np.setdiff1d(np.arange(V), plan.dirty)[:8]
    for ids in (plan.dirty[:16], clean):
        np.testing.assert_array_equal(eng.predict(ids), fresh.predict(ids))


@pytest.mark.parametrize("mode", ["sync", "device"])
def test_a_flush_prepared_before_a_delta_answers_pre_delta(planted, jax_trained, mode):
    """Engine level: a prepared flush holds its sampled operands, which a
    delta does not touch (an appended row lies beyond every pre-delta id)."""
    _, ckpt = jax_trained
    eng = _engine(planted, ckpt, mode)
    ids = np.array([17, 42, 5, 1])
    batch = eng.sampler.sample(4, ids)
    want = eng.forward_batch(batch, 4)
    prepared = eng.prepare_batch(batch)
    f = eng.feature.shape[1]
    v0 = eng.sampler.graph.v_num
    delta = GraphDelta.edges(add=[(17, 42), (v0, 17)], remove=[(int(eng.sampler.graph.row_indices[0]),
                                                                int(eng.sampler.graph.dst_of_edge[0]))],
                             add_vertices=1, add_features=np.full((1, f), 3.0, np.float32))
    eng.apply_delta(delta)
    np.testing.assert_array_equal(eng.execute_prepared(prepared, 4), want)


def _held_server(eng, release: threading.Event):
    """A continuous-batching server whose executor waits on ``release``
    before each flush."""
    server = InferenceServer(eng, options=eng.opts)
    real = server._execute_prepared

    def held(*args):
        release.wait(30)
        return real(*args)

    server._execute_prepared = held
    return server


@pytest.mark.parametrize("mode", ["sync", "fused"])
def test_a_prepared_flush_under_a_pipelined_server_answers_pre_delta(planted, jax_trained,
                                                                      mode):
    """The server level, where the tables change in place: a flush produced
    before a delta answers from the pre-delta view (the delta waits for it),
    the next flush from the post-delta view, each bitwise."""
    _, ckpt = jax_trained
    src, dst, datum, _, _ = planted
    eng = _engine(planted, ckpt, mode, seed=5, continuous_batching=True, max_wait_ms=1)
    twin = _engine(planted, ckpt, mode, seed=5)  # the same rng stream, no server
    release = threading.Event()
    server = _held_server(eng, release)
    try:
        ids = [17, 42]
        req = server.submit(ids)
        deadline = time.time() + 30
        while server._prepared == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert server._prepared == 1
        delta = _mk_delta(eng.sampler.graph)
        applied = threading.Thread(target=server.apply_delta, args=(delta,))
        applied.start()
        time.sleep(0.2)
        assert applied.is_alive()  # waiting for the prepared flush
        release.set()
        applied.join(30)
        pre = req.result(timeout=30)
        np.testing.assert_array_equal(pre, twin.predict(np.array(ids)))
        post = server.predict([17, 42], timeout=30)
        plan = twin.apply_delta(delta)
        np.testing.assert_array_equal(post, twin.predict(np.array(ids)))
        assert not np.array_equal(pre, post) and eng.graph_digest() == plan.digest
    finally:
        release.set()
        server.close()


def test_cache_invalidation_is_incremental(planted, jax_trained):
    _, ckpt = jax_trained
    eng = _engine(planted, ckpt, "sync", seed=5, cache_cap=256, cache_max_age_s=3600.0,
                  max_batch=8)
    server = InferenceServer(eng)
    try:
        delta = _mk_delta(eng.sampler.graph)
        preview = plan_delta(eng.sampler.graph, delta, hops=len(eng.fanouts))
        dirty = set(preview.dirty.tolist())
        clean = [v for v in range(V) if v not in dirty][:20]
        for vid in list(preview.dirty[:5]) + clean:
            server.predict([int(vid)], timeout=60.0)
        rows = {v: server.cache.lookup(v) for v in clean}
        hits0 = server.cache.stats()["hits"]
        plan = server.apply_delta(delta)
        assert all(server.cache.lookup(int(v)) is None for v in preview.dirty[:5])
        for v in clean:
            np.testing.assert_array_equal(server.cache.lookup(v), rows[v])
        st = server.cache.stats()
        assert st["invalidated"] == 5 and st["hits"] == hits0 + 20
        snap = server.metrics.snapshot()
        assert snap["counters"].get("serve.graph_deltas") == 1
        assert snap["gauges"].get("graph.digest") == plan.digest
    finally:
        server.close()


@pytest.mark.parametrize("mode", ["sync", "fused"])
def test_an_append_past_the_slab_drops_both_ladders(planted, jax_trained, mode):
    _, ckpt = jax_trained
    src, dst, datum, _, _ = planted
    eng = _engine(planted, ckpt, mode)
    eng.warmup()
    f = int(eng.feature.shape[1])
    v0 = eng.sampler.graph.v_num
    rows = np.full((1, f), 0.5, np.float32)
    delta = GraphDelta.edges(add=[(3, v0), (v0, 7)], add_vertices=1, add_features=rows)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("nts_torch.serve").addHandler(handler)
    try:
        plan = eng.apply_delta(delta)
    finally:
        logging.getLogger("nts_torch.serve").removeHandler(handler)
    assert any("captures once" in r.getMessage() for r in records
               if r.levelno >= logging.WARNING)
    assert eng.sampler.graph.v_num == v0 + 1 and eng.feature.shape[0] == v0 + 1
    assert not eng._compiled and not eng._fused_compiled
    assert eng.toolkit.feature is eng.feature
    fresh = _fresh_engine(plan, GNNDatum(feature=datum.feature, label=datum.label,
                                         mask=datum.mask), ckpt, mode, feature_rows=rows)
    for ids in (np.array([v0]), np.array([v0, 3, 7])):
        np.testing.assert_array_equal(eng.predict(ids), fresh.predict(ids))
    assert eng.compile_counts[1] == 2  # captured again once


def test_the_digest_bump_misses_the_tune_cache(planted, jax_trained, tmp_path, monkeypatch):
    from neutronstarlite_torch.tune import cache as tune_cache

    _, ckpt = jax_trained
    monkeypatch.setenv("NTS_TUNE_DIR", str(tmp_path / "tune"))
    eng = _engine(planted, ckpt, "sync", seed=8)
    old = eng.graph_digest()

    def key(digest):
        return tune_cache.CacheKey(graph_digest=digest, family="edge_single/Fake",
                                   partitions=1, layers="16-24-4",
                                   backend=tune_cache.backend_fingerprint())

    tune_cache.store(key(old), {"candidate": "-|fused_edge|binned|-", "source": "measured"},
                     autos=["kernel"])
    plan = eng.apply_delta(_mk_delta(eng.sampler.graph))
    new = eng.graph_digest()
    assert new == plan.digest != old and eng.toolkit._tune_graph_digest == new
    assert tune_cache.load(key(new)) is None and tune_cache.load(key(old)) is not None


def test_the_engine_serves_its_own_copy_of_the_weights(planted, jax_trained):
    _, ckpt = jax_trained
    eng = _engine(planted, ckpt, "sync")
    before = eng.predict(np.array([1, 2, 3]))
    for p in eng.toolkit.flat_params:  # a fine-tune step's in-place update
        with torch.no_grad():
            p.add_(1.0)
    twin = eng.clone(rng=np.random.default_rng(123))
    np.testing.assert_array_equal(twin.predict(np.array([1, 2, 3])), before)


def test_a_fleet_applies_one_plan_to_every_replica(planted, jax_trained, monkeypatch):
    monkeypatch.setenv("NTS_SERVE_HEARTBEAT_S", "0.05")
    _, ckpt = jax_trained
    eng = _engine(planted, ckpt, "fused", seed=3, cache_cap=64, cache_max_age_s=3600.0)
    eng.warmup()
    counts = dict(eng.compile_counts)
    fleet = ReplicaSet.from_engine(eng, 3, seed=3)
    try:
        for i in range(12):
            fleet.submit([i * 7 % V]).result(timeout=30)
        delta = _mk_delta(eng.sampler.graph)
        plan = fleet.apply_delta(delta)
        assert all(r.engine.sampler.graph is plan.graph for r in fleet.replicas)
        assert fleet.engine.sampler.graph is plan.graph
        assert eng.compile_counts == counts
        for r in fleet.replicas:
            snap = r.server.metrics.snapshot() if r.server.metrics else None
            if snap is not None:
                assert snap["counters"].get("serve.graph_deltas") == 1
        assert fleet.registry.snapshot()["counters"].get("fleet.graph_deltas") == 1
        assert fleet.registry.snapshot()["gauges"].get("graph.digest") == plan.digest
        for i in range(12):
            out = fleet.submit([i]).result(timeout=30)
            assert out.shape == (1, CLASSES) and np.isfinite(out).all()
        present = set(zip(plan.src.tolist(), plan.dst.tolist()))
        missing = next((u, 0) for u in range(V) if (u, 0) not in present)
        with pytest.raises(ValueError, match="do not exist"):
            fleet.apply_delta(GraphDelta.edges(remove=[missing]))
    finally:
        fleet.close()


def test_serve_bench_runs_with_live_deltas_on_cpu(tmp_path):
    """``serve_bench --delta-rate`` on the Cora serve smoke: deltas apply
    during the load, no error, and the ledger row keys on the pre-delta
    digest, with the rate and the deltas applied."""
    env = dict(os.environ, NTS_METRICS_DIR=str(tmp_path / "m"),
               NTS_LEDGER_DIR=str(tmp_path / "ledger"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.tools.serve_bench", _smoke_cfg(tmp_path),
         "--train", "--device", "cpu", "--requests", "300", "--mode", "open", "--rps", "300",
         "--delta-rate", "20", "--delta-edges", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    extra = json.loads(proc.stdout.strip().splitlines()[-1])["extra"]
    assert extra["errors"] == 0 and extra["served"] + extra["shed"] == 300
    assert extra["deltas_applied"] > 0 and extra["delta_rate"] == 20
    assert extra["graph_digest"] != extra["initial_graph_digest"]
    assert "graph delta applied" in proc.stdout + proc.stderr
    from neutronstarlite_torch.obs import ledger

    rows = [r for r in ledger.read_rows(str(tmp_path / "ledger")) if r["kind"] == "serve"]
    assert len(rows) == 1 and rows[0]["graph_digest"] == extra["initial_graph_digest"]
    assert rows[0]["deltas_applied"] == extra["deltas_applied"] and rows[0]["delta_rate"] == 20
