"""The port's serving plane (``neutronstarlite_torch/serve``) against the JAX
package's, on the CPU.

- Config: ``ServeOptions``/``FleetOptions`` and the bucket ladder equal the
  reference's for both serve cfgs and for each ``NTS_SERVE_*`` override,
  garbage values included; the copied ``batcher.py`` and ``exporter.py``
  equal the originals except for their import paths.
- Batcher, cache, sampler: the batcher's size, deadline, shed and
  close-drain behaviour; ``EmbeddingCache`` LRU, staleness and hot split;
  ``hot_vertex_mask`` and ``Sampler.sample_batch`` bitwise JAX's.
- Cross-package serving (f32, a planted 300-vertex graph): JAX trains and
  checkpoints, the port's engine restores JAX's npz checkpoint; every
  bucket's ServeSampler batches are bitwise JAX's from one Generator seed;
  served logits equal JAX's within 1e-4·rms + 1e-4·|ref| (argmax >= 99 %),
  and bitwise the port trainer's own eval forward on the same batch.
- Contracts: one build per bucket across warmup, traffic and a clone; a
  warm clone and a cold engine serve the same sequence (sync, device,
  fused); the refusals; the server's cache; ``choose_replica`` equals
  JAX's; a 3-replica fleet with a killed replica; the exporter's paths;
  numerics and the liveness monitor against the reference; the CLIs.

The JAX trainer runs with ``neutronstarlite_tpu.native.available`` False
(its NumPy graph build and sampler, which the port reproduces bitwise) and
is cached at module scope; torch runs on one intra-op thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.models.gcn_sample import GCNSampleTrainer as JSample
from neutronstarlite_tpu.obs import numerics as j_numerics
from neutronstarlite_tpu.parallel.feature_cache import hot_vertex_mask as j_hot_vertex_mask
from neutronstarlite_tpu.resilience import elastic as j_elastic
from neutronstarlite_tpu.resilience import events as j_events
from neutronstarlite_tpu.sample import sampler as j_sampler
from neutronstarlite_tpu.serve import batcher as j_batcher
from neutronstarlite_tpu.serve import fleet as j_fleet
from neutronstarlite_tpu.serve.engine import InferenceEngine as JEngine
from neutronstarlite_tpu.serve.sampling import ServeSampler as JServeSampler
from neutronstarlite_tpu.utils.config import InputInfo as JInfo
from tests.test_models import _planted_data

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gat import GATTrainer
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer, batch_forward
from neutronstarlite_torch import obs
from neutronstarlite_torch.obs import exporter as t_exporter
from neutronstarlite_torch.obs import numerics as t_numerics
from neutronstarlite_torch.resilience import elastic as t_elastic
from neutronstarlite_torch.resilience import events as t_events
from neutronstarlite_torch.sample import sampler as t_sampler
from neutronstarlite_torch.serve import batcher as t_batcher
from neutronstarlite_torch.serve import fleet as t_fleet
from neutronstarlite_torch.serve.engine import InferenceEngine, Packing, ServeSetupError
from neutronstarlite_torch.serve.sampling import EmbeddingCache, ServeSampler, hot_vertex_mask
from neutronstarlite_torch.serve.server import InferenceServer
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_CFGS = ("serve_cora_smoke", "serve_fleet_smoke")
V, F, CLASSES = 300, 16, 4
BUCKETS = [1, 4, 16]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("NTS_SERVE_") or k in (
                "NTS_SAMPLE_PIPELINE", "NTS_METRICS_PORT", "NTS_METRICS_DIR", "NTS_SLO_SPEC",
                "NTS_LEDGER_DIR", "NTS_NUMERICS", "NTS_HEARTBEAT_MISS_K"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


# ---- config ------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVE_CFGS)
def test_serve_cfgs_parse_to_the_reference_options(name):
    path = os.path.join(REPO, "configs", f"{name}.cfg")
    t_cfg, j_cfg = InputInfo.read_from_cfg_file(path), JInfo.read_from_cfg_file(path)
    ref = dataclasses.asdict(j_cfg)
    for k, v in t_cfg.reference_dict().items():
        assert ref[k] == v, k
    assert t_cfg.serve_bucket_list() == j_cfg.serve_bucket_list() == [1, 4, 8]
    t_o, j_o = t_batcher.ServeOptions.from_cfg(t_cfg), j_batcher.ServeOptions.from_cfg(j_cfg)
    assert dataclasses.asdict(t_o) == dataclasses.asdict(j_o)
    assert t_o.ladder() == j_o.ladder()
    assert dataclasses.asdict(t_fleet.FleetOptions.from_cfg(t_cfg)) == \
        dataclasses.asdict(j_fleet.FleetOptions.from_cfg(j_cfg))


@pytest.mark.parametrize("env", [
    {"NTS_SERVE_MAX_BATCH": "8"}, {"NTS_SERVE_MAX_BATCH": "eight"},
    {"NTS_SERVE_MAX_BATCH": "0"}, {"NTS_SERVE_MAX_WAIT_MS": "0.5"},
    {"NTS_SERVE_MAX_WAIT_MS": "soon"}, {"NTS_SERVE_MAX_QUEUE": "0"},
    {"NTS_SERVE_BUCKETS": "1-8"}, {"NTS_SERVE_BUCKETS": "a-b"},
    {"NTS_SERVE_BUCKETS": "0-0"}, {"NTS_SERVE_CACHE_CAP": "32"},
    {"NTS_SERVE_CACHE_MAX_AGE_S": "x"}, {"NTS_SERVE_HOT_THRESHOLD": "3"},
    {"NTS_SERVE_CB": "1"}, {"NTS_SERVE_CB": "2"}, {"NTS_SERVE_REPLICAS": "3"},
    {"NTS_SERVE_REPLICAS": "many"}, {"NTS_SERVE_REPLICAS": "0"},
    {"NTS_SERVE_ROUTE": "round_robin"}, {"NTS_SERVE_ROUTE": "teleport"},
    {"NTS_SERVE_ROUTE_HYST": "-1"}, {"NTS_SERVE_HEARTBEAT_S": "fast"},
    {"NTS_SAMPLE_PIPELINE": "fused"}, {"NTS_SAMPLE_PIPELINE": "warp"},
])
def test_serve_env_overrides_equal_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = os.path.join(REPO, "configs", "serve_fleet_smoke.cfg")
    t_cfg, j_cfg = InputInfo.read_from_cfg_file(path), JInfo.read_from_cfg_file(path)

    def opts(mod, cfg):
        def go():
            o = mod.ServeOptions.from_cfg(cfg)
            return dataclasses.asdict(o), _outcome(o.ladder)
        return _outcome(go)

    def fleet(mod, cfg):
        return _outcome(lambda: dataclasses.asdict(mod.FleetOptions.from_cfg(cfg)))

    t, j = opts(t_batcher, t_cfg), opts(j_batcher, j_cfg)
    if isinstance(j, tuple) and j[0] == "ValueError" and "SAMPLE_PIPELINE" in j[1]:
        assert t[0] == "ValueError" and "SAMPLE_PIPELINE" in t[1]  # the port's own wording
    else:
        assert t == j
    assert fleet(t_fleet, t_cfg) == fleet(j_fleet, j_cfg)


@pytest.mark.parametrize("path", ["serve/batcher.py", "obs/exporter.py"])
def test_copied_serving_modules_equal_the_originals(path):
    """The copies differ from the originals only in their docstring's port
    note and the import paths."""
    def body(pkg):
        with open(os.path.join(REPO, pkg, path)) as fh:
            src = fh.read()
        _, doc, rest = src.split('"""', 2)
        return doc.split("\n", 1)[0], rest.replace(pkg, "PKG")

    assert body("neutronstarlite_torch") == body("neutronstarlite_tpu")


# ---- batcher, cache, sampler -----------------------------------------------------

class _Recorder:
    """flush_fn stub: completes every request, records (sizes, reason)."""

    def __init__(self, delay_s: float = 0.0):
        self.flushes = []
        self.delay_s = delay_s
        self.release = threading.Event()

    def __call__(self, requests, reason):
        if self.delay_s:
            self.release.wait(self.delay_s)
        self.flushes.append(([len(r.node_ids) for r in requests], reason))
        for r in requests:
            r._complete(np.zeros((len(r.node_ids), 2)), "ok")


def test_batcher_size_deadline_shed_and_drain():
    rec = _Recorder()
    mb = t_batcher.MicroBatcher(rec, t_batcher.ServeOptions(max_batch=4, max_wait_ms=5000))
    reqs = [mb.submit([i]) for i in range(4)]
    for r in reqs:
        r.result(timeout=30)
    assert rec.flushes[0] == ([1, 1, 1, 1], "size")
    # a lone request flushes at its deadline
    rec2 = _Recorder()
    mb2 = t_batcher.MicroBatcher(rec2, t_batcher.ServeOptions(max_batch=64, max_wait_ms=20))
    t0 = time.perf_counter()
    mb2.submit([7]).result(timeout=30)
    assert rec2.flushes == [([1], "deadline")] and time.perf_counter() - t0 >= 0.019
    # malformed and oversized requests shed with a reason
    with pytest.raises(t_batcher.RequestShedError, match="empty_request"):
        mb2.submit([]).result(timeout=30)
    with pytest.raises(t_batcher.RequestShedError, match="request_too_large"):
        mb.submit(list(range(5))).result(timeout=30)
    # a full queue sheds; close drains what is pending
    slow = _Recorder(delay_s=30.0)
    mb3 = t_batcher.MicroBatcher(slow, t_batcher.ServeOptions(max_batch=1, max_wait_ms=1,
                                                              max_queue=2))
    first = mb3.submit([0])
    deadline = time.perf_counter() + 30
    while mb3.depth and time.perf_counter() < deadline:  # the flusher took it
        time.sleep(0.001)
    queued = [mb3.submit([1]), mb3.submit([2])]
    with pytest.raises(t_batcher.RequestShedError, match="queue_full"):
        mb3.submit([3]).result(timeout=30)
    slow.release.set()
    mb3.close()
    for r in [first] + queued:
        r.result(timeout=30)
    assert [f[1] for f in slow.flushes] == ["size", "size", "size"] or \
        "drain" in [f[1] for f in slow.flushes]
    assert mb3.shed_count == 1
    with pytest.raises(t_batcher.RequestShedError, match="server_closed"):
        mb3.submit([4]).result(timeout=30)
    mb.close()
    mb2.close()
    assert not (mb.alive() or mb2.alive() or mb3.alive())


def test_embedding_cache_lru_staleness_and_hot_split():
    clock = {"t": 0.0}
    hot = np.array([True, True, False, True])
    c = EmbeddingCache(capacity=2, max_age_s=10.0, hot_mask=hot, clock=lambda: clock["t"])
    rows = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert c.insert(np.arange(4), rows) == 3  # vid 2 is cold; cap evicts 0
    assert c.lookup(2) is None  # cold: never cached
    assert c.lookup(0) is None  # LRU-evicted by capacity
    np.testing.assert_array_equal(c.lookup(3), rows[3])
    np.testing.assert_array_equal(c.lookup(1), rows[1])
    c.insert(np.array([0]), rows[:1])  # evicts 3, the least recently used
    assert c.lookup(3) is None and c.lookup(1) is not None
    clock["t"] = 11.0  # everything is now stale
    assert c.lookup(1) is None
    assert c.stats() == {"entries": 1, "hits": 3, "misses": 4, "expired": 1, "invalidated": 0}
    off = EmbeddingCache(capacity=0)
    assert off.insert(np.array([1]), rows[:1]) == 0
    assert off.lookup(1) is None


@pytest.fixture(scope="module")
def planted():
    """The planted 300-vertex graph of the JAX serving tests, built by both
    packages' NumPy paths."""
    src, dst, datum = _planted_data(v_num=V, seed=11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jg = j_build_graph(src, dst, V, use_native=False)
    return src, dst, datum, build_graph(src, dst, V), jg


def test_hot_vertex_mask_and_sample_batch_equal_jax(planted):
    _, _, _, g, jg = planted
    for thr in (0, 3, 10, 1000):
        np.testing.assert_array_equal(hot_vertex_mask(g, thr), j_hot_vertex_mask(jg, thr))
    nids = np.arange(V)
    t_s = t_sampler.Sampler(g, nids, 16, [3, 3], rng=np.random.default_rng(3))
    j_s = j_sampler.Sampler(jg, nids, 16, [3, 3], rng=np.random.default_rng(3))
    for seeds in ([5], [0, 299, 17], list(range(16))):
        _assert_batches_equal(t_s.sample_batch(seeds), j_s.sample_batch(seeds))
    for bad in ([], [[1, 2]], list(range(17))):
        with pytest.raises(ValueError) as t_err:
            t_s.sample_batch(bad)
        with pytest.raises(ValueError) as j_err:
            j_s.sample_batch(bad)
        assert str(t_err.value) == str(j_err.value)


def _assert_batches_equal(got, want):
    for a, b in zip(got.nodes, want.nodes):
        np.testing.assert_array_equal(a, b)
    for ha, hb in zip(got.hops, want.hops):
        for f in ("src_local", "dst_local", "weight"):
            x, y = getattr(ha, f), getattr(hb, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert ha.n_dst == hb.n_dst
    np.testing.assert_array_equal(got.seed_mask, want.seed_mask)
    np.testing.assert_array_equal(got.seeds, want.seeds)


def test_packing_round_trips_a_batch(planted):
    _, _, _, g, _ = planted
    from neutronstarlite_torch.serve.engine import batch_device_arrays

    s = t_sampler.Sampler(g, np.arange(V), 4, [3, 3], rng=np.random.default_rng(0))
    arrays = batch_device_arrays(s.sample_batch([1, 2, 3]))
    p = Packing.of(arrays)
    assert all(off % 16 == 0 for off, _, _ in p.segments)
    views = p.views(p.pack(arrays, pin=False))
    for v, a in zip(views, arrays):
        assert v.dtype == getattr(torch, a.dtype.name)
        np.testing.assert_array_equal(v.numpy(), a)
    with pytest.raises(ValueError, match="slot"):
        p.pack(arrays[:-1] + [arrays[-1][:-1]], pin=False)


# ---- cross-package serving ------------------------------------------------------

def _serve_cfg(cls, ckpt=""):
    cfg = cls()
    cfg.algorithm = "GCNSAMPLESINGLE"
    cfg.vertices = V
    cfg.layer_string = f"{F}-24-{CLASSES}"
    cfg.fanout_string = "3-3"
    cfg.batch_size = 16
    cfg.epochs = 2
    cfg.learn_rate = 0.01
    cfg.weight_decay = 1e-4
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.3
    cfg.checkpoint_dir = ckpt
    return cfg


@pytest.fixture(scope="module")
def jax_trained(planted, tmp_path_factory):
    """JAX's sampled GCN trained 2 epochs and checkpointed (npz)."""
    src, dst, datum, _, jg = planted
    ckpt = str(tmp_path_factory.mktemp("jax_serve") / "ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.delenv("NTS_SAMPLE_PIPELINE", raising=False)
        jd = JDatum(feature=datum.feature, label=datum.label, mask=datum.mask)
        tr = JSample.from_arrays(_serve_cfg(JInfo, ckpt), src, dst, jd, host_graph=jg)
        tr.run()
    return tr, ckpt


def _port_toolkit(planted, ckpt, mode=""):
    src, dst, datum, g, _ = planted
    cfg = _serve_cfg(InputInfo, ckpt)
    cfg.sample_pipeline = mode
    td = GNNDatum(feature=datum.feature, label=datum.label, mask=datum.mask)
    with pytest.MonkeyPatch.context() as mp:  # module fixtures run before _clean_env
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        return GCNSampleTrainer.from_arrays(cfg, src, dst, td, device="cpu", host_graph=g)


def _opts(mod, **kw):
    return mod.ServeOptions(**dict(dict(max_batch=16, max_wait_ms=2), **kw))


@pytest.fixture(scope="module")
def port_engine(planted, jax_trained):
    """The port's engine over JAX's checkpoint."""
    _, ckpt = jax_trained
    tk = _port_toolkit(planted, ckpt)
    return InferenceEngine(tk, ckpt, options=_opts(t_batcher), rng=np.random.default_rng(5))


def test_engine_restores_the_jax_checkpoint(jax_trained, port_engine):
    jtr, _ = jax_trained
    assert port_engine.ckpt_step == 2
    for got, want in zip(port_engine.weights, jtr.params):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want["W"]))


def test_serve_sampler_batches_equal_jax_per_bucket(planted):
    _, _, _, g, jg = planted
    t_s = ServeSampler(g, [3, 3], BUCKETS, rng=np.random.default_rng(9))
    j_s = JServeSampler(jg, [3, 3], BUCKETS, rng=np.random.default_rng(9))
    assert t_s.buckets == j_s.buckets == BUCKETS
    rng = np.random.default_rng(0)
    for b in BUCKETS * 3:  # the Generator's state carries across buckets
        assert t_s.node_caps(b) == j_s.node_caps(b)
        ids = rng.choice(V, size=rng.integers(1, b + 1), replace=False)
        _assert_batches_equal(t_s.sample(b, ids), j_s.sample(b, ids))


def test_served_logits_equal_jax_within_tolerance(jax_trained, planted, port_engine):
    jtr, ckpt = jax_trained
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jeng = JEngine(jtr, ckpt, options=_opts(j_batcher), rng=np.random.default_rng(21))
    eng = port_engine.clone(rng=np.random.default_rng(21))
    rng = np.random.default_rng(1)
    got, want = [], []
    for n in (1, 3, 4, 9, 16, 2, 16):
        ids = rng.choice(V, size=n, replace=False)
        got.append(eng.predict(ids))
        want.append(jeng.predict(ids))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (51, CLASSES)
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    assert np.all(np.abs(got - want) <= 1e-4 * rms + 1e-4 * np.abs(want))
    assert np.mean(got.argmax(1) == want.argmax(1)) >= 0.99


def test_served_logits_are_the_trainers_eval_forward_bitwise(port_engine):
    eng = port_engine.clone(rng=np.random.default_rng(2))
    tk = eng.toolkit
    for b in BUCKETS:
        batch = eng.sampler.sample(b, np.arange(b) * 7)
        served = eng.forward_batch(batch, b)
        nodes, hops, _, _ = tk._to_device(batch)
        with torch.no_grad():
            want = batch_forward(tk.flat_params, tk.feature, nodes, hops,
                                 eng.sampler.node_caps(b), tk.compute_dtype).numpy()
            if b == tk.cfg.batch_size:  # the trainer's own capacities
                np.testing.assert_array_equal(tk._forward(tk.flat_params, nodes, hops).numpy(),
                                              want)
        assert served.shape == (b, CLASSES)
        np.testing.assert_array_equal(served, want)


# ---- contracts --------------------------------------------------------------------

def test_exactly_one_build_per_bucket_across_traffic_and_a_clone(planted, jax_trained):
    _, ckpt = jax_trained
    eng = InferenceEngine(_port_toolkit(planted, ckpt), ckpt, options=_opts(t_batcher),
                          rng=np.random.default_rng(0))
    assert eng.compile_counts == {}
    for _ in range(5):
        assert eng.predict(np.array([1, 2, 3])).shape == (3, CLASSES)  # bucket 4
    assert eng.compile_counts == {4: 1}
    eng.warmup()
    server = InferenceServer(eng.clone(rng=np.random.default_rng(1)))
    reqs = [server.submit([i % V, (3 * i) % V][: 1 + i % 2]) for i in range(50)]
    for r in reqs:
        r.result(timeout=30)
    stats = server.close()
    assert stats["requests"] == 50 and stats["shed"] == 0
    assert eng.compile_counts == stats["compile_counts"] == {b: 1 for b in BUCKETS}


@pytest.mark.parametrize("mode", ["sync", "device", "fused"])
def test_warm_clone_and_cold_engine_serve_the_same_sequence(planted, jax_trained, mode):
    _, ckpt = jax_trained
    tk = _port_toolkit(planted, ckpt, mode)
    warm = InferenceEngine(tk, ckpt, options=_opts(t_batcher, sample_pipeline=mode),
                           rng=np.random.default_rng(0))
    warm.warmup()
    clone = warm.clone(rng=np.random.default_rng(77))
    cold = InferenceEngine(tk, ckpt, options=_opts(t_batcher, sample_pipeline=mode),
                           rng=np.random.default_rng(77))
    for n in (1, 5, 16, 2, 4):
        ids = np.arange(n) * 11 + n
        np.testing.assert_array_equal(clone.predict(ids), cold.predict(ids))
    assert warm.compile_counts == cold.compile_counts == {b: 1 for b in BUCKETS}
    assert clone.compile_counts is warm.compile_counts
    if mode == "fused":
        # the engine's fused logits are its eager draw + forward with the key
        buf = torch.tensor([3, 9, 0, 0, 2, 12345])
        staged = clone.prepare_fused(np.array([3, 9]), 4, key=12345)
        np.testing.assert_array_equal(staged.buf.numpy(), buf.numpy())
        got = clone.execute_fused_prepared(staged, 4)
        np.testing.assert_array_equal(got, clone.fused_forward(buf, 4).numpy())


def test_refusals_name_what_is_missing(planted, jax_trained, tmp_path):
    _, ckpt = jax_trained
    tk = _port_toolkit(planted, ckpt)
    with pytest.raises(ServeSetupError, match="no checkpoint"):
        InferenceEngine(tk, str(tmp_path / "nope"))
    with pytest.raises(ServeSetupError, match="no checkpoint directory"):
        InferenceEngine.from_config(_serve_cfg(InputInfo), device="cpu")
    src, dst, datum, _, _ = planted
    cfg = _serve_cfg(InputInfo)
    cfg.algorithm = "GATCPU"
    cfg.fanout_string = ""
    gat = GATTrainer.from_arrays(cfg, src, dst, GNNDatum(feature=datum.feature,
                                 label=datum.label, mask=datum.mask), device="cpu")
    with pytest.raises(ServeSetupError, match="GAT family"):
        InferenceEngine(gat, ckpt)
    # a delta that cannot apply raises out of apply_delta (no fallback)
    from neutronstarlite_torch.serve.delta import GraphDelta

    present = set(zip(src.tolist(), dst.tolist()))
    missing = next((u, w) for u in range(V) for w in range(V) if (u, w) not in present)
    with pytest.raises(ValueError, match="do not exist"):
        InferenceEngine(tk, ckpt).apply_delta(GraphDelta.edges(remove=[missing]))


def test_server_cache_serves_repeats(port_engine):
    opts = _opts(t_batcher, max_batch=16, max_wait_ms=1, cache_cap=64, cache_max_age_s=300.0)
    server = InferenceServer(port_engine.clone(rng=np.random.default_rng(1)), options=opts)
    first = server.predict([42])
    again = server.submit([42])
    np.testing.assert_array_equal(again.result(timeout=30), first)
    assert again.status == "cached"
    stats = server.close()
    assert stats["cache"]["hits"] >= 1
    assert stats["requests"] == 2 and stats["shed"] == 0


def _state(idx, beating=True, draining=False, burn=0.0, depth=0):
    return {"idx": idx, "beating": beating, "draining": draining, "burn": burn,
            "depth": depth, "max_queue": 64}


@pytest.mark.parametrize("states,sticky,hyst", [
    ([_state(0), _state(1), _state(2)], None, 0.25),
    ([_state(0, depth=30), _state(1, depth=2), _state(2, depth=10)], None, 0.25),
    ([_state(0, depth=30), _state(1, depth=2)], 0, 0.25),  # hysteresis keeps 0
    ([_state(0, depth=30), _state(1, depth=2)], 0, 0.1),  # the rival wins
    ([_state(0, burn=3.0), _state(1, burn=0.5)], 0, 0.25),
    ([_state(0, draining=True), _state(1, depth=60)], 0, 0.25),  # drain on breach
    ([_state(0, beating=False), _state(1)], 0, 0.25),
    ([_state(0, draining=True), _state(1, draining=True)], None, 0.25),  # fleet shed
    ([_state(0, beating=False), _state(1, beating=False)], 1, 0.25),  # fleet down
])
def test_choose_replica_equals_jax(states, sticky, hyst):
    assert t_fleet.choose_replica(states, sticky, hyst) == \
        j_fleet.choose_replica(states, sticky, hyst)
    assert t_fleet.classify_states(states) == j_fleet.classify_states(states)


def _wait(cond, what, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_fleet_restarts_a_killed_replica_and_reroutes_its_requests(port_engine, monkeypatch):
    monkeypatch.setenv("NTS_SERVE_HEARTBEAT_S", "0.05")
    monkeypatch.setenv("NTS_HEARTBEAT_MISS_K", "1")
    eng = port_engine.clone(rng=np.random.default_rng(3))
    eng.warmup()
    counts = dict(eng.compile_counts)
    sink = []

    class Sink:
        def event(self, kind, **fields):
            sink.append(dict(fields, event=kind))
            return sink[-1]

    opts = _opts(t_batcher, max_batch=16, max_wait_ms=300)
    fleet = t_fleet.ReplicaSet.from_engine(eng, 3, options=opts)
    try:
        assert len(fleet.replicas) == 3
        # three requests wait in the sticky replica's queue (300 ms window)
        held = [fleet.submit([i]) for i in (1, 2, 3)]
        victim = fleet._sticky
        assert victim is not None and fleet.replicas[victim].server.batcher.depth == 3
        t_events.set_sink(Sink())
        fleet.inject_replica_death(victim)
        _wait(lambda: fleet.replicas[victim].restarts == 1, "the supervised restart")
        for r in held:
            assert r.result(timeout=30).shape == (1, CLASSES) and r.status == "ok"
        more = [fleet.submit([i % V]) for i in range(60)]
        for r in more:
            r.result(timeout=30)
    finally:
        t_events.set_sink(None)
        stats = fleet.close()
    recoveries = [e for e in sink if e["event"] == "recovery"]
    assert [(e["action"], e["stolen_requests"]) for e in recoveries] == [("restart", 3)]
    assert any(e["event"] == "rank_loss" and e["partition"] == victim for e in sink)
    assert stats["requests"] == 63 and stats["shed"] == 0 and stats["restarts"] == 1
    assert eng.compile_counts == counts == {b: 1 for b in BUCKETS}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_serves_metrics_healthz_and_slo(port_engine, monkeypatch):
    monkeypatch.setattr(t_exporter, "_singleton", None)
    monkeypatch.setenv("NTS_METRICS_PORT", "0")
    monkeypatch.setenv("NTS_SLO_SPEC", "serve_p99_ms<=10000@1m")
    server = InferenceServer(port_engine.clone(metrics=obs.open_run("serve-exporter"),
                                               rng=np.random.default_rng(4)))
    exp = server.exporter
    try:
        assert exp is not None and exp.port > 0
        for i in range(12):
            server.predict([i])
        base = f"http://127.0.0.1:{exp.port}"
        code, text = _get(base + "/metrics")
        assert code == 200
        count = [ln for ln in text.splitlines() if ln.startswith("nts_serve_latency_ms_count")]
        assert count and float(count[0].split()[-1]) == 12
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        code, body = _get(base + "/slo")
        assert code == 200 and isinstance(json.loads(body), list)
        assert _get(base + "/nope")[0] == 404
    finally:
        server.close()
        exp.close()


def test_numerics_and_liveness_records_equal_the_reference():
    class Rec:
        def __init__(self):
            self.out = []

        def event(self, kind, **fields):
            self.out.append((kind, fields))
            return dict(fields, event=kind)

        def gauge_set(self, name, v):
            self.out.append(("gauge", name, v))

        def counter_add(self, name, v=1.0):
            self.out.append(("counter", name, v))

    logits = np.array([[1.0, -2.5], [np.nan, 0.0]], dtype=np.float32)
    for arr in (logits, logits[:1]):
        a, b = Rec(), Rec()
        t_numerics.observe_serve_batch(a, arr, 4)
        j_numerics.observe_serve_batch(b, arr, 4)
        assert a.out == b.out
    runs = []
    for elastic, events in ((t_elastic, t_events), (j_elastic, j_events)):
        rec = Rec()
        events.set_sink(rec)
        try:
            m = elastic.LivenessMonitor(3, miss_k=2)
            for tick, alive in enumerate(([0, 1, 2], [0, 2], [0, 2], [0, 1, 2], [0], [0])):
                m.epoch_end(tick, alive=alive)
            m.clear(1)
            runs.append((rec.out, m.missed(1), m.missed(2)))
        finally:
            events.set_sink(None)
    assert runs[0] == runs[1]
    # the survivor replan came with the elastic slice; on real ranks (a
    # joined process group) it refuses, naming the relaunch it would need
    import types

    with pytest.raises(ValueError, match="relaunch"):
        t_elastic.replan_survivors(types.SimpleNamespace(world=object()), 1)
    # and the chaos kill marks a sim partition dead (the process-global set)
    t_elastic.kill_partition(1)
    try:
        assert t_elastic.dead_partitions() == {1}
    finally:
        t_elastic.reset()


# ---- the CLIs -----------------------------------------------------------------------

def _smoke_cfg(tmp_path):
    with open(os.path.join(REPO, "configs", "serve_cora_smoke.cfg")) as fh:
        text = fh.read().replace("../tests", os.path.join(REPO, "tests"))
    path = tmp_path / "serve_smoke.cfg"
    path.write_text(text + f"CHECKPOINT_DIR:{tmp_path / 'ck'}\n")
    return str(path)


def test_serve_bench_trains_and_the_server_cli_serves_on_cpu(tmp_path):
    cfg = _smoke_cfg(tmp_path)
    env = dict(os.environ, NTS_SAMPLE_WORKERS="0", NTS_METRICS_DIR=str(tmp_path / "m"),
               NTS_LEDGER_DIR=str(tmp_path / "ledger"), OMP_NUM_THREADS="1")
    bench = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.tools.serve_bench", cfg, "--train",
         "--device", "cpu", "--requests", "40", "--clients", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert bench.returncode == 0, bench.stderr[-2000:]
    extra = json.loads(bench.stdout.strip().splitlines()[-1])["extra"]
    assert extra["served"] == 40 and extra["shed"] == 0 and extra["errors"] == 0
    assert extra["latency_source"] == "hist" and extra["device"] == "cpu"
    assert extra["compile_counts"] == {"1": 1, "4": 1, "8": 1}
    from neutronstarlite_torch.obs import ledger

    rows = [r for r in ledger.read_rows(str(tmp_path / "ledger")) if r["kind"] == "serve"]
    assert len(rows) == 1 and rows[0]["p99_ms"] == extra["p99_ms"]
    assert rows[0]["cfg"].endswith("|closed|r1|cb0") and rows[0]["shed_rate"] == 0
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.serve.server", cfg, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 50 requests (shed 0, errors 0)" in proc.stdout
    # --targets and --trace: the same checkpoint served by a replica child
    # process, driven through the cross-host router, its request chains
    # joined across the two processes' span streams
    tenv = dict(env, NTS_TRACE="1", NTS_METRICS_DIR=str(tmp_path / "fleet"))
    port_file = tmp_path / "r0.port.json"
    child = subprocess.Popen(
        [sys.executable, "-m", "neutronstarlite_torch.serve.crosshost", cfg,
         "--device", "cpu", "--port-file", str(port_file)],
        cwd=REPO, env=tenv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        from neutronstarlite_torch.serve import crosshost

        info = crosshost._wait_port_file(str(port_file), child, time.monotonic() + 120)
        bench = subprocess.run(
            [sys.executable, "-m", "neutronstarlite_torch.tools.serve_bench",
             "--targets", f"127.0.0.1:{info['port']}", "--trace", "--requests", "20",
             "--clients", "2"],
            cwd=REPO, env=tenv, capture_output=True, text=True, timeout=300,
        )
    finally:
        child.terminate()
        child.wait(timeout=60)
    assert bench.returncode == 0, bench.stderr[-2000:]
    extra = json.loads(bench.stdout.strip().splitlines()[-1])["extra"]
    assert extra["served"] == 20 and extra["shed"] == 0 and extra["errors"] == 0
    assert extra["latency_source"] == "fleet_hist" and extra["trace_chains"] == 20
    assert 0 < extra["client_p50_ms"] <= extra["client_p95_ms"] <= extra["client_p99_ms"]
    assert extra["trace_complete_frac"] == 1.0
    rows = [r for r in ledger.read_rows(str(tmp_path / "ledger")) if r["kind"] == "serve"]
    assert rows[-1]["cfg"].startswith("targets1|closed")


def test_server_cli_without_a_card_refuses(tmp_path, monkeypatch):
    from neutronstarlite_torch.serve import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main([_smoke_cfg(tmp_path)])
