"""The port's stream plane (``neutronstarlite_torch/stream`` and
``tools/graph_gen.py``) against the JAX package's, on the CPU.

- The delta log: both packages write byte-identical logs (meta, tail,
  sealed segments) for the same staged deltas, each reads the other's, and
  the port's log keeps JAX's contracts: canonical multi-writer order,
  per-seq digest == fresh build, replay and reopen, atomic commit, the
  torn tail, seal and dedup, and ``writer_crash`` killing a real writer
  mid-commit (whose torn log JAX recovers to the same head).
- graph_gen: the same graph, data and trace, and a byte-identical trace
  log from the CLI.
- Ingest: in-margin appends in the sync, device and fused modes leave
  ``compile_counts`` and every captured tensor's address unchanged, and the
  engine serves bitwise what a fresh engine over the head graph serves;
  overflow degrades loudly; out-of-order entries refuse; the bitset audit.
- The fine-tune worker: ``dirty_biased_seeds`` bitwise JAX's from one
  Generator; a round's loss and parameters within 1e-4 of JAX's worker
  from the same checkpoint (drop_rate 0); the closed loop with its
  records and staleness; a ``finetune_round`` death rolls through, and
  exhausted retries give up loudly; serving engines keep their weights.

The serving legs restore the JAX package's npz checkpoint of
tests/test_torch_serve.py; torch runs on one intra-op thread.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.models.gcn_sample import GCNSampleTrainer as JSample
from neutronstarlite_tpu.resilience import faults as j_faults
from neutronstarlite_tpu.sample.sampler import dirty_biased_seeds as j_dirty_biased_seeds
from neutronstarlite_tpu.serve import delta as j_delta
from neutronstarlite_tpu.stream import finetune as j_finetune
from neutronstarlite_tpu.stream import ingest as j_ingest
from neutronstarlite_tpu.stream import log as j_log
from neutronstarlite_tpu.tools import graph_gen as j_graph_gen
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.utils.config import InputInfo as JInfo
from tests.test_torch_serve import (  # noqa: F401  (module fixtures)
    REPO,
    V,
    _opts,
    _serve_cfg,
    jax_trained,
    planted,
)

from neutronstarlite_torch import obs
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
from neutronstarlite_torch.obs.schema import validate_stream
from neutronstarlite_torch.resilience import events, faults
from neutronstarlite_torch.sample.sampler import dirty_biased_seeds
from neutronstarlite_torch.serve import batcher as t_batcher
from neutronstarlite_torch.serve.delta import GraphDelta
from neutronstarlite_torch.serve.engine import InferenceEngine
from neutronstarlite_torch.stream import log as t_log
from neutronstarlite_torch.stream.finetune import FineTuneWorker
from neutronstarlite_torch.stream.ingest import (
    StreamIngestor,
    dirty_mode_from_env,
    margin_from_env,
)
from neutronstarlite_torch.tools import graph_gen
from neutronstarlite_torch.utils.checkpoint import latest_npz_step
from neutronstarlite_torch.utils.config import InputInfo


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
                "NTS_LEDGER_DIR", "NTS_NUMERICS", "NTS_SAMPLE_DEVICE_MAX_DEG", "NTS_FAULT_SPEC",
                "NTS_STALENESS_TOL"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    faults.reset()
    j_faults.reset()
    yield
    faults.reset()
    j_faults.reset()


def _base(v=40, e=160, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.uint32)
    dst = rng.integers(0, v, e).astype(np.uint32)
    return src, dst, build_graph(src, dst, v, use_native=False), j_build_graph(src, dst, v, use_native=False)


def _writer_deltas(v, writer_seed):
    """Three add-only deltas per writer (valid under any interleaving)."""
    rng = np.random.default_rng(writer_seed)
    return [dict(add=[(int(rng.integers(0, v)), int(rng.integers(0, v))) for _ in range(4)])
            for _ in range(3)]


def _staging(src, dst, v):
    """[(writer, kwargs)] in a stage order: three writers interleaved, then a
    removal and a vertex append with its feature row."""
    per = {w: _writer_deltas(v, s) for w, s in (("alice", 7), ("bob", 8), ("carol", 9))}
    out = [(w, per[w][i]) for i in range(3) for w in ("carol", "alice", "bob")]
    out.append(("dave", dict(add=[(5, v)], remove=[(int(src[0]), int(dst[0]))],
                             add_vertices=1,
                             add_features=np.linspace(-1, 1, 4, dtype=np.float32)[None])))
    return out


def _write(mod, root, graph, staging, seal_after=None):
    log_ = mod.DeltaLog(root, graph)
    delta_cls = GraphDelta if mod is t_log else j_delta.GraphDelta
    for i, (w, kw) in enumerate(staging):
        log_.writer(w).stage(delta_cls.edges(**kw))
        if seal_after is not None and i == seal_after:
            log_.commit()
            log_.seal()
    log_.commit()
    return log_


def _files(root):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "*")))}


# ---- the delta log -----------------------------------------------------------------------

@pytest.mark.parametrize("seal_after", [None, 4])
def test_both_packages_write_byte_identical_logs(tmp_path, seal_after):
    src, dst, g, jg = _base()
    staging = _staging(src, dst, 40)
    t = _write(t_log, str(tmp_path / "t"), g, staging, seal_after)
    j = _write(j_log, str(tmp_path / "j"), jg, staging, seal_after)
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert len(_files(str(tmp_path / "t"))) == (3 if seal_after is not None else 2)
    assert t.digest_sequence() == j.digest_sequence() and t.head_seq == j.head_seq == 10
    if seal_after is None:  # one commit: the canonical (writer, writer_seq) order
        assert [e.writer for e in t.entries()] == ["alice"] * 3 + ["bob"] * 3 + \
            ["carol"] * 3 + ["dave"]


def test_each_package_reads_the_others_log(tmp_path):
    src, dst, g, jg = _base()
    staging = _staging(src, dst, 40)
    _write(t_log, str(tmp_path / "t"), g, staging)
    _write(j_log, str(tmp_path / "j"), jg, staging)
    for ours, theirs, graph in ((t_log, "j", g), (j_log, "t", jg)):
        re = ours.DeltaLog(str(tmp_path / theirs), graph)
        assert re.head_seq == 10 and re.recovered_dropped == 0
        assert [graph_digest(h) for _, h in re.iter_graphs(graph)] == re.digest_sequence()
    a = t_log.read_log_entries(str(tmp_path / "j"), after_seq=8)
    b = j_log.read_log_entries(str(tmp_path / "t"), after_seq=8)
    assert [x.to_json() for x in a] == [y.to_json() for y in b]
    assert a[-1].delta.add_features.dtype == np.float32


def test_interleaved_stage_orders_commit_identically(tmp_path):
    _, _, g, _ = _base()
    per = {w: _writer_deltas(40, s) for w, s in (("alice", 7), ("bob", 8), ("carol", 9))}
    log1 = t_log.DeltaLog(str(tmp_path / "l1"), g)
    for i in range(3):
        for w in ("alice", "bob", "carol"):
            log1.writer(w).stage(GraphDelta.edges(**per[w][i]))
    log1.commit()
    log2 = t_log.DeltaLog(str(tmp_path / "l2"), g)
    for w in ("carol", "bob", "alice"):
        for kw in per[w]:
            log2.writer(w).stage(GraphDelta.edges(**kw))
    log2.commit()
    assert log1.digest_sequence() == log2.digest_sequence()
    assert [(e.seq, e.writer, e.writer_seq) for e in log1.entries()] == \
        [(e.seq, e.writer, e.writer_seq) for e in log2.entries()]


def test_replay_reopen_and_a_wrong_base(tmp_path):
    _, _, g, _ = _base()
    root = str(tmp_path / "log")
    log_ = t_log.DeltaLog(root, g)
    for kw in _writer_deltas(40, 5):
        log_.writer("w0").stage(GraphDelta.edges(**kw))
    log_.commit()
    assert [e.seq for e in log_.entries(after_seq=1)] == [2, 3]
    re = t_log.DeltaLog(root, g)
    assert re.head_seq == 3 and re.head_digest == log_.head_digest
    with pytest.raises(ValueError, match="wrong base graph"):
        t_log.DeltaLog(root, _base(seed=99)[2])


def test_empty_delta_refused_and_an_invalid_commit_is_atomic(tmp_path):
    _, _, g, _ = _base()
    log_ = t_log.DeltaLog(str(tmp_path / "log"), g)
    with pytest.raises(ValueError, match="empty"):
        log_.writer("w0").stage(GraphDelta.edges())
    log_.writer("w0").stage(GraphDelta.edges(add=[(0, 1)]))
    log_.writer("w1").stage(GraphDelta.edges(remove=[(39, 39)]))
    with pytest.raises(ValueError, match="do not exist"):
        log_.commit()
    assert log_.entries() == [] and log_.head_seq == 0 and len(log_.writer("w1").staged) == 1
    log_.writer("w1").staged.clear()
    assert [e.seq for e in log_.commit()] == [1]


def test_torn_tail_seal_and_dedup(tmp_path):
    _, _, g, _ = _base()
    root = str(tmp_path / "log")
    log_ = t_log.DeltaLog(root, g)
    deltas = _writer_deltas(40, 6)
    for kw in deltas[:2]:
        log_.writer("w0").stage(GraphDelta.edges(**kw))
    log_.commit()
    seg = log_.seal()
    assert os.path.basename(seg) == "seg-00000001-00000002.jsonl"
    log_.writer("w0").stage(GraphDelta.edges(**deltas[2]))
    log_.commit()
    tail = os.path.join(root, t_log.TAIL_NAME)
    body = open(tail).read()
    with open(tail, "w") as fh:  # the crash window: seq 1-2 in both files
        fh.write(open(seg).read() + body + '{"seq":4,"writer":"w0","wr')
    assert [e.seq for e in t_log.read_log_entries(root)] == [1, 2, 3]
    re = t_log.DeltaLog(root, g)
    assert re.head_digest == log_.head_digest and re.recovered_dropped == 1
    assert t_log.DeltaLog(root, g).recovered_dropped == 0


_CRASH_SCRIPT = """
import sys
import numpy as np
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.serve.delta import GraphDelta
from neutronstarlite_torch.stream.log import DeltaLog

rng = np.random.default_rng(3)
src = rng.integers(0, 40, 160).astype(np.uint32)
dst = rng.integers(0, 40, 160).astype(np.uint32)
log_ = DeltaLog(sys.argv[1], build_graph(src, dst, 40))
w = log_.writer("w0")
for i in range(3):
    w.stage(GraphDelta.edges(add=[(i, i + 1), (i + 2, i)]))
log_.commit()
print("SURVIVED", log_.head_seq)
"""


def test_writer_crash_mid_commit_leaves_the_committed_prefix(tmp_path):
    """writer_crash@seq=2 kills a port writer with half of seq 2's line on
    disk; the port and JAX both recover seq 1 and drop the torn line."""
    root = str(tmp_path / "log")
    env = dict(os.environ, NTS_FAULT_SPEC="writer_crash@seq=2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _CRASH_SCRIPT, root], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == faults.CRASH_EXIT_CODE, (r.returncode, r.stderr[-2000:])
    assert "SURVIVED" not in r.stdout
    assert "injecting writer crash mid-commit of seq 2" in r.stdout + r.stderr
    raw = open(os.path.join(root, t_log.TAIL_NAME), "rb").read()
    assert raw.count(b"\n") == 1 and not raw.endswith(b"\n")
    import shutil

    shutil.copytree(root, str(tmp_path / "copy"))
    _, _, g, jg = _base()
    re = t_log.DeltaLog(root, g)
    jre = j_log.DeltaLog(str(tmp_path / "copy"), jg)
    assert (re.head_seq, re.recovered_dropped) == (jre.head_seq, jre.recovered_dropped) == (1, 1)
    assert re.head_digest == jre.head_digest
    re.writer("w1").stage(GraphDelta.edges(add=[(0, 3)]))
    assert [e.seq for e in re.commit()] == [2]
    assert t_log.DeltaLog(root, g).head_seq == 2


# ---- graph_gen -------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmat", "powerlaw"])
def test_graph_gen_equals_jax(kind, tmp_path):
    t = graph_gen.synth_data(kind, 300, 1800, 16, 4, seed=5)
    j = j_graph_gen.synth_data(kind, 300, 1800, 16, 4, seed=5)
    for a, b in zip(t[:2], j[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for f in ("feature", "label", "mask"):
        assert np.array_equal(getattr(t[2], f), getattr(j[2], f)), f
    tr = graph_gen.delta_trace(t[0], t[1], 300, 16, rounds=6, writers=2, vertex_every=3, seed=5)
    jr = j_graph_gen.delta_trace(j[0], j[1], 300, 16, rounds=6, writers=2, vertex_every=3,
                                 seed=5)
    graph = build_graph(t[0], t[1], 300, use_native=False)
    tl = graph_gen.write_trace_log(str(tmp_path / "t"), graph, tr)
    jl = j_graph_gen.write_trace_log(str(tmp_path / "j"), j_build_graph(j[0], j[1], 300,
                                                                         use_native=False), jr)
    assert tl.head_seq == jl.head_seq == 12 and tl.head_graph.v_num == 302
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="refusing to regenerate"):
        graph_gen.write_trace_log(str(tmp_path / "t"), graph, tr)


def test_graph_gen_cli_writes_jax_s_files(tmp_path):
    args = ["--kind", "rmat", "--vertices", "200", "--edges", "900", "--feat-dim", "8",
            "--rounds", "4", "--seed", "2", "--json"]
    outs = []
    for mod, name in ((graph_gen, "t"), (j_graph_gen, "j")):
        proc = subprocess.run([sys.executable, "-m", mod.__name__, str(tmp_path / name)] + args,
                              cwd=REPO, capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["head_seq"] == 8
    assert _files(str(tmp_path / "t" / "log")) == _files(str(tmp_path / "j" / "log"))
    a, b = np.load(str(tmp_path / "t" / "base.npz")), np.load(str(tmp_path / "j" / "base.npz"))
    assert all(np.array_equal(a[k], b[k]) for k in b.files)


# ---- ingest ----------------------------------------------------------------------------

def _toolkit(planted, ckpt, mode="", drop_rate=None, datum=None, graph=None):
    src, dst, d0, g, _ = planted
    datum = datum or GNNDatum(feature=d0.feature, label=d0.label, mask=d0.mask)
    graph = graph or g
    cfg = _serve_cfg(InputInfo, ckpt)
    cfg.sample_pipeline = mode
    cfg.vertices = graph.v_num
    if drop_rate is not None:
        cfg.drop_rate = drop_rate
    return GCNSampleTrainer.from_arrays(cfg, graph.row_indices.astype(np.uint32),
                                        graph.dst_of_edge.astype(np.uint32), datum,
                                        device="cpu", host_graph=graph)


def _engine(tk, ckpt, mode, seed=123):
    return InferenceEngine(tk, ckpt, options=_opts(t_batcher, sample_pipeline=mode),
                           rng=np.random.default_rng(seed))


def _quiet_vertices(graph, k=2):
    """The k vertices of least in-degree: wiring appends to them keeps the
    device table's width (a fresh table over the head graph has the same)."""
    return [int(v) for v in np.argsort(graph.in_degree, kind="stable")[:k]]


def _populated_log(root, graph, f, appends=2):
    """A 2-writer stream: each round one vertex append (w1) and two edge
    adds (w2), one commit per round."""
    a, b = _quiet_vertices(graph)
    log_ = t_log.DeltaLog(root, graph)
    v = graph.v_num
    for i in range(appends):
        rng = np.random.default_rng(i)
        log_.writer("w1").stage(GraphDelta.edges(
            add=[(a, v), (v, b)], add_vertices=1,
            add_features=(rng.standard_normal((1, f)) * 0.1).astype(np.float32)))
        log_.writer("w2").stage(GraphDelta.edges(add=[(3 * i, a), (b, 3 * i + 1)]))
        log_.commit()
        v += 1
    return log_


def _captured_ptrs(eng):
    ptrs = [eng.feature.data_ptr()]
    if eng.sampler.hop_sampler is not None:
        ptrs += [t.data_ptr() for t in eng._fused_tables()] if eng.fused else \
            [eng.sampler.hop_sampler.nbr.data_ptr()]
    return ptrs


@pytest.mark.parametrize("mode", ["sync", "device", "fused"])
def test_in_margin_appends_never_touch_the_ladder(planted, jax_trained, tmp_path, mode):
    _, ckpt = jax_trained
    _, _, d0, g, _ = planted
    eng = _engine(_toolkit(planted, ckpt, mode), ckpt, mode)
    ing = StreamIngestor([eng], margin=4, dirty_mode="exact")
    ing.arm()  # BEFORE warmup: the ladder captures the padded slab
    eng.warmup()
    counts, ptrs = dict(eng.compile_counts), _captured_ptrs(eng)
    f = int(eng.feature.shape[1])
    log_ = _populated_log(str(tmp_path / "log"), g, f)
    assert [e.seq for e in ing.consume(str(tmp_path / "log"))] == [1, 2, 3, 4]
    assert dict(eng.compile_counts) == counts and _captured_ptrs(eng) == ptrs
    assert eng.feature.shape[0] == V + 4 and eng.sampler.graph.v_num == V + 2
    assert eng.graph_digest() == log_.head_digest
    rows = np.concatenate([e.delta.add_features for e in log_.entries()
                           if e.delta.add_features is not None])
    datum2 = GNNDatum(feature=np.concatenate([d0.feature, rows]),
                      label=np.concatenate([d0.label, np.zeros(2, np.int32)]),
                      mask=np.concatenate([d0.mask, np.full(2, 2, np.int32)]))
    fresh = _engine(_toolkit(planted, ckpt, mode, datum=datum2, graph=log_.head_graph),
                    ckpt, mode)
    rng = np.random.default_rng(9)
    for ids in [np.array([V, V + 1])] + [rng.integers(0, V + 2, size=int(rng.integers(1, 16)))
                                         for _ in range(3)]:
        np.testing.assert_array_equal(eng.predict(ids), fresh.predict(ids))


def test_margin_overflow_degrades_loudly(planted, jax_trained, tmp_path):
    _, ckpt = jax_trained
    _, _, _, g, _ = planted
    eng = _engine(_toolkit(planted, ckpt), ckpt, "sync")
    ing = StreamIngestor([eng], margin=1, dirty_mode="exact")
    ing.arm()
    eng.warmup()
    log_ = _populated_log(str(tmp_path / "log"), g, int(eng.feature.shape[1]))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("nts_torch.serve").addHandler(handler)
    try:
        ing.consume(str(tmp_path / "log"))
    finally:
        logging.getLogger("nts_torch.serve").removeHandler(handler)
    assert any("OVERFLOWING the capacity margin" in r.getMessage() for r in records
               if r.levelno >= logging.WARNING)
    assert eng.sampler.graph.v_num == V + 2 and eng.feature.shape[0] == V + 2
    assert eng.graph_digest() == log_.head_digest
    assert np.isfinite(eng.predict(np.array([V + 1, 7, 11]))).all()


def test_out_of_order_apply_is_refused(planted, jax_trained, tmp_path):
    _, ckpt = jax_trained
    eng = _engine(_toolkit(planted, ckpt), ckpt, "sync")
    log_ = _populated_log(str(tmp_path / "log"), eng.sampler.graph, 16, appends=1)
    with pytest.raises(ValueError, match="replay the log"):
        StreamIngestor([eng], margin=0, dirty_mode="exact").apply(log_.entries()[1])


def test_bitset_ingest_audits_and_feeds_the_worker(planted, jax_trained, tmp_path):
    _, ckpt = jax_trained
    eng = _engine(_toolkit(planted, ckpt), ckpt, "sync")
    reg = obs.open_run("stream-bitset", eng.cfg)
    ing = StreamIngestor([eng], margin=4, dirty_mode="bitset", buckets=64, audit_every=1,
                         metrics=reg)
    ing.arm()
    log_ = _populated_log(str(tmp_path / "log"), eng.sampler.graph, 16)
    ing.consume(str(tmp_path / "log"))
    assert ing.head_seq == 4 and eng.graph_digest() == log_.head_digest
    assert 0.0 <= ing.tracker.fp_rate <= 1.0
    assert "stream.dirty_fp_rate" in reg.snapshot()["gauges"]
    dirty, lo, hi = ing.take_dirty()
    assert (lo, hi) == (1, 4) and len(dirty) > 0
    d2, lo2, hi2 = ing.take_dirty()
    assert len(d2) == 0 and hi2 < lo2


@pytest.mark.parametrize("env", [
    {}, {"NTS_STREAM_VERTEX_MARGIN": "32"}, {"NTS_STREAM_VERTEX_MARGIN": "junk"},
    {"NTS_STREAM_DIRTY": "bitset"}, {"NTS_STREAM_DIRTY": "fuzzy"},
])
def test_env_knobs_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def knobs(margin, mode):
        try:
            return margin(), mode()
        except ValueError as e:
            return str(e)

    assert knobs(margin_from_env, dirty_mode_from_env) == \
        knobs(j_ingest.margin_from_env, j_ingest.dirty_mode_from_env)


# ---- the fine-tune worker --------------------------------------------------------------

@pytest.mark.parametrize("n,frac,n_dirty", [(20, 0.7, 10), (3, 0.7, 10), (5, 0.7, 0),
                                             (100, 0.5, 40), (50, 1.0, 60), (7, 0.0, 30)])
def test_dirty_biased_seeds_are_jax_s(n, frac, n_dirty):
    seed_nids = np.arange(100)
    dirty = np.arange(0, 2 * n_dirty, 2)
    t = dirty_biased_seeds(seed_nids, dirty, n, frac, np.random.default_rng(4))
    j = j_dirty_biased_seeds(seed_nids, dirty, n, frac, np.random.default_rng(4))
    assert t.dtype == j.dtype and np.array_equal(t, j)
    assert len(t) == min(n, 100) and len(np.unique(t)) == len(t)


class _Source:
    """A fixed dirty region at seqs 1..3 (the ingestor's feed interface)."""

    def __init__(self, dirty):
        self.dirty, self.head_seq, self.taken = dirty, 3, False

    def take_dirty(self):
        if self.taken:
            return np.empty(0, np.int64), 4, 3
        self.taken = True
        return self.dirty, 1, 3


def test_a_round_matches_jax_s_worker(planted, jax_trained, tmp_path, monkeypatch):
    """The same checkpoint (params and Adam state), drop_rate 0, the same
    dirty region and worker seed: the round's loss and parameters within
    1e-4 of JAX's."""
    jtr, ckpt = jax_trained
    src, dst, d0, _, jg = planted
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setenv("NTS_NO_NATIVE", "1")  # the port's NumPy draws
    cfg = _serve_cfg(JInfo, ckpt)
    cfg.drop_rate = 0.0
    jtk = JSample.from_arrays(cfg, src, dst, JDatum(feature=d0.feature, label=d0.label,
                                                    mask=d0.mask), host_graph=jg)
    assert jtk.restore(ckpt) == 2
    tk = _toolkit(planted, ckpt, drop_rate=0.0)
    assert tk.restore(ckpt) == 2
    dirty = np.arange(0, V, 7)
    kw = dict(epochs_per_drain=2, seeds_per_round=48, seed=3)
    j = j_finetune.FineTuneWorker(jtk, _Source(dirty), str(tmp_path / "j"), **kw).drain_once()
    t = FineTuneWorker(tk, _Source(dirty), str(tmp_path / "t"), **kw).drain_once()
    assert (t["batches"], t["dirty"], t["ckpt_step"]) == (j["batches"], j["dirty"], 0) \
        and t["batches"] == 6
    assert abs(t["loss"] - j["loss"]) <= 1e-4, (t["loss"], j["loss"])
    for got, want in zip(tk.params, jtk.params):
        np.testing.assert_allclose(got["W"].detach().numpy(), np.asarray(want["W"]), rtol=0,
                                   atol=1e-4)
    # the published checkpoint holds the fine-tuned weights
    fresh = _toolkit(planted, ckpt, drop_rate=0.0)
    assert fresh.restore(str(tmp_path / "t")) == 0
    for got, want in zip(fresh.params, tk.params):
        assert torch.equal(got["W"], want["W"].detach())


def _stream(metrics_dir):
    evs = []
    for f in sorted(glob.glob(os.path.join(str(metrics_dir), "*.jsonl"))):
        with open(f) as fh:
            evs.extend(json.loads(line) for line in fh if line.strip())
    validate_stream(evs)
    return evs


def _of(evs, kind):
    return [e for e in evs if e["event"] == kind]


def test_drain_checkpoints_and_publishes(planted, jax_trained, tmp_path, monkeypatch):
    _, ckpt = jax_trained
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    tk = _toolkit(planted, ckpt)
    eng = _engine(tk, ckpt, "sync")
    reg = obs.open_run("stream-ft", tk.cfg)
    old = events.get_sink()
    events.set_sink(reg)
    try:
        ing = StreamIngestor([eng], margin=4, dirty_mode="exact", metrics=reg)
        ing.arm()
        eng.warmup()
        root = str(tmp_path / "log")
        log_ = _populated_log(root, eng.sampler.graph, int(eng.feature.shape[1]))
        ing.consume(root)
        ids = np.array([1, 2, 3, V + 1])
        before = eng.clone(rng=np.random.default_rng(1)).predict(ids)
        published = []

        def publish(ckpt_dir):
            published.append(ckpt_dir)
            return {"verdict": "promoted", "ckpt_dir": ckpt_dir}

        ck = str(tmp_path / "ft_ckpt")
        worker = FineTuneWorker(tk, ing, ck, publish=publish, seeds_per_round=24, metrics=reg,
                                seed=3)
        s = worker.drain_once()
        assert (s["seq_lo"], s["seq_hi"]) == (1, 4) and s["dirty"] > 0 and s["batches"] > 0
        assert np.isfinite(s["loss"]) and s["ckpt_step"] == 0 and s["verdict"] == "promoted"
        assert published == [ck] and latest_npz_step(ck) == 0
        assert worker.model_seq == 4 and worker.staleness() == 0
        assert worker.drain_once() is None and latest_npz_step(ck) == 0
        # the engine serves its restored weights, not the fine-tuned ones
        np.testing.assert_array_equal(eng.clone(rng=np.random.default_rng(1)).predict(ids),
                                      before)
        log_.writer("w2").stage(GraphDelta.edges(add=[(1, 2)]))
        log_.commit()
        ing.consume(root)
        assert worker.staleness() == 1
        s2 = worker.drain_once()
        assert (s2["seq_lo"], s2["seq_hi"], s2["ckpt_step"]) == (5, 5, 1)
        assert worker.staleness() == 0
        evs = _stream(tmp_path / "obs")
        fts = _of(evs, "finetune_round")
        assert [e["ckpt_step"] for e in fts] == [0, 1] and fts[0]["seq_hi"] == 4
        assert [e["seq"] for e in _of(evs, "delta_commit")] == [1, 2, 3, 4, 5]
        # the published checkpoint restores into a fresh engine
        served = _engine(_toolkit(planted, ckpt, graph=eng.sampler.graph,
                                  datum=GNNDatum(feature=eng.feature.numpy()[:V + 2],
                                                 label=np.zeros(V + 2, np.int32),
                                                 mask=np.zeros(V + 2, np.int32))), ck, "sync")
        assert served.ckpt_step == 1 and np.isfinite(served.predict(np.array([V + 1]))).all()
    finally:
        events.set_sink(old)


@pytest.mark.parametrize("spec,retries,rounds", [
    ("exc@point=finetune_round", 2, 1), ("exc@point=finetune_round,times=10", 1, 0),
])
def test_a_finetune_death_rolls_through_or_gives_up(planted, jax_trained, tmp_path,
                                                    monkeypatch, spec, retries, rounds):
    _, ckpt = jax_trained
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("NTS_FAULT_SPEC", spec)
    faults.reset()
    tk = _toolkit(planted, ckpt)
    reg = obs.open_run("stream-ft-chaos", tk.cfg)
    old = events.get_sink()
    events.set_sink(reg)
    try:
        ck = str(tmp_path / "ck")
        worker = FineTuneWorker(tk, _Source(np.arange(10)), ck, seeds_per_round=8,
                                max_retries=retries, metrics=reg, seed=1)
        s = worker.drain_once()
        assert worker.rounds == rounds and (s is not None) == bool(rounds)
        assert worker.model_seq == (3 if rounds else 0)
        assert worker.staleness() == (0 if rounds else 3)
        assert latest_npz_step(ck) == (0 if rounds else None)
        evs = _stream(tmp_path / "obs")
        kinds = [(r["kind"], r["point"]) for r in _of(evs, "fault")]
        actions = [r["action"] for r in _of(evs, "recovery")]
        if rounds:
            assert kinds == [("exc", "finetune_round")] and actions == ["restart"]
        else:
            assert kinds == [("exc", "finetune_round")] * 2 and actions == ["restart", "giveup"]
    finally:
        events.set_sink(old)
