"""The port's sampled trainer against the JAX package's, on the CPU.

- Batches: the port's ``Sampler`` and ``ParallelEpochSampler`` give the JAX
  NumPy sampler's batches bitwise, from the same seed and from one injected
  Generator; the port's worker pool gives its inline path's batches.
- ``minibatch_gather``: forward and gradient against ``jax.vjp`` of the JAX
  op on random padded batches (f32, rtol 1e-6), empty destinations included.
- The sync trainer: the 10-epoch f32 loss curve within 1e-4 of JAX's
  ``GCNSampleTrainer`` from JAX's initial ``W``s with drop 0, and the same
  eval accuracies. Pipelined losses equal sync losses bitwise.
- The device sampler: exact when the fanout covers the degree, uniform by a
  chi-square test, and within its thinning cap.
- The cfg keys of the slice, and the CLI on the Cora smoke cfgs.

The JAX ``Sampler`` takes its native reservoir sampler whenever it can,
whose draws are not NumPy's: the JAX side runs with
``neutronstarlite_tpu.native.available`` returning False. The JAX runs are
cached at module scope; ``NTS_SAMPLE_WORKERS=0`` unless a test is about
workers. The fused mode and the checkpoints are in
``test_torch_sample_fused.py``.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.gcn_sample import GCNSampleTrainer as JSample
from neutronstarlite_tpu.ops import minibatch as j_mb
from neutronstarlite_tpu.sample import parallel as j_parallel
from neutronstarlite_tpu.sample import sampler as j_sampler
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
from neutronstarlite_torch.ops import minibatch as t_mb
from neutronstarlite_torch.sample import device_sampler as t_ds
from neutronstarlite_torch.sample import parallel as t_parallel
from neutronstarlite_torch.sample import sampler as t_sampler
from neutronstarlite_torch.sample.pipeline import resolve_sample_pipeline
from neutronstarlite_torch.utils import config as t_config
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 1433, 16, 7
EPOCHS = 10


def _cfg(cls, epochs=EPOCHS, mode="", **kw):
    cfg = cls()
    cfg.algorithm = "GCNSAMPLESINGLE"
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.fanout_string = "3-3"
    cfg.batch_size = 32
    cfg.epochs = epochs
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.0
    cfg.sample_pipeline = mode
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the per-batch ops are small, and under the
    suite's parallel workers torch's spinning thread pools slow every
    worker down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    src, dst = load_edges(EDGES)
    return src, dst, build_graph(src, dst, V), j_build_graph(src, dst, V, use_native=False)


@pytest.fixture
def workers0(monkeypatch):
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    monkeypatch.delenv("NTS_SAMPLE_PIPELINE", raising=False)
    monkeypatch.delenv("NTS_FINAL_EVAL", raising=False)


# ---- batches ------------------------------------------------------------------

@pytest.mark.parametrize("fanouts", [[3, 3], [5, 10, 10], [25]])
@pytest.mark.parametrize("how", ["seed", "generator"])
def test_sampler_batches_bitwise_jax(graphs, how, fanouts):
    _, _, g, jg = graphs
    nids = np.arange(0, V, 7)
    if how == "seed":
        t = t_sampler.Sampler(g, nids, 32, fanouts, seed=11)
        j = j_sampler.Sampler(jg, nids, 32, fanouts, seed=11, use_native=False)
    else:
        t = t_sampler.Sampler(g, nids, 32, fanouts, rng=np.random.default_rng(5))
        j = j_sampler.Sampler(jg, nids, 32, fanouts, rng=np.random.default_rng(5))
    assert t.node_caps == j.node_caps
    for epoch in range(2):
        got, want = list(t.sample_epoch()), list(j.sample_epoch())
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)


def test_parallel_sampler_bitwise_jax(graphs, monkeypatch):
    _, _, g, jg = graphs
    monkeypatch.setattr(jax_native, "available", lambda: False)
    nids = np.arange(0, V, 5)
    port = t_parallel.ParallelEpochSampler(g, nids, 32, [3, 3], seed=4, workers=0)
    ref = j_parallel.ParallelEpochSampler(jg, nids, 32, [3, 3], seed=4, workers=0)
    for epoch in (0, 3):
        got, want = list(port.sample_epoch(epoch)), list(ref.sample_epoch(epoch))
        assert len(got) == len(want) == 17
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)


_POOL_CHECK = """
import sys
import numpy as np
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.sample.parallel import ParallelEpochSampler

def main():
    src, dst = load_edges(sys.argv[1])
    g = build_graph(src, dst, 2708)
    nids = np.arange(0, 2708, 5)
    inline = ParallelEpochSampler(g, nids, 32, [3, 3], seed=4, workers=0)
    pool = ParallelEpochSampler(g, nids, 32, [3, 3], seed=4, workers=2, ctx_method=sys.argv[2])
    assert pool.workers == 2
    try:
        for epoch in (0, 3):
            want, got = list(inline.sample_epoch(epoch)), list(pool.sample_epoch(epoch))
            assert len(got) == len(want) == 17
            for a, b in zip(got, want):
                arrays = lambda x: list(x.nodes) + [x.seed_mask, x.seeds] + [
                    getattr(h, f) for h in x.hops for f in ("src_local", "dst_local", "weight")]
                for p, q in zip(arrays(a), arrays(b)):
                    assert p.dtype == q.dtype and np.array_equal(p, q)
    finally:
        pool.close()
    assert pool.workers == 0 and not pool._procs
    print("POOL OK")

if __name__ == "__main__":
    main()
"""


@pytest.mark.parametrize("ctx", ["fork", "spawn"])
def test_port_pool_matches_inline_bitwise(tmp_path, ctx):
    """The port's pool (workers=2) against its inline path, bitwise, in a
    process of its own that imports no jax: a fork in this test process,
    where JAX's threads run, could deadlock a child."""
    import subprocess
    import sys

    script = tmp_path / "pool_check.py"
    script.write_text(_POOL_CHECK)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, str(script), EDGES, ctx], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0 and "POOL OK" in out.stdout, out.stderr[-2000:]


def test_fork_pool_refused_once_cuda_is_initialised(graphs, monkeypatch):
    monkeypatch.setattr(t_parallel, "cuda_initialized", lambda: True)
    s = t_parallel.ParallelEpochSampler(graphs[2], np.arange(64), 32, [3, 3], workers=2,
                                        ctx_method="fork")
    assert s.workers == 0 and s._in_q is None


# ---- minibatch_gather -----------------------------------------------------------

def _random_hop(rng, n_src, n_dst_cap, n_dst, fanout):
    """A hop in the sampler's form: each live dst keeps up to ``fanout``
    edges (some none), grouped by dst, then zero padding."""
    src, dst = [], []
    for d in range(n_dst):
        k = int(rng.integers(0, fanout + 1))
        src += list(rng.integers(0, n_src, size=k))
        dst += [d] * k
    ecap = n_dst_cap * fanout
    w = rng.uniform(0.05, 1.0, size=len(src)).astype(np.float32)
    pad = lambda a, dt: np.concatenate([np.asarray(a, dt), np.zeros(ecap - len(a), dt)])
    return pad(src, np.int64), pad(dst, np.int64), pad(w, np.float32)


@pytest.mark.parametrize("case", range(4))
def test_minibatch_gather_matches_jax_vjp(case):
    rng = np.random.default_rng(case)
    n_src, n_dst_cap, fanout, f = 37, 12, 4, 9
    n_dst = [12, 9, 5, 0][case]  # the last: every destination empty
    s, d, w = _random_hop(rng, n_src, n_dst_cap, n_dst, fanout)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    g = rng.standard_normal((n_dst_cap, f)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: j_mb.minibatch_gather(s, d, w, a, n_dst_cap), x)
    (want_dx,) = vjp(g)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_mb.minibatch_gather(torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(w),
                                xt, n_dst_cap)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-6, atol=1e-6)
    if n_dst == 0:
        assert not out.detach().any()


def test_slot_table_keeps_each_destinations_edges_in_order():
    # live edges of dst 1 are not contiguous; padding in between is dead
    s = torch.tensor([4, 2, 0, 7, 5, 0])
    d = torch.tensor([1, 0, 0, 1, 1, 0])
    w = torch.tensor([0.5, 0.25, 0.0, 1.0, 2.0, 0.0])
    src, wt = t_mb.slot_table(s, d, w, 2)
    assert src.tolist() == [[2, 0, 0], [4, 7, 5]]
    assert wt.tolist() == [[0.25, 0.0, 0.0], [0.5, 1.0, 2.0]]
    with pytest.raises(ValueError, match="rows of slots"):
        t_mb.slot_table(s, d, w, 4)


# ---- the sync and pipelined trainers --------------------------------------------

@pytest.fixture(scope="module")
def jax_sync():
    """The JAX sync trainer (NumPy sampler, no workers) from its own init:
    (initial params, losses, accuracies)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.delenv("NTS_SAMPLE_PIPELINE", raising=False)
        src, dst = j_load_edges(EDGES)
        jg = j_build_graph(src, dst, V, use_native=False)
        tr = JSample.from_arrays(_cfg(JInfo), src, dst, _data(JDatum), host_graph=jg)
        p0 = jax.tree.map(np.asarray, tr.params)
        result = tr.run()
    return p0, np.asarray(tr.loss_history), result["acc"]


def _port(mode, p0=None, epochs=EPOCHS, host_graph=None, **kw):
    src, dst = load_edges(EDGES)
    tr = GCNSampleTrainer.from_arrays(_cfg(t_config.InputInfo, epochs, mode, **kw), src, dst,
                                      _data(GNNDatum), device="cpu", host_graph=host_graph)
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


def test_sync_trainer_loss_curve_and_accuracy_match_jax(jax_sync, workers0):
    p0, want, want_acc = jax_sync
    tr = _port("sync", p0)
    result = tr.run()
    got = np.asarray(tr.loss_history)
    assert len(got) == EPOCHS and want[-1] < want[0] - 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert result["acc"] == want_acc
    n = tr.counts["sample.batches"]
    assert n == EPOCHS * 51
    assert tr.counts["sample.h2d_bytes"] == n * tr._sample_payload_bytes
    assert tr.counts["wire.feature_gather_bytes"] == n * 288 * F * 4  # caps [288, 96, 32]
    assert [sorted(s) for s in tr.stage_history] == [
        ["sample_wait", "step_device", "step_dispatch"]] * EPOCHS


@pytest.mark.parametrize("mode", ["pipelined", "device"])
def test_pipelined_losses_equal_sync_bitwise(graphs, workers0, monkeypatch, mode):
    """Pipelined: the sync trainer's losses and parameters, bitwise; the
    device mode (its own draws) twice over, bitwise, and finite."""
    g = graphs[2]
    monkeypatch.setenv("NTS_FINAL_EVAL", "0")
    runs = []
    for m in (("sync", mode) if mode == "pipelined" else (mode, mode)):
        tr = _port(m, epochs=4, host_graph=g, drop_rate=0.5)
        tr.run()
        runs.append(tr)
    a, b = runs
    assert a.loss_history == b.loss_history
    assert all(np.isfinite(a.loss_history))
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)
    assert b.counts["sample.h2d_bytes"] == 4 * 51 * b._sample_payload_bytes


# ---- the device sampler ------------------------------------------------------------

def _toy_graph(seed, v_num=60, e_num=600):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, v_num, size=(e_num, 2)), axis=0)
    return build_graph(pairs[:, 0], pairs[:, 1], v_num)


def test_device_sampler_exact_when_fanout_covers_degree():
    g = _toy_graph(1)
    ds = t_ds.DeviceUniformSampler.from_host(g)
    fan = int(g.in_degree.max())
    dsts = np.arange(g.v_num)
    src, dst_idx = ds.sample_neighbors(dsts, fan, np.random.default_rng(0), cap=g.v_num)
    hsrc, hdst = t_sampler.Sampler(g, dsts, g.v_num, [fan], seed=1)._sample_neighbors(dsts, fan)
    for v in range(g.v_num):
        assert sorted(src[dst_idx == v].tolist()) == sorted(hsrc[hdst == v].tolist())
    assert np.all(np.diff(dst_idx) >= 0)  # grouped by destination


def test_device_sampler_is_uniform_chi_square():
    """Over 3000 draws of 3 of a vertex's in-neighbours, each neighbour's
    inclusion count is Binomial(3000, 3/deg); the chi-square statistic of
    the counts against that expectation stays under the 0.999 quantile."""
    from scipy.stats import chi2

    g = _toy_graph(2)
    ds = t_ds.DeviceUniformSampler.from_host(g)
    v = int(np.argmax(g.in_degree))
    deg, fan, trials = int(g.in_degree[v]), 3, 3000
    assert deg > 2 * fan
    rng = np.random.default_rng(9)
    counts = {}
    for _ in range(trials):
        src, _ = ds.sample_neighbors(np.array([v]), fan, rng, cap=1)
        assert len(set(src.tolist())) == fan
        for u in src.tolist():
            counts[u] = counts.get(u, 0) + 1
    nbrs = g.row_indices[g.column_offset[v]:g.column_offset[v + 1]]
    assert set(counts) == set(nbrs.tolist())
    expect = trials * fan / deg
    stat = sum((counts[u] - expect) ** 2 / expect for u in counts)
    assert stat < chi2.ppf(0.999, deg - 1), (stat, deg)


def test_device_sampler_respects_its_thinning_cap():
    g = _toy_graph(3, v_num=40)
    ds = t_ds.DeviceUniformSampler.from_host(g, max_width=4)
    assert ds.thinned > 0 and ds.width == 4
    assert int(ds.eff_deg.max()) == 4
    src, dst_idx = ds.sample_neighbors(np.arange(40), 3, np.random.default_rng(2), cap=40)
    edges = set(zip(g.row_indices.tolist(), g.dst_of_edge.tolist()))
    assert all((u, v) in edges for u, v in zip(src.tolist(), dst_idx.tolist()))
    # a row's kept neighbours are a subset of its table row
    table = ds.nbr.numpy()
    for u, v in zip(src.tolist(), dst_idx.tolist()):
        assert u in table[v, : int(ds.eff_deg[v])]


def test_hash_is_the_same_for_ints_and_tensors():
    key = t_ds.fold(7, 3, 11)
    tkey = t_ds.fold(7, torch.tensor(3), torch.tensor(11))
    assert int(tkey) == key
    bits = t_ds.hash_bits(key, (5, 4), "cpu")
    assert bits.min() >= 0 and bits.max() < 2**32
    assert int(bits[1, 2]) == t_ds.mix32(t_ds.mix32(6) ^ key)


# ---- cfg keys and the CLI -----------------------------------------------------------

def test_sampled_cfg_keys_and_refusals(tmp_path, monkeypatch):
    p = tmp_path / "s.cfg"
    p.write_text("ALGORITHM:GCNSAMPLE\nVERTICES:10\nLAYERS:4-3-2\nFANOUT:5-10-10\n"
                 "BATCH_SIZE:16\nSAMPLE_PIPELINE:fused\n")
    cfg = t_config.InputInfo.read_from_cfg_file(str(p))
    ref = JInfo.read_from_cfg_file(str(p))
    assert (cfg.batch_size, cfg.fanouts(), cfg.sample_pipeline) == (
        ref.batch_size, ref.fanouts(), ref.sample_pipeline)
    assert t_config.InputInfo().batch_size == JInfo().batch_size
    p.write_text("SAMPLE_PIPELINE:tpipelined\n")
    with pytest.raises(ValueError, match="SAMPLE_PIPELINE"):
        t_config.InputInfo.read_from_cfg_file(str(p))
    # auto parses; unresolved it is refused, in JAX's words
    p.write_text("SAMPLE_PIPELINE:auto\n")
    auto = t_config.InputInfo.read_from_cfg_file(str(p))
    with pytest.raises(ValueError, match="resolved by the tuner"):
        resolve_sample_pipeline(auto)
    monkeypatch.setenv("NTS_SAMPLE_PIPELINE", "device")
    assert resolve_sample_pipeline(cfg) == "device"
    monkeypatch.setenv("NTS_SAMPLE_PIPELINE", "")
    assert resolve_sample_pipeline(cfg) == "fused"
    monkeypatch.setenv("NTS_SAMPLE_PIPELINE", "bogus")
    with pytest.raises(ValueError, match="NTS_SAMPLE_PIPELINE"):
        resolve_sample_pipeline(cfg)


def test_sampled_trainer_refusals(graphs, workers0):
    src, dst, g, _ = graphs
    with pytest.raises(ValueError, match="FANOUT"):
        _port("sync", fanout_string="", host_graph=g)
    with pytest.raises(ValueError, match="full-batch"):
        _port("sync", optim_kernel=True, host_graph=g)
    # a full-batch trainer refuses SAMPLE_PIPELINE rather than ignore it
    cfg = t_config.InputInfo(algorithm="GCNCPU", vertices=V, layer_string=f"{F}-{H}-{C}",
                             sample_pipeline="pipelined")
    with pytest.raises(ValueError, match="SAMPLE_PIPELINE"):
        GCNTrainer.from_arrays(cfg, src, dst, _data(GNNDatum), device="cpu", host_graph=g)


def test_sampled_cli_without_a_card_raises(monkeypatch):
    from neutronstarlite_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([os.path.join(REPO, "configs", "gcn_sample_fused_smoke.cfg")])


@pytest.mark.parametrize("name", ["gcn_sample_pipeline_smoke", "gcn_sample_fused_smoke"])
def test_sampled_cli_on_the_cpu(name, workers0, capsys):
    from neutronstarlite_torch import run

    lines = []
    import logging

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    logging.getLogger("nts_torch").addHandler(grab)
    try:
        rc = run.main([os.path.join(REPO, "configs", f"{name}.cfg"), "--device", "cpu"])
    finally:
        logging.getLogger("nts_torch").removeHandler(grab)
    assert rc == 0
    for split in ("Train", "Eval", "Test"):
        assert any(ln.startswith(f"{split} Acc:") for ln in lines), split
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("Epoch ")]
    assert len(losses) == 3 and losses[-1] < losses[0]


# ---- the pipeline's scheduling ------------------------------------------------------

class _SleepSource:
    """A deterministic batch source with a sampling cost and a failure."""

    def __init__(self, n, per_batch_s=0.0, fail_at=None):
        self.n, self.per_batch_s, self.fail_at = n, per_batch_s, fail_at

    def sample_epoch(self, epoch):
        import time

        for i in range(self.n):
            time.sleep(self.per_batch_s)
            if i == self.fail_at:
                raise RuntimeError(f"boom at batch {i}")
            yield (epoch, i)


def _pipeline_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "sample-pipeline" and t.is_alive()]


def test_pipeline_order_backpressure_and_drain():
    import time

    from neutronstarlite_torch.sample.pipeline import SamplePipeline

    pipe = SamplePipeline(_SleepSource(20), range(2), depth=2, transfer=lambda b: b)
    time.sleep(0.5)  # no consumer yet: the producer stops at the queue depth
    assert pipe.produced <= 2 and pipe.peak_depth <= 2
    assert list(pipe.epoch_stream(0)) == [(0, i) for i in range(20)]
    stream = pipe.epoch_stream(1)
    next(stream), next(stream)  # an early stop mid-epoch
    pipe.close()
    pipe.close()
    assert not _pipeline_threads()


def test_pipeline_failure_and_order_errors_are_health_faults():
    from neutronstarlite_torch.resilience.guards import HealthError
    from neutronstarlite_torch.sample.pipeline import SamplePipeline, SampleWorkerError

    assert issubclass(SampleWorkerError, HealthError)
    pipe = SamplePipeline(_SleepSource(6, fail_at=2), range(1), depth=2, transfer=lambda b: b)
    with pytest.raises(SampleWorkerError, match="boom at batch 2"):
        list(pipe.epoch_stream(0))
    pipe.close()
    pipe = SamplePipeline(_SleepSource(3), range(2), depth=2, transfer=lambda b: b)
    with pytest.raises(SampleWorkerError, match="out of order"):
        list(pipe.epoch_stream(1))
    pipe.close()
    assert not _pipeline_threads()


def test_pipeline_hides_sample_time():
    """Sampling and the consumer's step each cost T per batch: the stall
    the consumer sees stays well under the serial sample time."""
    import time

    from neutronstarlite_torch.sample.pipeline import SamplePipeline

    n, t = 8, 0.02
    pipe = SamplePipeline(_SleepSource(n, per_batch_s=t), range(1), depth=2,
                          transfer=lambda b: b)
    for _ in pipe.epoch_stream(0):
        time.sleep(t)
    pipe.close()
    assert pipe.stall_s < 0.5 * n * t, pipe.stall_s
