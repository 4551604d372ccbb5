"""The port's fused sampling, and the sampled trainer's checkpoints, against
the JAX package's, on the CPU.

- ``device_dedup_remap`` equals ``np.unique`` + ``np.searchsorted`` and JAX's
  ``device_dedup_remap`` bitwise (duplicates, empty neighbourhoods, id 0,
  over-capacity ranks, adversarial fuzz).
- The device sampler's neighbour table is JAX's, bitwise.
- Given the same draws, ``fused_sample_subgraph`` gives JAX's nodes and
  local indices bitwise, and its weights are the host sampler's bitwise;
  JAX's weights (float32 throughout) sit within 2 float32 ulp of them.
- A fused run repeats bitwise, and its loss tracks the sync run's within
  0.08, as JAX pins for its own fused mode.
- A ``GCNSAMPLE`` checkpoint moves between the two packages in both
  directions (every named leaf bitwise; eval logits within 1e-5), and the
  port's ``verify_checkpoint`` passes the step directory. Six straight sync
  epochs equal three, a restore and three, bitwise. Under
  ``supervised_run``, a ``sample_produce`` fault in the pipelined mode
  rolls back and the run ends equal to a straight one.
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.models.gcn_sample import GCNSampleTrainer as JSample
from neutronstarlite_tpu.models.gcn_sample import _batch_arrays as j_batch_arrays
from neutronstarlite_tpu.sample import device_sampler as j_ds
from neutronstarlite_tpu.sample import fused as j_fused
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
from neutronstarlite_torch.resilience import events, faults
from neutronstarlite_torch.resilience.supervisor import supervised_run
from neutronstarlite_torch.sample import device_sampler as t_ds
from neutronstarlite_torch.sample import fused as t_fused
from neutronstarlite_torch.sample.sampler import Sampler
from neutronstarlite_torch.tools.verify_checkpoint import main as t_verify_main
from neutronstarlite_torch.utils import tree as t_tree
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 1433, 16, 7


def _cfg(cls, epochs=3, mode="", **kw):
    cfg = cls()
    cfg.algorithm = "GCNSAMPLESINGLE"
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.fanout_string = "3-3"
    cfg.batch_size = 32
    cfg.epochs = epochs
    cfg.decay_epoch = 2  # the stepped decay fires inside the runs
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


@pytest.fixture(autouse=True)
def workers0(monkeypatch):
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    monkeypatch.delenv("NTS_SAMPLE_PIPELINE", raising=False)
    monkeypatch.delenv("NTS_FINAL_EVAL", raising=False)
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _port(graphs, mode="sync", **kw):
    src, dst, g, _ = graphs
    return GCNSampleTrainer.from_arrays(_cfg(InputInfo, mode=mode, **kw), src, dst,
                                        _data(GNNDatum), device="cpu", host_graph=g)


# ---- dedup / remap --------------------------------------------------------------

def _host_oracle(src, valid, ncap):
    live = src[valid]
    uniq = np.unique(live)
    out = np.zeros(ncap, dtype=np.int64)
    out[: min(len(uniq), ncap)] = uniq[:ncap]
    local = np.zeros(len(src), dtype=np.int64)
    local[valid] = np.searchsorted(uniq, live)
    return out, local, len(uniq)


def _remap_cases():
    rng = np.random.default_rng(3)
    cases = {
        "duplicates": (np.array([7, 3, 7, 7, 3, 12, 0, 12]), np.ones(8, bool), 8),
        "empty": (np.arange(6), np.zeros(6, bool), 4),
        "thinned": (rng.choice([5, 9, 11], size=64), rng.random(64) < 0.8, 64),
        "slack_ids": (np.array([2_000_000, 3, 2_000_000, 1, 9999, 3]),
                      np.array([True, True, False, True, True, True]), 6),
        "zero_id": (np.array([0, 4, 0, 4, 2]), np.array([True, True, True, False, True]), 5),
        "over_capacity": (np.array([9, 1, 5, 3, 7, 1]), np.ones(6, bool), 3),
    }
    fuzz = np.random.default_rng(11)
    for i in range(25):
        E = int(fuzz.integers(1, 96))
        cases[f"fuzz{i}"] = (fuzz.integers(0, max(E // 2, 2), size=E),
                             fuzz.random(E) < fuzz.random(), E)
    return cases


REMAP_CASES = _remap_cases()


@pytest.mark.parametrize("case", list(REMAP_CASES))
def test_dedup_remap_equals_numpy_and_jax(case):
    src, valid, ncap = REMAP_CASES[case]
    src = src.astype(np.int64)
    uniq, local, n = t_fused.device_dedup_remap(torch.from_numpy(src), torch.from_numpy(valid),
                                                ncap)
    ju, jl, jn = j_fused.device_dedup_remap(jnp.asarray(src, jnp.int32), jnp.asarray(valid),
                                            ncap)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(local.numpy(), np.asarray(jl))
    assert int(n) == int(jn)
    if case != "over_capacity":  # past the capacity numpy has no counterpart
        want_u, want_l, want_n = _host_oracle(src, valid, ncap)
        np.testing.assert_array_equal(uniq.numpy(), want_u)
        np.testing.assert_array_equal(local.numpy(), want_l)
        assert int(n) == want_n


# ---- fused subgraph ---------------------------------------------------------------

def _toy(seed=0, v_num=60, e_num=600):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_num, size=e_num)
    dst = rng.integers(0, v_num, size=e_num)
    return build_graph(src, dst, v_num), j_build_graph(src, dst, v_num, use_native=False)


@pytest.mark.parametrize("max_width", [None, 6])
def test_device_sampler_table_bitwise_jax(max_width):
    g, jg = _toy(1)
    t = t_ds.DeviceUniformSampler.from_host(g, max_width=max_width, seed=3)
    j = j_ds.DeviceUniformSampler.from_host(jg, max_width=max_width, seed=3)
    assert (t.width, t.thinned) == (j.width, j.thinned)
    assert (t.thinned > 0) == (max_width is not None)
    np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr))
    np.testing.assert_array_equal(t.eff_deg.numpy(), np.asarray(j.eff_deg))


@pytest.mark.parametrize("live", [8, 5])
def test_fused_subgraph_given_the_same_draws_is_jaxs(monkeypatch, live):
    """The port draws (its hash); JAX's ``_draw_hop`` is replaced by those
    draws; everything after the draw must agree."""
    g, jg = _toy(2)
    B, fanouts = 8, (3, 2)
    caps = tuple(Sampler(g, np.arange(g.v_num), B, fanouts).node_caps)
    ds = t_ds.DeviceUniformSampler.from_host(g)
    js = j_ds.DeviceUniformSampler.from_host(jg)
    seeds = np.zeros(B, dtype=np.int64)
    seeds[:live] = np.random.default_rng(live).choice(g.v_num, size=live, replace=False)
    draws = []
    real_draw = t_fused._draw_hop

    def record(*args):
        out = real_draw(*args)
        draws.append(out)
        return out

    monkeypatch.setattr(t_fused, "_draw_hop", record)
    nodes, hops = t_fused.fused_sample_subgraph(
        ds.nbr, ds.eff_deg, *t_fused.degree_tables(g, "cpu"), torch.from_numpy(seeds), live,
        t_ds.fold(9, 1), caps, fanouts)
    assert all(int(v.sum()) > 0 for _, v in draws)
    given = iter(draws)
    monkeypatch.setattr(j_fused, "_draw_hop", lambda *a: tuple(
        jnp.asarray(t.numpy()) for t in next(given)))
    jnodes, jhops = j_fused.fused_sample_subgraph(
        js.nbr, js.eff_deg, *j_fused.degree_tables(jg), jnp.asarray(seeds, jnp.int32),
        jnp.int32(live), jax.random.PRNGKey(0), caps, fanouts)
    for a, b in zip(nodes, jnodes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for h, ((s, d, w), (js_, jd, jw)) in enumerate(zip(hops, jhops)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2.5e-7, atol=0)
        # the host sampler's formula, bitwise, on every live edge
        live_e = w.numpy() > 0
        gsrc = nodes[h].numpy()[s.numpy()[live_e]]
        gdst = nodes[h + 1].numpy()[d.numpy()[live_e]]
        want = (1.0 / np.sqrt(np.maximum(g.out_degree[gsrc], 1).astype(np.float64)
                              * np.maximum(g.in_degree[gdst], 1))).astype(np.float32)
        np.testing.assert_array_equal(w.numpy()[live_e], want)
    # the seed hop's live edges land on live seeds only
    assert int(hops[-1][1].numpy()[hops[-1][2].numpy() > 0].max()) < live


@pytest.fixture(scope="module")
def fused_and_sync(graphs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.setenv("NTS_FINAL_EVAL", "0")
        runs = {}
        for name, mode in (("fused", "fused"), ("rerun", "fused"), ("sync", "sync")):
            tr = _port(graphs, mode, epochs=4, drop_rate=0.5)
            tr.run()
            runs[name] = tr
    return runs


def test_fused_rerun_is_bitwise(fused_and_sync):
    a, b = fused_and_sync["fused"], fused_and_sync["rerun"]
    assert a.loss_history == b.loss_history
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)
    r = a._fused
    assert (r.captures, r.replays) == (0, 0)  # on the CPU the step runs eagerly
    assert a.counts == {"sample.batches": 4 * r.n_batches, "sample.h2d_bytes": 0,
                        "wire.feature_gather_bytes": 0}
    assert a.opt_state.step == 4 * r.n_batches == int(a.adam_step_t)


def test_fused_tracks_the_sync_run(fused_and_sync):
    fl, sl = fused_and_sync["fused"].loss_history, fused_and_sync["sync"].loss_history
    assert len(fl) == len(sl) == 4 and fl[-1] < fl[0] - 0.3
    assert max(abs(a - b) for a, b in zip(fl, sl)) <= 0.08, (fl, sl)


# ---- checkpoints ---------------------------------------------------------------------

def _port_named(tr):
    return {name + path: (leaf.detach().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for name, tree in tr.checkpoint_state().items()
            for path, leaf in t_tree.flatten_with_path(tree)}


def _jax_named(state):
    return {name + jax.tree_util.keystr(path): np.asarray(leaf)
            for name, tree in state.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_leaves(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _eval_logits(graphs, jtr, ttr):
    """Both trainers' eval logits on one batch of the eval split."""
    g = graphs[2]
    b = next(Sampler(g, np.where(ttr.datum.mask == 1)[0], 32, [3, 3], seed=5).sample_epoch())
    nodes, hops, _, _ = ttr._to_device(b)
    with torch.no_grad():
        got = ttr._forward(ttr.flat_params, nodes, hops).numpy()
    jn, jh, _, _ = j_batch_arrays(b)
    want = np.asarray(jtr._eval_batch(jtr.params, jtr.feature, jn, jh, jax.random.PRNGKey(0)))
    return got, want


@pytest.fixture(scope="module")
def jax_trained(graphs, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        ck = str(tmp_path_factory.mktemp("jax-sample"))
        src, dst, _, jg = graphs
        tr = JSample.from_arrays(_cfg(JInfo, checkpoint_dir=ck, drop_rate=0.5), src, dst,
                                 _data(JDatum), host_graph=jg)
        tr.run()
    return tr, ck


def test_reference_sampled_checkpoint_restores_in_port(graphs, jax_trained):
    jtr, ck = jax_trained
    tr = _port(graphs)
    assert tr.restore(ck) == 3
    _assert_same_leaves(_port_named(tr), _jax_named(jtr.checkpoint_state()))
    assert tr.opt_state.step == 3 * 51
    got, want = _eval_logits(graphs, jtr, tr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert t_verify_main([ck, "--quiet"]) == 0


def test_port_sampled_checkpoint_restores_in_reference(graphs, jax_trained, tmp_path):
    jtr = jax_trained[0]
    ck = str(tmp_path / "ck")
    tr = _port(graphs, checkpoint_dir=ck, drop_rate=0.5)
    tr.run()
    assert jtr.restore(ck) == 3
    _assert_same_leaves(_jax_named(jtr.checkpoint_state()), _port_named(tr))
    got, want = _eval_logits(graphs, jtr, tr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sampled_resume_is_bitwise(graphs, tmp_path):
    """6 straight sync epochs against 3 + save + restore + 3, dropout 0.5."""
    straight = _port(graphs, epochs=6, drop_rate=0.5)
    straight.run()
    ck = str(tmp_path / "ck")
    first = _port(graphs, checkpoint_dir=ck, drop_rate=0.5)
    first.run()
    second = _port(graphs, epochs=6, checkpoint_dir=ck, drop_rate=0.5)
    second.run()
    assert len(second.loss_history) == 3
    assert first.loss_history + second.loss_history == straight.loss_history
    _assert_same_leaves(_port_named(second), _port_named(straight))


def test_sample_produce_fault_rolls_back_under_supervision(graphs, tmp_path, monkeypatch):
    """exc@point=sample_produce,epoch=2 in the pipelined mode, a checkpoint
    every epoch: one sample_worker fault, one rollback, no producer thread
    left, and the straight run's losses and parameters bitwise."""
    straight = _port(graphs, "pipelined", epochs=4, drop_rate=0.5)
    straight.run()
    records = []

    class Sink:
        def event(self, event_kind, **fields):
            records.append((event_kind, fields.get("kind") or fields.get("action")))

    tr = _port(graphs, "pipelined", epochs=4, drop_rate=0.5,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    monkeypatch.setenv("NTS_FAULT_SPEC", "exc@point=sample_produce,epoch=2")
    faults.reset()
    events.set_sink(Sink())
    try:
        result = supervised_run(tr, backoff_base_s=0.0)
    finally:
        events.set_sink(None)
        monkeypatch.delenv("NTS_FAULT_SPEC")
        faults.reset()
    assert ("fault", "sample_worker") in records and ("recovery", "rollback") in records
    assert np.isfinite(result["loss"])
    assert tr.loss_history == straight.loss_history
    for p, q in zip(tr.flat_params, straight.flat_params):
        assert torch.equal(p, q)
    assert not [t for t in threading.enumerate()
                if t.name == "sample-pipeline" and t.is_alive()]
