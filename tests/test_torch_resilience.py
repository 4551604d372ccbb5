"""The port's resilience plane against the JAX package's: fault specs,
guards, the watchdog, the supervisor and the supervised CLI.

- The fault-spec parsers accept and reject the same specs (one list).
- For the same loss sequences the guards of both packages raise the same
  error at the same epoch; non-finite leaves are named as ``keystr``.
- The reference's three watchdog tests, on the port's watchdog.
- Chaos parity: GCN on Cora under ``nan_loss@epoch=3`` with a checkpoint
  each epoch, both packages from the reference's initial parameters
  (``params_from_jax``) with dropout off: the port's supervised loss curve
  is within 1e-4 of the reference's, its fault and recovery records (one
  recording sink class in both) equal the reference's, and it equals the
  port's own fault-free run bitwise.
- Retries exhausted, restarts on the tables already built, rollback with
  every checkpoint corrupt, a corrupt final save, a stall, LR backoff, and
  a crash in a subprocess of the CLI followed by a resume.
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.gcn import GCNTrainer as JGCN
from neutronstarlite_tpu.nn.param import AdamState as JAdamState
from neutronstarlite_tpu.resilience import events as j_events
from neutronstarlite_tpu.resilience import faults as j_faults
from neutronstarlite_tpu.resilience import guards as j_guards
from neutronstarlite_tpu.resilience import supervisor as j_supervisor
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch import run as t_run
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.nn.param import AdamState
from neutronstarlite_torch.resilience import events, faults, guards, supervisor
from neutronstarlite_torch.utils import checkpoint as t_ckpt
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 32, 16, 7


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    """The fault plans are process-global by design; tests must not share
    them, nor a sink."""
    monkeypatch.delenv("NTS_FAULT_SPEC", raising=False)
    monkeypatch.setenv("NTS_BACKOFF_BASE_S", "0")
    for mod in (faults, j_faults):
        mod.reset()
    yield
    for mod in (faults, j_faults):
        mod.reset()
    events.set_sink(None)
    j_events.set_sink(None)


class Recorder:
    """One sink class for both packages: records the fault and recovery
    records; hands every call on to ``inner`` (the reference's metrics
    registry) when given one."""

    def __init__(self, inner=None):
        self.inner = inner
        self.records = []

    def event(self, event_kind, **fields):
        if event_kind in ("fault", "recovery"):
            self.records.append((event_kind, fields))
        return self.inner.event(event_kind, **fields) if self.inner is not None else None

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---- fault specs --------------------------------------------------------------

SPECS = [
    "", "  ;  ", "nan_loss", "nan_loss@epoch=3", "nan_loss@epoch=1,", "nan_loss@ epoch = 2 ",
    "nan_loss@epoch=3;crash@epoch=5,rank=0;ckpt_corrupt@save=1;stall@epoch=2,ms=5000",
    "nan_loss@times=100", "exc@point=save", "exc@point=sample_produce,epoch=1",
    "ckpt_corrupt@times=99;nan_loss@epoch=1", "nan_loss@layer=1", "nan_loss@point=save",
    "rank_loss@partition=2,epoch=1", "slow_rank@partition=1,ms=20,times=3",
    "net_drop@target=1,times=4", "slow_net@ms=5", "writer_crash@seq=3",
    "meteor_strike@epoch=1", "nan_loss@epoch", "nan_loss@epoch=three", "nan_loss@exhausted=2",
    "nan_loss@fired=0", "nan_loss@kind=crash", "exc@point=nowhere", "stall@ms=fast",
    "crash@rank=0.5", "Nan_loss@epoch=1", "nan_loss@epoch=1;bogus",
]


def _parse(parse, text):
    try:
        return [dataclasses.asdict(s) for s in parse(text)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("text", SPECS)
def test_fault_spec_parsers_agree(text):
    assert _parse(faults.parse_fault_spec, text) == _parse(j_faults.parse_fault_spec, text)


@pytest.mark.parametrize("text,slice_", [
    ("nan_loss@layer=1", "obs slice"), ("rank_loss@partition=2,epoch=1", "distributed"),
    ("slow_rank@partition=1", "distributed"), ("net_drop@target=1", "serving"),
    ("slow_net@ms=5", "serving"), ("writer_crash@seq=3", "stream"),
    ("stall@point=finetune_round,ms=5", "stream"), ("stall@point=http_fetch", "serving"),
    ("exc@point=delta_commit", "stream"), ("exc@point=finetune_round", "stream"),
    ("exc@point=partition_step", "distributed"),
])
def test_unported_faults_are_refused(monkeypatch, text, slice_):
    """Kinds and points of later slices refuse, naming the slice. The obs
    slice's ``nan_loss@layer=k`` is ported: it fires as in the reference,
    replacing the loss with NaN and arming the provenance poison. The
    distributed slice's ``rank_loss``, ``slow_rank`` and the
    ``partition_step`` point are ported too: each fires at its point as in
    the reference (the twin's end-to-end runs are tests/test_torch_elastic.py
    and tests/test_torch_skew.py). So are the stream slice's
    ``writer_crash`` and its ``delta_commit`` and ``finetune_round`` points:
    each package fires them alike (tests/test_torch_stream.py runs the log's
    crash and the worker's deaths end to end)."""
    monkeypatch.setenv("NTS_FAULT_SPEC", text)
    j_faults.parse_fault_spec(text)  # the reference runs it
    if slice_ == "obs slice":
        assert math.isnan(faults.fault_point("epoch_loss", epoch=0, value=1.0))
        assert faults.pending_layer_poison() == 1
        return
    if slice_ == "distributed":
        from neutronstarlite_torch.resilience import elastic

        slept = []
        monkeypatch.setattr(faults.time, "sleep", slept.append)
        elastic.reset()
        try:
            if text.startswith("rank_loss"):
                assert faults.fault_point("epoch_loss", epoch=0, value=1.0) == 1.0
                assert elastic.dead_partitions() == set()  # epoch=1 only
                faults.fault_point("epoch_loss", epoch=1, value=1.0)
                assert elastic.dead_partitions() == {2}
                assert elastic.alive_partitions(4) == [0, 1, 3]
            elif text.startswith("slow_rank"):
                faults.fault_point("partition_step", epoch=0, partition=0)
                assert slept == []
                faults.fault_point("partition_step", epoch=0, partition=1)
                assert slept == [1.0]  # ms defaults to 1000
            else:
                faults.fault_point("epoch_loss", epoch=0, value=1.0)
                with pytest.raises(RuntimeError, match="partition_step"):
                    faults.fault_point("partition_step", epoch=0, partition=3)
        finally:
            elastic.reset()
        return
    if slice_ == "stream":
        class Exited(Exception):
            pass

        def exit_(code):
            raise Exited(code)

        slept = []
        monkeypatch.setattr(os, "_exit", exit_)
        monkeypatch.setattr(time, "sleep", slept.append)

        def fire(mod):
            """What each point does in turn under the spec: None, the
            exception's text, or ('exit', code) / ('slept', seconds)."""
            mod.reset()
            out = []
            for point, ctx in (("delta_commit", dict(seq=1)), ("delta_commit", dict(seq=3)),
                               ("finetune_round", dict(epoch=0))):
                del slept[:]
                try:
                    mod.fault_point(point, **ctx)
                    out.append(("slept", slept[0]) if slept else None)
                except Exited as e:
                    out.append(("exit", e.args[0]))
                except RuntimeError as e:
                    out.append(str(e))
            return out

        got, want = fire(faults), fire(j_faults)
        assert got == want and any(got), got
        return
    # the HTTP fetch comes with the cross-host serving slice
    with pytest.raises(ValueError, match="cross-host serving"):
        faults.fault_point("epoch_loss", epoch=0, value=1.0)


def test_fault_point_without_spec_and_events_without_sink():
    assert faults.fault_point("epoch_loss", epoch=1, value=0.5) == 0.5
    events.set_sink(None)
    assert events.emit_fault("nonfinite_loss", epoch=1) is None
    assert events.emit_recovery("rollback") is None


def test_injected_exception_and_corruption(monkeypatch, tmp_path):
    monkeypatch.setenv("NTS_FAULT_SPEC", "exc@epoch=2;ckpt_corrupt@save=2")
    rec = Recorder()
    events.set_sink(rec)
    assert faults.fault_point("epoch_loss", epoch=1, value=1.0) == 1.0
    with pytest.raises(RuntimeError, match="injected fault: exc"):
        faults.fault_point("epoch_loss", epoch=2, value=1.0)
    faults.fault_point("epoch_loss", epoch=2, value=1.0)  # one-shot
    assert rec.records == [("fault", {"kind": "exc", "point": "epoch_loss", "epoch": 2,
                                      "injected": True, "rank": 0})]
    for step in (1, 2):
        t_ckpt.save_checkpoint(str(tmp_path), {"p": [np.arange(100.0)]}, step)
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        t_ckpt.verify_step_dir(t_ckpt.list_steps(str(tmp_path))[1][1])
    t_ckpt.verify_step_dir(t_ckpt.list_steps(str(tmp_path))[0][1])


# ---- guards -------------------------------------------------------------------

class _FakeToolkit:
    params = None


NAN, INF = float("nan"), float("inf")
GUARD_CASES = {
    "nan": ({}, [1.2, 0.9, NAN, 0.5]),
    "inf": ({}, [1.2, INF]),
    "diverged": ({}, [1.2, 0.9, 40.0, 75.0]),
    "within_warmup": ({}, [1.2, 0.9, 60.0, 0.5]),
    "diverged_large_best": ({}, [200.0, 150.0, 180.0, 9000.0]),
    "factor_2": ({"NTS_DIVERGENCE_FACTOR": "2"}, [1.0, 3.0, 2.0, 2.5, 5.0]),
    "factor_off": ({"NTS_DIVERGENCE_FACTOR": "0"}, [1.0, 900.0, 900.0, 900.0]),
    "stall": ({"NTS_EPOCH_TIMEOUT_S": "0.5"}, [1.0, 0.9, 0.8]),
    "no_loss": ({}, [None, None, None]),
    "healthy": ({}, [3.0, 2.0, 1.0, 0.5]),
}


def _first_trip(mod, losses, seconds):
    tk = _FakeToolkit()
    for epoch, loss in enumerate(losses):
        try:
            mod.epoch_check(tk, epoch, seconds, loss)
        except mod.HealthError as e:
            return type(e).__name__, e.epoch, str(e)
    return None


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guards_trip_like_the_reference(monkeypatch, case):
    env, losses = GUARD_CASES[case]
    monkeypatch.setenv("NTS_GUARDS", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seconds = 9.0 if case == "stall" else 0.01
    got, want = (_first_trip(m, losses, seconds) for m in (guards, j_guards))
    assert got == want
    assert (want is None) == (case in ("within_warmup", "factor_off", "no_loss", "healthy"))


def test_guards_unarmed_never_raise(monkeypatch):
    monkeypatch.delenv("NTS_GUARDS", raising=False)
    guards.epoch_check(_FakeToolkit(), 3, 0.01, NAN)
    monkeypatch.setenv("NTS_GUARDS", "0")
    with guards.armed():
        guards.epoch_check(_FakeToolkit(), 3, 0.01, NAN)


def test_guard_stall_skips_first_epoch_of_attempt(monkeypatch):
    monkeypatch.setenv("NTS_GUARDS", "1")
    monkeypatch.setenv("NTS_EPOCH_TIMEOUT_S", "0.5")
    tk = _FakeToolkit()
    guards.epoch_check(tk, 0, 9.0, 0.5)
    with pytest.raises(guards.StallError):
        guards.epoch_check(tk, 1, 9.0, 0.5)
    guards.new_attempt(tk)
    guards.epoch_check(tk, 1, 9.0, 0.5)


def test_nonfinite_leaf_names_are_keystr(monkeypatch):
    """The same trees with NaN and inf in some leaves (an int leaf, which
    is skipped, included): the port names the leaves jax's keystr does, and
    the guard's error says the same as the reference's."""
    rng = np.random.default_rng(0)
    layers = [{"W": rng.standard_normal((4, 3)).astype(np.float32),
               "bn": {"gamma": np.ones(4, np.float32), "beta": np.zeros(4, np.float32)}},
              {"W": rng.standard_normal((3, 2)).astype(np.float32)}]
    layers[0]["bn"]["gamma"][1] = NAN
    layers[1]["W"][0, 1] = -INF
    tree = {"params": layers, "opt": (layers, 7)}
    got = guards.nonfinite_leaves(jax.tree.map(
        lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, tree))
    want = j_guards.nonfinite_leaves(jax.tree.map(jnp.asarray, tree))
    assert got == want == ["['opt'][0][0]['bn']['gamma']", "['opt'][0][1]['W']",
                           "['params'][0]['bn']['gamma']", "['params'][1]['W']"]
    adam_t = AdamState(m=jax.tree.map(torch.from_numpy, layers), v=jax.tree.map(
        torch.from_numpy, layers), step=np.int32(3))
    adam_j = JAdamState(m=jax.tree.map(jnp.asarray, layers), v=jax.tree.map(jnp.asarray, layers),
                        step=jnp.int32(3))
    assert guards.nonfinite_leaves(adam_t) == j_guards.nonfinite_leaves(adam_j)
    assert guards.nonfinite_leaves([torch.ones(3), torch.tensor([3e38, 3e38])]) == []
    monkeypatch.setenv("NTS_GUARDS", "1")
    tk_t, tk_j = _FakeToolkit(), _FakeToolkit()
    tk_t.params = jax.tree.map(torch.from_numpy, layers)
    tk_j.params = jax.tree.map(jnp.asarray, layers)
    with pytest.raises(guards.NonFiniteParamsError) as e_t:
        guards.epoch_check(tk_t, 0, 0.01, 0.5)
    with pytest.raises(j_guards.NonFiniteParamsError) as e_j:
        j_guards.epoch_check(tk_j, 0, 0.01, 0.5)
    assert str(e_t.value) == str(e_j.value)


# ---- watchdog (the reference's three tests) -----------------------------------

def test_watchdog_trips_on_stale_heartbeat():
    interrupts = []
    wd = guards.Watchdog(0.05, interrupt=lambda: interrupts.append(1))
    wd.start()
    try:
        wd.beat()
        deadline = time.monotonic() + 2.0
        while not wd.tripped and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        wd.stop()
    assert wd.tripped and interrupts == [1]


def test_watchdog_first_epoch_grace():
    interrupts = []
    wd = guards.Watchdog(0.05, interrupt=lambda: interrupts.append(1),
                         first_beat_grace_s=10.0)
    wd.start()
    try:
        time.sleep(0.4)
        assert not wd.tripped
    finally:
        wd.stop()
    assert not interrupts


def test_watchdog_beat_keeps_it_quiet():
    interrupts = []
    wd = guards.Watchdog(0.2, interrupt=lambda: interrupts.append(1))
    wd.start()
    try:
        for _ in range(8):
            time.sleep(0.05)
            wd.beat()
    finally:
        wd.stop()
    assert not wd.tripped and not interrupts


# ---- supervised runs --------------------------------------------------------------

def _cfg(cls, epochs=6, **kw):
    cfg = cls()
    cfg.algorithm = "GCNCPU"
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = epochs
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


@pytest.fixture(scope="module")
def edges():
    return j_load_edges(EDGES)


@pytest.fixture(scope="module")
def host_graph(edges):
    return build_graph(*edges, V)


def _port(edges, host_graph, **kw):
    return GCNTrainer.from_arrays(_cfg(InputInfo, **kw), *edges, _data(GNNDatum),
                                  device="cpu", host_graph=host_graph)


@pytest.fixture(scope="module")
def jax_chaos(edges, tmp_path_factory):
    """The reference under nan_loss@epoch=3, CHECKPOINT_EVERY:1: its
    initial parameters, loss curve and fault/recovery records."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=3")
        mp.setenv("NTS_BACKOFF_BASE_S", "0")
        mp.delenv("NTS_METRICS_DIR", raising=False)
        j_faults.reset()
        cfg = _cfg(JInfo, checkpoint_dir=str(tmp_path_factory.mktemp("jax-chaos")),
                   checkpoint_every=1)
        tr = JGCN.from_arrays(cfg, *edges, _data(JDatum),
                              host_graph=j_build_graph(*edges, V, use_native=False))
        p0 = jax.tree.map(np.asarray, tr.params)
        rec = tr.metrics = Recorder(tr.metrics)
        j_supervisor.supervised_run(tr)
        return p0, list(tr.loss_history), rec.records
    finally:
        mp.undo()
        j_faults.reset()
        j_events.set_sink(None)


def test_chaos_nan_loss_rollback_matches_the_reference(jax_chaos, edges, host_graph,
                                                       tmp_path, monkeypatch):
    p0, j_losses, j_records = jax_chaos
    straight = _port(edges, host_graph)
    params_from_jax(p0, straight)
    straight.run()

    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=3")
    tr = _port(edges, host_graph, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    params_from_jax(p0, tr)
    rec = Recorder()
    events.set_sink(rec)
    result = supervisor.supervised_run(tr)
    assert rec.records == j_records
    assert [r[1].get("kind") or r[1].get("action") for r in rec.records] == \
        ["nonfinite_loss", "rollback"]
    assert rec.records[0][1]["epoch"] == 3
    np.testing.assert_allclose(tr.loss_history, j_losses, rtol=0, atol=1e-4)
    assert tr.loss_history == straight.loss_history  # bitwise
    assert len(tr.epoch_times) == 6
    assert result["loss"] == straight.loss_history[-1]
    for a, b in zip(tr.flat_params, straight.flat_params):
        assert torch.equal(a, b)


def test_rollback_with_dropout_is_bitwise(edges, host_graph, tmp_path, monkeypatch):
    straight = _port(edges, host_graph, drop_rate=0.5)
    straight.run()
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=4")
    tr = _port(edges, host_graph, drop_rate=0.5, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=2)  # rolls back to step 4: replays epoch 4 only
    supervisor.supervised_run(tr)
    assert tr.loss_history == straight.loss_history


def test_retries_exhausted(edges, host_graph, tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@times=100")
    monkeypatch.setenv("NTS_MAX_RESTARTS", "1")
    tr = _port(edges, host_graph, epochs=4, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1)
    rec = Recorder()
    events.set_sink(rec)
    with pytest.raises(supervisor.RetriesExhaustedError, match="nonfinite_loss") as e:
        supervisor.supervised_run(tr)
    assert e.value.codes == ["nonfinite_loss"]
    kinds = [r[1].get("kind") or r[1].get("action") for r in rec.records]
    assert kinds == ["nonfinite_loss", "restart", "nonfinite_loss", "giveup"]


def _cora_cfg(path, epochs, extra=""):
    with open(path, "w") as fh:
        fh.write(
            f"ALGORITHM:GCNCPU\nVERTICES:{V}\nLAYERS:{F}-{H}-{C}\nEPOCHS:{epochs}\n"
            f"EDGE_FILE:{EDGES}\nLABEL_FILE:{FIX}/cora.labeltable\n"
            f"MASK_FILE:{FIX}/cora.mask\nDECAY_EPOCH:-1\nDROP_RATE:0.5\n{extra}"
        )
    return str(path)


def test_cli_returns_1_only_when_retries_are_spent(tmp_path, monkeypatch):
    cfg = _cora_cfg(tmp_path / "c.cfg", 3, f"CHECKPOINT_DIR:{tmp_path}/ck\nCHECKPOINT_EVERY:1\n")
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=1,times=2")
    monkeypatch.setenv("NTS_MAX_RESTARTS", "1")
    assert t_run.main([cfg, "--device", "cpu"]) == 1
    faults.reset()
    monkeypatch.setenv("NTS_MAX_RESTARTS", "2")
    assert t_run.main([cfg, "--device", "cpu"]) == 0


def test_restart_reinitialises_on_the_tables_already_built(edges, host_graph, monkeypatch):
    """No checkpoint: the supervisor re-initialises parameters, optimizer
    and AdamConfig on the same tables; the restarted run equals a fresh
    trainer's fault-free run bitwise."""
    fresh = _port(edges, host_graph, epochs=3, drop_rate=0.5)
    fresh.run()
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=1")
    monkeypatch.setenv("NTS_MAX_RESTARTS", "1")
    tr = _port(edges, host_graph, epochs=3, drop_rate=0.5)
    tables = tr.compute_graph
    monkeypatch.setattr(tr, "build_compute_graph", lambda: pytest.fail("tables rebuilt"))
    rec = Recorder()
    events.set_sink(rec)
    supervisor.supervised_run(tr)
    assert tr.compute_graph is tables
    assert [r[1].get("action") for r in rec.records if r[0] == "recovery"] == ["restart"]
    assert tr.loss_history == fresh.loss_history

    # a re-initialised trainer equals a freshly built one, LR change included
    tr.cfg.learn_rate = 0.005
    tr.init_model()
    new = _port(edges, host_graph, epochs=3, drop_rate=0.5, learn_rate=0.005)
    assert tr.adam_cfg == new.adam_cfg and tr.opt_state.step == new.opt_state.step == 0
    for a, b in zip(tr.flat_params + tr.opt_state.m + tr.opt_state.v,
                    new.flat_params + new.opt_state.m + new.opt_state.v):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in tr.flat_params)


class _Diverging:
    """A stand-in trainer whose first runs diverge (the supervisor's LR
    backoff path), for both packages' supervisors."""

    def __init__(self, fails, error):
        self.cfg = InputInfo(learn_rate=0.01)
        self.fails = fails
        self.error = error
        self.epoch_times, self.loss_history = [], []
        self.rates = []

    def run(self):
        if self.fails:
            self.fails -= 1
            raise self.error("diverged", epoch=4)
        return {"loss": 0.5}

    def init_model(self):
        self.rates.append(self.cfg.learn_rate)

    build_model = init_model


def test_lr_backoff_like_the_reference():
    got = []
    for sup, mod, ev in ((supervisor, guards, events), (j_supervisor, j_guards, j_events)):
        tk = _Diverging(3, mod.DivergenceError)
        rec = Recorder()
        ev.set_sink(rec)
        assert sup.supervised_run(tk, max_restarts=3) == {"loss": 0.5}
        got.append((tk.rates, rec.records))
    assert got[0] == got[1]
    assert got[0][0] == [0.01, 0.005, 0.0025]


def test_every_checkpoint_corrupt_restarts_fresh(edges, host_graph, tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_MAX_RESTARTS", "1")
    monkeypatch.setenv("NTS_FAULT_SPEC", "ckpt_corrupt@times=99;nan_loss@epoch=1")
    tr = _port(edges, host_graph, epochs=3, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1)
    rec = Recorder()
    events.set_sink(rec)
    result = supervisor.supervised_run(tr)
    assert np.isfinite(result["loss"]) and all(np.isfinite(tr.loss_history))
    assert [r[1]["action"] for r in rec.records if r[0] == "recovery"] == \
        ["rollback", "restart"]
    assert [r[1]["kind"] for r in rec.records if r[0] == "fault"].count("ckpt_corrupt") >= 1


def test_corrupt_final_save_falls_back(edges, host_graph, tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("NTS_FAULT_SPEC", "ckpt_corrupt@save=3")
    _port(edges, host_graph, epochs=2, checkpoint_dir=ck, checkpoint_every=1).run()
    monkeypatch.delenv("NTS_FAULT_SPEC")
    faults.reset()
    rec = Recorder()
    events.set_sink(rec)
    t2 = _port(edges, host_graph, epochs=4, checkpoint_dir=ck)
    assert np.isfinite(t2.run()["loss"])
    assert len(t2.epoch_times) == 3  # from step 1: epochs 1..3
    assert any(d.endswith(".corrupt") for d in os.listdir(ck))
    assert [(k, f.get("kind") or f.get("action")) for k, f in rec.records] == \
        [("fault", "ckpt_corrupt"), ("recovery", "ckpt_fallback"), ("recovery", "resume")]


def test_stall_rolls_back(edges, host_graph, tmp_path, monkeypatch):
    """A 2.2 s stall against a 2 s budget (an epoch here takes ~10 ms; one
    intra-op thread, so that workers sharing the cores cannot stretch a
    real epoch past the budget)."""
    monkeypatch.setenv("NTS_FAULT_SPEC", "stall@epoch=2,ms=2200")
    monkeypatch.setenv("NTS_EPOCH_TIMEOUT_S", "2")
    tr = _port(edges, host_graph, epochs=4, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1)
    rec = Recorder()
    events.set_sink(rec)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        supervisor.supervised_run(tr)
    finally:
        torch.set_num_threads(threads)
    assert [r[1].get("kind") or r[1].get("action") for r in rec.records] == \
        ["stall", "rollback"]
    assert len(tr.loss_history) == 4


def test_crash_then_the_next_invocation_resumes(tmp_path):
    """crash@epoch=2 ends the CLI process with 41; the next invocation
    resumes from step 2 and trains epochs 2 and 3 only."""
    cfg = _cora_cfg(tmp_path / "c.cfg", 4, f"CHECKPOINT_DIR:{tmp_path}/ck\nCHECKPOINT_EVERY:1\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "neutronstarlite_torch.run", cfg, "--device", "cpu"]
    r1 = subprocess.run(cmd, env=dict(env, NTS_FAULT_SPEC="crash@epoch=2"), cwd=REPO,
                        capture_output=True, text=True, timeout=300)
    assert r1.returncode == faults.CRASH_EXIT_CODE == 41, r1.stdout[-2000:] + r1.stderr
    assert "FAULT crash" in r1.stdout and "Epoch 3 loss" not in r1.stdout
    env.pop("NTS_FAULT_SPEC", None)
    r2 = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stdout[-2000:] + r2.stderr
    assert "restored checkpoint at epoch 2" in r2.stdout
    assert "RECOVERY resume {'epoch': 2}" in r2.stdout
    trained = [ln.split("Epoch ")[1].split()[0] for ln in r2.stdout.splitlines()
               if " loss " in ln and "Epoch " in ln]
    assert trained == ["2", "3"]
