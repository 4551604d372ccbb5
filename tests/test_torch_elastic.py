"""The port's elastic plane against the JAX package's (``tests/test_elastic.py``).

- End to end (JAX ``test_elastic.py:113``): ``rank_loss@partition=2,epoch=1``
  on the 4-partition ``ring_blocked_sim`` twin of the planted 200-vertex
  graph (``KERNEL_TILE:16``, drop 0), ``NTS_HEARTBEAT_MISS_K=2``, a
  checkpoint each epoch, under ``supervised_run``: both packages from JAX's
  initial parameters (``params_from_jax``) replan 4 -> 3 and finish; the
  ``heartbeat`` / ``rank_loss`` / ``replan`` / ``fault`` / ``recovery``
  records agree field by field (times aside), ``dist.active_partitions``
  reads 3, and the port's post-replan curve lies within 1e-4 of JAX's.
- The oracle (``:172``), bitwise within the port: a replanned 4-partition
  trainer resumed from a checkpoint against a fresh P'=3 run from a copy.
- The double loss (``:214``) 4 -> 3 -> 2, the dead set's renumbering and
  id translation (``:247``, ``:256``), an out-of-range kill (``:269``), the
  dead set cleared on exit (``:278``), the liveness monitor's units and the
  rank_loss fault (``:295-367``), all on the port alone.
- The funnel: ``NTS_ELASTIC=1`` refuses where JAX refuses it (the
  single-device trainers and the mirror family) and runs on GCNDIST,
  GCNEAGERDIST, GINDIST and COMMNETDIST; on real ranks the replan refuses
  and the supervisor rolls back on the same plan.
- The 2D mesh replan is a reshape: the pinned ``MESH:2,2`` becomes JAX's
  ``choose_mesh_shape`` for 3 devices, with ``from_mesh``/``to_mesh``.

The JAX run is cached at module scope; torch runs on one thread.
"""

from __future__ import annotations

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.models.base import get_algorithm as j_get_algorithm
from neutronstarlite_tpu.parallel import partitioner as j_part
from neutronstarlite_tpu.resilience import elastic as j_elastic
from neutronstarlite_tpu.resilience import events as j_events
from neutronstarlite_tpu.resilience import faults as j_faults
from neutronstarlite_tpu.resilience.supervisor import supervised_run as j_supervised_run
from neutronstarlite_tpu.utils.config import InputInfo as JInfo
from tests.test_models import _planted_data

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.obs.schema import validate_stream
from neutronstarlite_torch.resilience import elastic, events, faults, guards, supervisor
from neutronstarlite_torch.resilience.supervisor import RetriesExhaustedError, supervised_run
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

V, F, C = 200, 8, 3
CURVE_TOL = 1e-4
ENV = ("NTS_FAULT_SPEC", "NTS_ELASTIC", "NTS_HEARTBEAT_MISS_K", "NTS_COLLECTIVE_TIMEOUT_S",
       "NTS_GUARDS", "NTS_METRICS_DIR", "NTS_STRAGGLER", "NTS_DIST_SIMULATE", "NTS_TUNE",
       "NTS_MAX_RESTARTS", "NTS_MESH", "NTS_WIRE_DTYPE", "NTS_NUMERICS", "NTS_DEBUGINFO",
       "NTS_QUANT_PROBE")
# the fields of each record kind that both packages must agree on
FIELDS = {
    "rank_loss": ("partition", "epoch", "reason", "missed_beats"),
    "replan": ("from_partitions", "to_partitions", "lost", "moved_vertices"),
    "recovery": ("action", "attempt", "epoch", "fault", "partitions"),
    "fault": ("kind", "epoch", "partition", "injected", "attempt"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean_env(mp):
    for name in ENV:
        mp.delenv(name, raising=False)
    mp.setenv("NTS_BACKOFF_BASE_S", "0")
    mp.setenv("NTS_NO_NATIVE", "1")
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_tried", False)


def _reset():
    for mod in (faults, j_faults, elastic, j_elastic):
        mod.reset()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Fault plans and the dead set are process-global by design; tests
    must not share them, nor a sink."""
    _clean_env(monkeypatch)
    _reset()
    yield
    _reset()
    events.set_sink(None)
    j_events.set_sink(None)


def _cfg(cls, epochs=6, partitions=4, **kw):
    cfg = cls()
    cfg.algorithm = "GCNDIST"
    cfg.vertices = V
    cfg.layer_string = f"{F}-8-{C}"
    cfg.epochs = epochs
    cfg.learn_rate = 0.01
    cfg.weight_decay = 1e-4
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.0
    cfg.partitions = partitions
    cfg.dist_path = "ring_blocked_sim"
    cfg.kernel_tile = 16
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def rig():
    """The planted 200-vertex graph of JAX's elastic suite (seed 11), built
    by both packages (JAX's NumPy builder)."""
    src, dst, jd = _planted_data(v_num=V, classes=C, f=F, seed=11)
    datum = GNNDatum(feature=jd.feature, label=jd.label, mask=jd.mask)
    return src, dst, jd, datum, j_build_graph(src, dst, V, use_native=False), \
        build_graph(src, dst, V)


def _stream(d) -> list:
    files = sorted(glob.glob(os.path.join(str(d), "*.jsonl")))
    assert files, f"no metrics stream under {d}"
    evs = []
    for f in files:
        with open(f) as fh:
            evs.extend(json.loads(line) for line in fh if line.strip())
    validate_stream(evs)
    return evs


def _of(evs, kind):
    return [e for e in evs if e["event"] == kind]


def _story(evs):
    """The elastic records with their compared fields, in stream order, and
    the (epoch, partition) heartbeats."""
    out = [(e["event"], {k: e.get(k) for k in FIELDS[e["event"]]})
           for e in evs if e["event"] in FIELDS
           and (e["event"] != "recovery" or e.get("action") == "replan")]
    beats = sorted({(e["epoch"], e["partition"]) for e in _of(evs, "heartbeat")})
    return out, beats


def _port(cfg, rig, params=None):
    src, dst, _, datum, _, g = rig
    tr = get_algorithm(cfg.algorithm).from_arrays(cfg, src, dst, datum, device="cpu",
                                                  host_graph=g)
    if params is not None:
        tr.load_params(params)
    return tr


def _e2e_env(mp, obs):
    mp.setenv("NTS_METRICS_DIR", str(obs))
    mp.setenv("NTS_ELASTIC", "1")
    mp.setenv("NTS_HEARTBEAT_MISS_K", "2")
    mp.setenv("NTS_FAULT_SPEC", "rank_loss@partition=2,epoch=1")
    mp.setenv("NTS_MAX_RESTARTS", "2")


@pytest.fixture(scope="module")
def jax_e2e(rig, tmp_path_factory):
    """JAX's supervised 4 -> 3 run (``test_elastic.py:113``): its initial
    parameters, loss curve, final partitions and stream."""
    src, dst, jd, _, jg, _ = rig
    d = tmp_path_factory.mktemp("jax-e2e")
    with pytest.MonkeyPatch.context() as mp:
        _clean_env(mp)
        _e2e_env(mp, d / "obs")
        _reset()
        cfg = _cfg(JInfo, checkpoint_dir=str(d / "ck"), checkpoint_every=1)
        tr = j_get_algorithm("GCNDIST").from_arrays(cfg, src, dst, jd, host_graph=jg)
        params0 = params_from_jax(tr.params)
        res = j_supervised_run(tr)
        out = {"params0": params0, "losses": list(tr.loss_history), "result": res,
               "partitions": tr.dist.partitions, "evs": _stream(d / "obs"),
               "active": tr.metrics.snapshot()["gauges"]["dist.active_partitions"]}
        _reset()
        j_events.set_sink(None)
    return out


def test_rank_loss_replans_to_survivors_and_finishes_as_jax(rig, jax_e2e, tmp_path,
                                                            monkeypatch):
    """``test_elastic.py:113``: partition 2 of 4 dies at epoch 1, the
    monitor trips after two missed beats, the supervisor replans to 3 and
    the run finishes; the records, the gauge and the curve agree with
    JAX's run from the same parameters."""
    _e2e_env(monkeypatch, tmp_path / "obs")
    cfg = _cfg(InputInfo, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    tr = _port(cfg, rig, jax_e2e["params0"])
    res = supervised_run(tr)
    assert np.isfinite(res["loss"])
    assert tr.dist.partitions == cfg.partitions == 3 == jax_e2e["partitions"]
    assert int(tr.dist.offsets[-1]) == V
    assert len(tr.loss_history) == 6
    assert tr.loss_history[-1] < tr.loss_history[0]
    assert tr.metrics.snapshot()["gauges"]["dist.active_partitions"] == 3 == jax_e2e["active"]
    np.testing.assert_allclose(tr.loss_history, jax_e2e["losses"], rtol=0, atol=CURVE_TOL)
    evs = _stream(tmp_path / "obs")
    assert _story(evs) == _story(jax_e2e["evs"])
    story, beats = _story(evs)
    assert ("replan", {"from_partitions": 4, "to_partitions": 3, "lost": 2,
                       "moved_vertices": _of(evs, "replan")[0]["moved_vertices"]}) in story
    assert _of(evs, "replan")[0]["moved_vertices"] > 0
    assert {p for e, p in beats if e == 0} == {0, 1, 2, 3}
    assert {p for e, p in beats if e == 5} == {0, 1, 2}
    assert any(s["name"] == "replan" for s in _of(evs, "span"))


def test_replan_equivalence_oracle_bitwise(rig, tmp_path):
    """``test_elastic.py:172``: a 4-partition trainer replanned to 3 and
    resumed from the step-3 checkpoint against a fresh P'=3 run from a copy
    of it: loss curves and final parameters bitwise."""
    ck_a, ck_b = str(tmp_path / "a"), str(tmp_path / "b")
    _port(_cfg(InputInfo, epochs=3, checkpoint_dir=ck_a, checkpoint_every=1), rig).run()
    shutil.copytree(ck_a, ck_b)
    ta = _port(_cfg(InputInfo, checkpoint_dir=ck_a, checkpoint_every=1), rig)
    assert elastic.replan_survivors(ta, lost_partition=2) == 3
    ta.run()
    tb = _port(_cfg(InputInfo, partitions=3, checkpoint_dir=ck_b, checkpoint_every=1), rig)
    tb.run()
    assert len(ta.loss_history) == len(tb.loss_history) == 3
    assert ta.loss_history == tb.loss_history
    for a, b in zip(ta.flat_params, tb.flat_params):
        assert torch.equal(a, b)


def test_double_rank_loss_replans_twice(rig, tmp_path, monkeypatch):
    """``test_elastic.py:214``: two partitions die before the first
    detection; the dead set renumbers across the replan, so the second loss
    is detected on the degraded plan: 4 -> 3 -> 2, losses named [1, 2]."""
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("NTS_ELASTIC", "1")
    monkeypatch.setenv("NTS_HEARTBEAT_MISS_K", "1")
    monkeypatch.setenv("NTS_FAULT_SPEC",
                       "rank_loss@partition=1,epoch=1;rank_loss@partition=3,epoch=1")
    monkeypatch.setenv("NTS_MAX_RESTARTS", "3")
    tr = _port(_cfg(InputInfo, epochs=5, checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_every=1), rig)
    assert np.isfinite(supervised_run(tr)["loss"])
    assert tr.dist.partitions == 2
    evs = _stream(tmp_path / "obs")
    assert [(r["from_partitions"], r["to_partitions"]) for r in _of(evs, "replan")] \
        == [(4, 3), (3, 2)]
    assert [r["partition"] for r in _of(evs, "rank_loss")] == [1, 2]


def test_dead_set_renumbers_after_loss():
    elastic.kill_partition(1)
    elastic.kill_partition(3)
    elastic.renumber_after_loss(1)
    assert elastic.dead_partitions() == {2}
    elastic.renumber_after_loss(2)
    assert elastic.dead_partitions() == set()


def test_kill_partition_translates_original_ids_after_replan():
    elastic.renumber_after_loss(0)
    elastic.kill_partition(3)
    assert elastic.dead_partitions() == {2}
    elastic.kill_partition(0)
    assert elastic.dead_partitions() == {2}
    assert elastic.current_index_of(0) is None
    assert elastic.current_index_of(2) == 1


def test_rank_loss_out_of_range_partition_refuses():
    elastic.kill_partition(7)
    with pytest.raises(ValueError, match="partition"):
        elastic.alive_partitions(4)


class _FlakyCfg:
    checkpoint_dir = ""
    learn_rate = 0.01


class _FlakyToolkit:
    """Raises a scripted sequence of HealthErrors from run()."""

    def __init__(self, errors):
        self.cfg = _FlakyCfg()
        self.metrics = None
        self.tracer = None
        self.epoch_times, self.loss_history = [], []
        self._first_epoch_trained = None
        self._errors = list(errors)

    def run(self):
        raise self._errors.pop(0)

    def init_model(self):
        pass


def test_supervised_run_clears_dead_set_on_exit():
    elastic.kill_partition(1)
    tk = _FlakyToolkit([guards.NonFiniteLossError("nan", epoch=1),
                        guards.NonFiniteLossError("nan", epoch=1)])
    with pytest.raises(RetriesExhaustedError):
        supervised_run(tk, max_restarts=1, backoff_base_s=0)
    assert elastic.dead_partitions() == set()


# ---- liveness monitor units (test_elastic.py:295-367) ------------------------------


def test_liveness_miss_k_trip(monkeypatch):
    monkeypatch.setenv("NTS_GUARDS", "1")
    mon = elastic.LivenessMonitor(4, miss_k=3)
    mon.epoch_end(0, alive=[0, 1, 2, 3])
    mon.epoch_end(1, alive=[0, 1, 3])
    mon.epoch_end(2, alive=[0, 1, 3])
    with pytest.raises(elastic.RankLossError) as ei:
        mon.epoch_end(3, alive=[0, 1, 3])
    assert (ei.value.partition, ei.value.epoch, ei.value.code) == (2, 3, "rank_loss")


def test_liveness_recovery_resets_miss_count(monkeypatch):
    monkeypatch.setenv("NTS_GUARDS", "1")
    mon = elastic.LivenessMonitor(2, miss_k=2)
    mon.epoch_end(0, alive=[0])
    mon.epoch_end(1, alive=[0, 1])
    mon.epoch_end(2, alive=[0])
    with pytest.raises(elastic.RankLossError):
        mon.epoch_end(3, alive=[0])


def test_collective_timeout_trips_after_first_epoch(monkeypatch):
    monkeypatch.setenv("NTS_GUARDS", "1")
    mon = elastic.LivenessMonitor(2, collective_timeout=0.1)
    mon.epoch_end(0, alive=[0, 1], step_seconds=9.0)
    with pytest.raises(elastic.RankLossError) as ei:
        mon.epoch_end(1, alive=[0, 1], step_seconds=9.0)
    assert ei.value.partition is None


@pytest.mark.parametrize("env,value,fn", [
    ("NTS_HEARTBEAT_MISS_K", "0", "heartbeat_miss_k"),
    ("NTS_HEARTBEAT_MISS_K", "banana", "heartbeat_miss_k"),
    ("NTS_COLLECTIVE_TIMEOUT_S", "-4", "collective_timeout_s"),
    ("NTS_COLLECTIVE_TIMEOUT_S", "2.5", "collective_timeout_s"),
    ("NTS_ELASTIC", "1", "elastic_enabled"),
    ("NTS_ELASTIC", "0", "elastic_enabled"),
])
def test_knobs_equal_jax(monkeypatch, env, value, fn):
    monkeypatch.setenv(env, value)
    assert getattr(elastic, fn)() == getattr(j_elastic, fn)()
    assert elastic.LivenessMonitor(2, miss_k=-3).miss_k == 1


def test_liveness_unarmed_warns_not_raises():
    mon = elastic.LivenessMonitor(2, miss_k=1)
    mon.epoch_end(0, alive=[0])
    mon.epoch_end(1, alive=[0])


def test_rank_loss_fault_kills_sim_partition(monkeypatch):
    monkeypatch.setenv("NTS_FAULT_SPEC", "rank_loss@partition=1,epoch=0")
    faults.fault_point("epoch_loss", epoch=0, value=0.5)
    assert elastic.dead_partitions() == {1}
    assert elastic.alive_partitions(4) == [0, 2, 3]
    elastic.reset()
    assert elastic.alive_partitions(4) == [0, 1, 2, 3]


def test_timeout_without_partition_rolls_back_on_the_same_plan(rig, monkeypatch):
    """A collective timeout names no partition: the supervisor keeps the
    plan (JAX's ``_should_replan``)."""
    monkeypatch.setenv("NTS_ELASTIC", "1")
    tr = _port(_cfg(InputInfo, epochs=1), rig)
    assert supervisor._should_replan(tr, elastic.RankLossError("x", partition=1))
    assert not supervisor._should_replan(tr, elastic.RankLossError("x", partition=None))
    assert not supervisor._should_replan(tr, guards.NonFiniteLossError("nan", epoch=0))


# ---- the funnel and the real-rank caveat ---------------------------------------------


@pytest.mark.parametrize("algorithm,runs", [
    ("GCNDIST", True), ("GCNEAGERDIST", True), ("GINDIST", True), ("COMMNETDIST", True),
    ("GCNCPU", False), ("GATDIST", False), ("GGCNDIST", False), ("TEST_GETDEP", False),
    ("GCNDISTCACHE", False),
])
def test_elastic_funnel_refuses_where_jax_does(rig, monkeypatch, algorithm, runs):
    """``test_elastic.py:339`` and JAX's ``supports_elastic``: NTS_ELASTIC=1
    refuses in one line on the single-device trainers and the mirror
    family, and arms the monitor on the fuse-op dist family."""
    monkeypatch.setenv("NTS_ELASTIC", "1")
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    kw = {} if "DIST" in algorithm and algorithm in ("GCNDIST", "GCNEAGERDIST", "GINDIST",
                                                     "COMMNETDIST") else {
        "dist_path": "", "kernel_tile": 0}
    if algorithm == "GCNCPU":
        kw["partitions"] = 0
    cfg = _cfg(InputInfo, epochs=2, algorithm=algorithm, **kw)
    assert getattr(j_get_algorithm(algorithm), "supports_elastic", False) == runs
    if not runs:
        with pytest.raises(ValueError, match="NTS_ELASTIC=1 is not available") as ei:
            _port(cfg, rig)
        assert "\n" not in str(ei.value)
        return
    tr = _port(cfg, rig)
    tr.run()
    assert tr._liveness is not None and tr._straggler is not None


def test_replan_refuses_on_real_ranks(rig):
    """A live process group cannot evict a member (JAX's caveat): the
    replan refuses in one line, and the supervisor does not try it."""
    tr = _port(_cfg(InputInfo, epochs=1), rig)
    tr.world = object()  # a joined world of ranks
    with pytest.raises(ValueError, match="relaunch") as ei:
        elastic.replan_survivors(tr, 1)
    assert "\n" not in str(ei.value)
    os.environ["NTS_ELASTIC"] = "1"
    try:
        assert not supervisor._should_replan(tr, elastic.RankLossError("x", partition=1))
    finally:
        del os.environ["NTS_ELASTIC"]


def test_mesh_replan_is_a_reshape(rig):
    """A pinned ``MESH:2,2`` cannot survive on 3 devices: the replan takes
    JAX's analytic shape for 3 (``choose_mesh_shape``), and the record
    carries ``from_mesh`` and ``to_mesh``."""
    src, dst, _, _, jg, _ = rig
    tr = _port(_cfg(InputInfo, epochs=2, mesh="2,2"), rig)
    seen = []
    events.set_sink(type("Sink", (), {"event": lambda self, kind, **f: seen.append(
        (kind, f))})())
    elastic.replan_survivors(tr, 1)
    want = j_part.choose_mesh_shape(jg, 3, [F, 8], out_widths=[8, C])
    rec = [f for kind, f in seen if kind == "replan"][0]
    assert (rec["from_mesh"], rec["to_mesh"]) == ("2x2", want.label())
    assert tr.cfg.mesh == want.cfg_value()
    tr.run()
    assert np.isfinite(tr.loss_history[-1])
