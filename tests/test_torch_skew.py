"""The port's straggler plane (``obs/skew.py``, a copy) and the slow_rank
chaos against the JAX package's (``tests/test_skew.py``).

- The copy's math on the same inputs gives JAX's values and records: the
  tolerance, the detector's M-consecutive latch and re-arm, the fleet
  needed, the offline replay over heartbeat seconds and the ring-hop skew;
  the knobs read the same environment.
- The detector's record, gauge and advisory hook (which never raises into
  the step loop); the trip message of a flagged partition that then dies.
- ``slow_rank`` sleeps in exactly one partition's ``partition_step`` and
  parses as JAX's.
- End to end on the 4-partition ``ring_blocked_sim`` twin of the planted
  200-vertex graph: ``slow_rank@partition=k`` yields one ``straggler``
  record naming k and no ``rank_loss``; with ``NTS_ELASTIC=1`` the detector
  arms by default, heartbeats carry their seconds and the offline replay
  agrees with the run.
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from neutronstarlite_tpu.obs import skew as j_skew
from neutronstarlite_tpu.resilience import elastic as j_elastic
from neutronstarlite_tpu.resilience import faults as j_faults
from tests.test_models import _planted_data

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.obs import skew
from neutronstarlite_torch.obs.registry import MetricsRegistry
from neutronstarlite_torch.obs.schema import validate_stream
from neutronstarlite_torch.resilience import elastic, events, faults
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.resilience.supervisor import supervised_run
from neutronstarlite_torch.utils.config import InputInfo

V, F, C = 200, 8, 3
SLEEP_MS = 80  # well above the tolerance floor of the twin's ~10 ms epoch
ENV = ("NTS_FAULT_SPEC", "NTS_ELASTIC", "NTS_STRAGGLER", "NTS_STRAGGLER_K",
       "NTS_STRAGGLER_M", "NTS_STRAGGLER_FLOOR", "NTS_HEARTBEAT_MISS_K", "NTS_GUARDS",
       "NTS_METRICS_DIR", "NTS_DIST_SIMULATE")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NTS_BACKOFF_BASE_S", "0")
    for mod in (faults, j_faults, elastic, j_elastic):
        mod.reset()
    yield
    for mod in (faults, j_faults, elastic, j_elastic):
        mod.reset()
    events.set_sink(None)


def _of(evs, kind):
    return [e for e in evs if e.get("event") == kind]


def _stream(d) -> list:
    evs = []
    for f in sorted(glob.glob(os.path.join(str(d), "*.jsonl"))):
        with open(f) as fh:
            evs.extend(json.loads(line) for line in fh if line.strip())
    validate_stream(evs)
    return evs


# ---- the math, against JAX's on the same inputs ---------------------------------------


@pytest.mark.parametrize("vals", [[1.0, 1.0, 1.0, 10.0], [0.5, 0.7, 0.9], [2.0],
                                  [3.0, 1.0, 2.0, 8.0, 5.0]])
def test_baseline_stats_equal_jax(vals):
    assert skew.baseline_stats(vals) == j_skew.baseline_stats(vals)


@pytest.mark.parametrize("med,mad", [(1.0, 0.0), (1.0, 10.0), (0.0, 1.0), (1.0, 0.1),
                                     (2.5, 0.3)])
def test_effective_tolerance_equals_jax(med, mad):
    got = skew.effective_tolerance(med, mad, 3.0, 0.25, 4.0)
    assert got == j_skew.effective_tolerance(med, mad, 3.0, 0.25, 4.0)
    if mad == 0.0:
        assert got == 0.25  # the floor governs the sim ring


def _even(partitions, t=1.0):
    return {p: t for p in range(partitions)}


SEQUENCES = {
    # the M-consecutive latch and its re-arm (test_skew.py:86)
    "latch": (dict(nsigma=3.0, m=2, floor=0.25),
              [{**_even(4), 2: 2.0}] * 3 + [_even(4)] + [{**_even(4), 2: 2.0}] * 2),
    # a fleet is needed; dead (None) values are skipped (test_skew.py:103)
    "fleet": (dict(m=1), [{0: 5.0}, {0: 5.0, 1: None}, {}]),
    # two slow partitions, one recovering (a longer story)
    "two": (dict(m=2), [{0: 1.0, 1: 3.0, 2: 1.1, 3: 2.9}] * 2
            + [{0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0}] * 2),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_detector_records_equal_jax(name):
    kw, seq = SEQUENCES[name]
    mine, ref = skew.StragglerDetector(4, **kw), j_skew.StragglerDetector(4, **kw)
    got = [mine.observe_epoch(e, s) for e, s in enumerate(seq)]
    assert got == [ref.observe_epoch(e, s) for e, s in enumerate(seq)]
    if name == "latch":
        assert [len(h) for h in got] == [0, 1, 0, 0, 0, 1]
        assert got[1][0]["partition"] == 2 and got[1][0]["threshold_s"] == pytest.approx(1.25)


def test_detector_emits_record_gauge_and_advisory(tmp_path):
    reg = MetricsRegistry("gcndist-f-1", algorithm="GCNDIST", fingerprint="f",
                          path=str(tmp_path / "s.jsonl"))
    flagged = []
    det = skew.StragglerDetector(3, m=1, registry=reg, on_straggler=flagged.append)
    det.observe_epoch(0, {0: 1.0, 1: 1.0, 2: 3.0})
    reg.close()
    assert flagged == [2]
    recs = _of(_stream(tmp_path), "straggler")
    assert len(recs) == 1 and recs[0]["partition"] == 2
    assert recs[0]["source"] == "partition_step"
    assert reg.snapshot()["gauges"]["dist.straggler_partition"] == 2


def test_detector_is_advisory_even_when_the_hook_blows_up():
    def bomb(_p):
        raise RuntimeError("advisory hooks must never reach the step loop")

    det = skew.StragglerDetector(3, m=1, on_straggler=bomb)
    hits = det.observe_epoch(0, {0: 1.0, 1: 1.0, 2: 3.0})
    assert hits and hits[0]["partition"] == 2


@pytest.mark.parametrize("env", [{}, {"NTS_STRAGGLER": "0"}, {"NTS_STRAGGLER": "1"},
                                 {"NTS_STRAGGLER_K": "2.5", "NTS_STRAGGLER_M": "5",
                                  "NTS_STRAGGLER_FLOOR": "0.1"}])
def test_env_knobs_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for default in (False, True):
        assert skew.straggler_enabled(default) == j_skew.straggler_enabled(default)
    mine, ref = skew.StragglerDetector(4), j_skew.StragglerDetector(4)
    assert (mine.nsigma, mine.m, mine.floor) == (ref.nsigma, ref.m, ref.floor)


def _hb(partition, epoch, seconds=None):
    rec = {"event": "heartbeat", "partition": partition, "epoch": epoch}
    if seconds is not None:
        rec["seconds"] = seconds
    return rec


REPLAY = [_hb(p, ep, 2.0 if p == 3 and ep >= 1 else 1.0) for ep in range(4) for p in range(4)]
JUNK = [_hb(0, 0, 1.0), _hb(1, 0, 1.1), _hb(0, 1, 1.2), _hb(0, 2), _hb(1, 1, 0.0),
        {"event": "epoch", "epoch": 0, "seconds": 9.0}]
HOPS = [{"event": "ring_step", "run_id": r, "seconds": s}
        for r, s in (("r0", 0.010), ("r0", 0.012), ("r1", 0.011), ("r2", 0.050))]


@pytest.mark.parametrize("fn,evs,kw", [
    ("partition_epoch_seconds", JUNK, {}),
    ("partition_epoch_seconds", REPLAY, {}),
    ("detect_stragglers", REPLAY, {"m": 2}),
    ("detect_stragglers", REPLAY[:4], {"m": 2}),
    ("hop_skew", HOPS, {}),
    ("hop_skew", HOPS[:2], {}),
])
def test_offline_replay_equals_jax(fn, evs, kw):
    got = getattr(skew, fn)(evs, **kw)
    assert got == getattr(j_skew, fn)(evs, **kw)
    if fn == "detect_stragglers" and len(evs) > 4:
        assert [(h["partition"], h["epoch"], h["source"]) for h in got] == [(3, 2, "heartbeat")]
    if fn == "hop_skew" and got is not None:
        assert got["slow_streams"] == ["r2"]


# ---- the slow_rank fault kind ---------------------------------------------------------


def test_slow_rank_sleeps_in_exactly_one_partitions_step(monkeypatch):
    monkeypatch.setenv("NTS_FAULT_SPEC", "slow_rank@partition=2,ms=60,times=2")
    for epoch in range(3):  # times=2: the third epoch is untouched
        for p in range(4):
            t0 = time.monotonic()
            fault_point("partition_step", epoch=epoch, partition=p)
            dt = time.monotonic() - t0
            if p == 2 and epoch < 2:
                assert dt >= 0.055, "the sleep must land in partition 2"
            else:
                assert dt < 0.05, f"partition {p} epoch {epoch} slept"


@pytest.mark.parametrize("text", ["slow_rank@partition=2,ms=250,times=3", "slow_rank",
                                  "slow_rank@point=partition_step,epoch=4"])
def test_parse_slow_rank_spec_equals_jax(text):
    mine, ref = faults.parse_fault_spec(text), j_faults.parse_fault_spec(text)
    assert [vars(s) for s in mine] == [vars(s) for s in ref]
    assert faults.DEFAULT_POINTS["slow_rank"] == j_faults.DEFAULT_POINTS["slow_rank"] \
        == "partition_step"


def test_trip_message_names_a_flagged_straggler(monkeypatch):
    monkeypatch.setenv("NTS_GUARDS", "1")
    elastic.note_straggler(2)
    assert elastic.stragglers() == {2}
    mon = elastic.LivenessMonitor(4, miss_k=1, collective_timeout=0)
    with pytest.raises(elastic.RankLossError) as ei:
        mon.epoch_end(0, alive=[0, 1, 3])
    assert "flagged as a straggler (slow) before it went silent" in str(ei.value)
    elastic.clear_straggler(2)
    assert elastic.stragglers() == set()


# ---- end to end on the twin -------------------------------------------------------------


@pytest.fixture(scope="module")
def rig():
    src, dst, jd = _planted_data(v_num=V, classes=C, f=F, seed=11)
    return src, dst, GNNDatum(feature=jd.feature, label=jd.label, mask=jd.mask), \
        build_graph(src, dst, V)


def _trainer(rig, epochs=4):
    src, dst, datum, g = rig
    cfg = InputInfo(algorithm="GCNDIST", vertices=V, layer_string=f"{F}-8-{C}",
                    epochs=epochs, learn_rate=0.01, weight_decay=1e-4, decay_epoch=-1,
                    drop_rate=0.0, partitions=4, dist_path="ring_blocked_sim",
                    kernel_tile=16)
    return get_algorithm("GCNDIST").from_arrays(cfg, src, dst, datum, device="cpu",
                                                host_graph=g)


@pytest.mark.parametrize("k", [1, 2])
def test_slow_rank_chaos_flags_the_partition(rig, tmp_path, monkeypatch, k):
    """``test_skew.py:235``: a sleep in partition k's step for 3 epochs
    yields one straggler record naming k; nothing is shed, no rank_loss."""
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("NTS_STRAGGLER", "1")
    monkeypatch.setenv("NTS_STRAGGLER_M", "2")
    monkeypatch.setenv("NTS_FAULT_SPEC", f"slow_rank@partition={k},ms={SLEEP_MS},times=3")
    tr = _trainer(rig)
    tr.run()
    assert tr.dist.partitions == 4
    assert all(np.isfinite(v) for v in tr.loss_history)
    assert tr.metrics.snapshot()["gauges"]["dist.straggler_partition"] == k
    assert elastic.stragglers() == {k}
    evs = _stream(tmp_path / "obs")
    strag = _of(evs, "straggler")
    assert len(strag) == 1 and strag[0]["partition"] == k
    assert strag[0]["consecutive"] >= 2 and strag[0]["excess"] > 0.25
    assert _of(evs, "rank_loss") == []
    injected = _of(evs, "fault")
    assert len(injected) == 3 and all(f["kind"] == "slow_rank" for f in injected)


def test_straggler_default_follows_elastic_and_replay_agrees(rig, tmp_path, monkeypatch):
    """``test_skew.py:279``: with NTS_ELASTIC=1 the detector arms by
    default, heartbeats carry the measured seconds, and the offline replay
    of the stream agrees with the run."""
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("NTS_ELASTIC", "1")
    monkeypatch.setenv("NTS_STRAGGLER_M", "2")
    monkeypatch.setenv("NTS_FAULT_SPEC", f"slow_rank@partition=2,ms={SLEEP_MS},times=3")
    supervised_run(_trainer(rig))
    evs = _stream(tmp_path / "obs")
    assert [e for e in _of(evs, "heartbeat") if "seconds" in e]
    live = _of(evs, "straggler")
    assert live and live[0]["partition"] == 2
    assert _of(evs, "rank_loss") == []
    replay = skew.detect_stragglers(evs, m=2)
    assert replay and replay[0]["partition"] == 2
    assert replay == j_skew.detect_stragglers(evs, m=2)
