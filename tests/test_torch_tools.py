"""The port's measurement and audit tools held against the reference's.

- The drift repair: ``audit_registry`` over each package's registry, fed
  the same gauges and counters, leaves the same ``model_drift`` records
  field by field; a GCNDIST twin run with a bf16 wire and a tiny
  ``NTS_QUANT_TOL`` leaves a ``wire_quant`` record before the
  ``run_summary`` through ``finalize_metrics`` in both packages, and none
  under ``NTS_DRIFT_AUDIT=0``.
- The copied tools: the cases of ``tests/test_drift_audit.py`` and the
  sentinel cases of ``tests/test_perf_ledger.py`` run over both packages
  give the same verdicts and exit codes; ``tests/test_dashboard.py``'s
  cases over the port's hub streams.
- The bench tools on the CPU: ``micro_bench``'s op names and keys are the
  reference's, each timed function's output against its JAX counterpart
  on one shared host graph; ``bench_graph``'s cache; ``bench_matrix``,
  ``bench_sample`` and ``sample_bench`` honour their contracts.

Tolerances of the micro_bench comparisons (each against JAX on the same
bf16 inputs unless named): exact for the plain ELL (both sum in f32 and
round once); the hand-written kernels' plain versions at the bf16 rule of
``chip_smoke.py`` (2**-7 of the reference's rms plus 2**-7 of |ref|: one
bf16 ulp either way, the sum order differs); the library ops at the same
rule. The scatter and the eager edge chains are held against JAX run on
the same values in float32, because the reference accumulates those in
bf16 (ROADMAP, queue 3 caveats), at 2**-6 of (rms + |ref|): the port
rounds each product (scatter) or the softmax weights and products (edge
chains, whose gradient passes them twice) to bf16. The fused edge op
against JAX's fused op at 2**-7 (both accumulate in f32).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.storage import CSCGraph as JCSC
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.obs import exporter as j_exporter
from neutronstarlite_tpu.obs import ledger as j_ledger
from neutronstarlite_tpu.obs import registry as j_registry
from neutronstarlite_tpu.obs import schema as j_schema
from neutronstarlite_tpu.resilience import events as j_events
from neutronstarlite_tpu.tools import bench_matrix as j_bench_matrix
from neutronstarlite_tpu.tools import dashboard as j_dashboard
from neutronstarlite_tpu.tools import drift_audit as j_drift
from neutronstarlite_tpu.tools import metrics_report as j_report
from neutronstarlite_tpu.tools import perf_sentinel as j_sentinel
from neutronstarlite_tpu.tune import cache as j_cache
from neutronstarlite_tpu.utils.config import InputInfo as JInfo
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.obs import exporter, ledger, registry, schema
from neutronstarlite_torch.obs.hub import TelemetryHub
from neutronstarlite_torch.resilience import events, faults
from neutronstarlite_torch.tools import (bench_graph, bench_matrix, bench_sample, dashboard,
                                         drift_audit, metrics_report, micro_bench,
                                         perf_sentinel, sample_bench)
from neutronstarlite_torch.tune import cache
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(REPO, "neutronstarlite_tpu", "tools")
SMOKE_CFG = os.path.join(REPO, "configs", "gcn_cora_smoke.cfg")

J = types.SimpleNamespace(registry=j_registry, drift=j_drift, cache=j_cache, schema=j_schema,
                          report=j_report, ledger=j_ledger, sentinel=j_sentinel)
T = types.SimpleNamespace(registry=registry, drift=drift_audit, cache=cache, schema=schema,
                          report=metrics_report, ledger=ledger, sentinel=perf_sentinel)
TIME_KEYS = {"ts", "first_ts", "last_ts", "wall", "uptime_s"}
# the ledger's backend fingerprint names the package's framework
MACHINE_KEYS = TIME_KEYS | {"backend"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for k in ("NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_DRIFT_AUDIT", "NTS_DRIFT_TOL",
              "NTS_QUANT_TOL", "NTS_QUANT_PROBE", "NTS_STALENESS_TOL", "NTS_TUNE",
              "NTS_TUNE_DIR", "NTS_NUMERICS", "NTS_FAULT_SPEC", "NTS_SAMPLE_PIPELINE",
              "NTS_DIST_SIMULATE", "NTS_PROGRAM_COST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NTS_BENCH_CACHE", str(tmp_path / "bench_cache"))
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    faults.reset()
    yield
    faults.reset()
    events.set_sink(None)
    j_events.set_sink(None)


def _strip(obj, keys=TIME_KEYS):
    """``obj`` without its wall-clock fields (or ``keys``) at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, keys) for v in obj]
    return obj


def _read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _both(fn, tmp_path):
    """``fn(pkg, directory)`` on each package in a directory of its own."""
    out = []
    for name, pkg in (("jax", J), ("port", T)):
        d = tmp_path / name
        d.mkdir()
        out.append(fn(pkg, d))
    return out


# ---- the drift repair: audit_registry over both registries -------------------------

AUDIT_CASES = {
    # (gauges, counters, epochs, env)
    "mispriced_wire": ({"wire.bytes_per_epoch_fwd": 1000}, {"wire.bytes_fwd": 4000}, 2, {}),
    "underpriced_wire": ({"wire.bytes_per_epoch_fwd": 1000}, {"wire.bytes_fwd": 1000}, 2, {}),
    "quant_over_tol": ({"wire.quant_rel_err": 0.02}, {}, 3, {}),
    "quant_tiny_tol": ({"wire.quant_rel_err": 1.7e-3}, {}, 3, {"NTS_QUANT_TOL": "1e-4"}),
    "quant_zero_tol": ({"wire.quant_rel_err": 1.7e-3}, {}, 3, {"NTS_QUANT_TOL": "0"}),
    "both": ({"wire.bytes_per_epoch_fwd": 1000, "wire.quant_rel_err": 0.5},
             {"wire.bytes_fwd": 9000}, 3, {"NTS_DRIFT_TOL": "0.2"}),
    "agreement": ({"wire.bytes_per_epoch_fwd": 1000, "wire.quant_rel_err": 1e-3},
                  {"wire.bytes_fwd": 2000}, 2, {}),
    "disabled": ({"wire.bytes_per_epoch_fwd": 1000, "wire.quant_rel_err": 0.5},
                 {"wire.bytes_fwd": 9000}, 3, {"NTS_DRIFT_AUDIT": "0"}),
    "no_epochs": ({"wire.bytes_per_epoch_fwd": 1000}, {"wire.bytes_fwd": 9000}, 0, {}),
}
AUDIT_EXPECT = {"mispriced_wire": ["wire_accounting"], "underpriced_wire": ["wire_accounting"],
                "quant_over_tol": ["wire_quant"], "quant_tiny_tol": ["wire_quant"],
                "quant_zero_tol": ["wire_quant"], "both": ["wire_accounting", "wire_quant"],
                "agreement": [], "disabled": [], "no_epochs": []}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_registry_records_equal_the_reference(case, tmp_path, monkeypatch):
    gauges, counters, epochs, env = AUDIT_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def run(pkg, d):
        reg = pkg.registry.MetricsRegistry("rr", algorithm="G", fingerprint="f",
                                           path=str(d / "s.jsonl"))
        for k, v in gauges.items():
            reg.gauge_set(k, v)
        for k, v in counters.items():
            reg.counter_add(k, v)
        drifts = pkg.drift.audit_registry(reg, epochs=epochs)
        reg.close()
        # a registry with no record to write leaves no file
        recs = _read(d / "s.jsonl") if (d / "s.jsonl").exists() else []
        assert pkg.schema.validate_stream(recs) == len(recs)
        return drifts, [_strip(r) for r in recs if r["event"] == "model_drift"]

    (jd, jr), (td, tr) = _both(run, tmp_path)
    assert td == jd and tr == jr
    assert [d["source"] for d in td] == AUDIT_EXPECT[case]
    assert [r["source"] for r in tr] == AUDIT_EXPECT[case]


# ---- the drift repair end to end: finalize_metrics on the GCNDIST twin --------------

DIST_V = 120


def _dist_cfg(cls):
    cfg = cls()
    for k, v in dict(algorithm="GCNDIST", vertices=DIST_V, layer_string="8-8-3", epochs=3,
                     decay_epoch=-1, drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4,
                     partitions=2, dist_path="ring_blocked_sim", kernel_tile=16,
                     wire_dtype="bf16").items():
        setattr(cfg, k, v)
    return cfg


def _dist_stream(tmp, jax_side: bool, audit: bool):
    """One GCNDIST twin run (bf16 wire, the quant probe on, NTS_QUANT_TOL
    1e-6) through its trainer's run(), so through finalize_metrics; the
    run's stream."""
    from tests.test_models import _planted_data

    src, dst, jd = _planted_data(v_num=DIST_V, classes=3, f=8, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_METRICS_DIR", str(tmp))
        mp.setenv("NTS_QUANT_PROBE", "1")
        mp.setenv("NTS_QUANT_TOL", "1e-6")
        if not audit:
            mp.setenv("NTS_DRIFT_AUDIT", "0")
        if jax_side:
            from neutronstarlite_tpu.models.gcn_dist import DistGCNTrainer

            mp.setenv("NTS_NO_NATIVE", "1")
            mp.setattr(jax_native, "_lib", None)
            mp.setattr(jax_native, "_tried", False)
            g = j_build_graph(src, dst, DIST_V, use_native=False)
            DistGCNTrainer.from_arrays(_dist_cfg(JInfo), src, dst, jd, host_graph=g).run()
            j_events.set_sink(None)
        else:
            datum = GNNDatum(feature=jd.feature, label=jd.label, mask=jd.mask)
            get_algorithm("GCNDIST").from_arrays(
                _dist_cfg(InputInfo), src, dst, datum, device="cpu",
                host_graph=build_graph(src, dst, DIST_V)).run()
            events.set_sink(None)
    (path,) = glob.glob(os.path.join(str(tmp), "*.jsonl"))
    return _read(path)


@pytest.fixture(scope="module", params=[True, False], ids=["audit", "audit_off"])
def dist_streams(request, tmp_path_factory):
    audit = request.param
    with pytest.MonkeyPatch.context() as mp:
        for k in ("NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_DRIFT_AUDIT", "NTS_DRIFT_TOL",
                  "NTS_FAULT_SPEC", "NTS_NUMERICS", "NTS_DIST_SIMULATE"):
            mp.delenv(k, raising=False)
        # with the audit off, the reference's own tests cover its stream
        j = _dist_stream(tmp_path_factory.mktemp("jax-dist"), True, audit) if audit else None
        t = _dist_stream(tmp_path_factory.mktemp("port-dist"), False, audit)
    return audit, j, t


def test_finalize_metrics_leaves_the_wire_quant_drift_record(dist_streams):
    """In both packages the run's stream carries the measured wire quant
    error as a model_drift record of source wire_quant just before the
    run_summary (the error over NTS_QUANT_TOL 1e-6), and no such record
    under NTS_DRIFT_AUDIT=0 (the port's run; the reference's tests hold its
    own); the records agree field by field but for the measured error,
    which agrees within 1e-6."""
    audit, j, t = dist_streams
    for recs in ([j] if audit else []) + [t]:
        assert schema.validate_stream(recs) == len(recs)
        kinds = [r["event"] for r in recs]
        drift = [i for i, r in enumerate(recs) if r["event"] == "model_drift"]
        if not audit:
            assert drift == []
            continue
        assert [recs[i]["source"] for i in drift] == ["wire_quant"]
        # only the summary's histogram snapshots sit between the two
        between = kinds[drift[0] + 1:kinds.index("run_summary")]
        assert set(between) <= {"hist"}
        rec = recs[drift[0]]
        gauge = next(r for r in recs if r["event"] == "run_summary")["gauges"]
        assert rec["observed"] == gauge["wire.quant_rel_err"] > 1e-6
        assert rec["predicted"] == rec["threshold"] == 1e-6
    if audit:
        assert [r["event"] for r in t if r["event"] in ("model_drift", "run_summary")] == \
            [r["event"] for r in j if r["event"] in ("model_drift", "run_summary")]
        (jr,) = [_strip(r) for r in j if r["event"] == "model_drift"]
        (tr,) = [_strip(r) for r in t if r["event"] == "model_drift"]
        skip = {"observed", "drift", "run_id", "seq"}
        assert {k: v for k, v in tr.items() if k not in skip} == \
            {k: v for k, v in jr.items() if k not in skip}
        assert tr["observed"] == pytest.approx(jr["observed"], abs=1e-6)


# ---- the drift auditor's cases over both packages (tests/test_drift_audit.py) -------

FAMILY = "dist_dense/DistGCNTrainer"


def _trial(reg, candidate, seconds, predicted, partitions=4):
    reg.event("tune_trial", family=FAMILY, candidate=candidate, source="measured",
              seconds=seconds, predicted_bytes=predicted, partitions=partitions)


def _summary(reg, predicted, observed_total, epochs=2):
    reg.event(
        "run_summary", algorithm="GCNDIST", fingerprint="f",
        counters={"wire.bytes_fwd": observed_total},
        gauges={"wire.bytes_per_epoch_fwd": predicted}, timings={}, epochs=epochs,
        epoch_time={"first_s": 1.0, "warm_median_s": 0.5, "compile_overhead_s": 0.5},
        phases={}, memory={"available": False, "bytes_in_use": None,
                           "peak_bytes_in_use": None, "devices": []},
    )


def _trials_stream(pkg, d, trials, run_id="r1", name="s.jsonl"):
    reg = pkg.registry.MetricsRegistry(run_id, algorithm="GCNDIST", fingerprint="f",
                                       path=str(d / name))
    for t in trials:
        _trial(reg, *t)
    reg.close()
    return _read(d / name)


INVERTED = [("all_gather|-|-|-", 0.080, 100), ("ring_blocked|-|-|bf16", 0.040, 200)]


def _prior_cases():
    def inverted(pkg, d):
        return pkg.drift.tune_prior_drift(_trials_stream(pkg, d, INVERTED), threshold=0.1)

    def correct(pkg, d):
        return pkg.drift.tune_prior_drift(
            _trials_stream(pkg, d, [("a", 0.040, 100), ("b", 0.080, 200)]), threshold=0.1)

    def cross_run(pkg, d):
        evs = []
        for i, (fast, slow) in enumerate(((0.040, 0.080), (0.030, 0.060))):
            evs += _trials_stream(pkg, d, [("a", fast, 100), ("b", slow, 200)],
                                  run_id=f"run-{i}", name=f"s{i}.jsonl")
        return pkg.drift.tune_prior_drift(evs, threshold=0.1)

    def single(pkg, d):
        reg = pkg.registry.MetricsRegistry("r3", algorithm="G", fingerprint="f",
                                           path=str(d / "s.jsonl"))
        _trial(reg, "a", 0.040, 999)
        reg.event("tune_trial", family=FAMILY, candidate="b", source="prior", seconds=None,
                  predicted_bytes=1, partitions=4)
        reg.close()
        return pkg.drift.tune_prior_drift(_read(d / "s.jsonl"), threshold=0.1)

    def flagged(pkg, d):
        key = pkg.cache.CacheKey(graph_digest="g", family=FAMILY, partitions=4,
                                 layers="16-8-4", backend="b")
        path = pkg.cache.store(key, {"candidate": "all_gather|-|-|-"}, directory=str(d),
                               autos=["dist_path"])
        pkg.cache.store(dataclasses.replace(key, partitions=3),
                        {"candidate": "all_gather|-|-|-"}, directory=str(d),
                        autos=["dist_path"])
        drifts = pkg.drift.audit_events(_trials_stream(pkg, d, INVERTED), threshold=0.1)
        flagged = pkg.drift.flag_tune_cache(drifts, str(d))
        with open(path) as fh:
            flag = json.load(fh).get("drift_flag") or {}
        return ([os.path.basename(p) for p in flagged], drifts, flag.get("reason"))

    return {"inverted": (inverted, lambda r: [d["candidate"] for d in r] == [INVERTED[0][0]]),
            "correct": (correct, lambda r: r == []),
            "cross_run": (cross_run, lambda r: r == []),
            "single": (single, lambda r: r == []),
            "flagged": (flagged, lambda r: len(r[0]) == 1 and r[2] is not None)}


PRIOR_CASES = _prior_cases()


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_drift_audit_prior_cases_equal_the_reference(case, tmp_path):
    fn, expect = PRIOR_CASES[case]
    j, t = _both(fn, tmp_path)
    assert t == j
    assert expect(t)


@pytest.mark.parametrize("counter,gauge,epochs", [(2100, 1000, 2), (4000, 1000, 2),
                                                  (1000, 1000, 2), (0, 0, 3), (5, 0, 1)])
def test_wire_drift_equals_the_reference(counter, gauge, epochs):
    args = ({"wire.bytes_fwd": counter}, {"wire.bytes_per_epoch_fwd": gauge}, epochs, 0.1)
    assert drift_audit.wire_drift(*args) == j_drift.wire_drift(*args)


def _stream_events(head, model, rid="r1"):
    evs = [{"run_id": rid, "event": "delta_commit", "seq": s} for s in range(1, head + 1)]
    if model:
        evs.append({"run_id": rid, "event": "finetune_round", "round": 0, "seq_hi": model})
    return evs


@pytest.mark.parametrize("evs,tol,lag", [
    (_stream_events(10, 8), 2, None),
    (_stream_events(10, 4), 2, 6),
    (_stream_events(5, 0), 2, 5),
    ([{"run_id": "r2", "event": "run_summary",
       "gauges": {"stream.head_seq": 12, "stream.model_seq": 3}}], 4, 9),
])
def test_staleness_equals_the_reference(evs, tol, lag):
    got = drift_audit.staleness_drift(evs, tol=tol)
    assert got == j_drift.staleness_drift(evs, tol=tol)
    assert [d["lag"] for d in got] == ([] if lag is None else [lag])


def test_drift_audit_cli_exit_codes_and_emission_equal_the_reference(tmp_path, capsys):
    def run(pkg, d):
        obs_dir = d / "obs"
        obs_dir.mkdir()
        _trials_stream(pkg, obs_dir, INVERTED)
        rc = pkg.drift.main([str(obs_dir), "--no-flag", "--emit", "--json"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        (emitted,) = [p for p in os.listdir(obs_dir) if "driftaudit" in p]
        recs = _read(obs_dir / emitted)
        assert schema.validate_stream(recs) == j_schema.validate_stream(recs) == len(recs)
        clean = d / "clean"
        clean.mkdir()
        reg = pkg.registry.MetricsRegistry("rc", algorithm="G", fingerprint="f",
                                           path=str(clean / "s.jsonl"))
        _summary(reg, predicted=1000, observed_total=2000, epochs=2)
        reg.close()
        rc_clean = pkg.drift.main([str(clean), "--no-flag"])
        rc_empty = pkg.drift.main([str(d / "nothing")])
        capsys.readouterr()
        return rc, _strip(out), recs[-1]["event"], rc_clean, rc_empty

    j, t = _both(run, tmp_path)
    assert t == j
    assert t[0] == 3 and t[2] == "model_drift" and t[3] == 0 and t[4] == 1
    assert [d["metric"] for d in t[1]["drift"]] == ["tune_prior_ranking"]


def test_port_report_renders_the_port_drift_block(tmp_path, capsys):
    reg = registry.MetricsRegistry("rd", algorithm="G", fingerprint="f",
                                   path=str(tmp_path / "s.jsonl"))
    reg.event("epoch", epoch=0, seconds=0.5, loss=1.0)
    reg.gauge_set("wire.bytes_per_epoch_fwd", 1000)
    reg.counter_add("wire.bytes_fwd", 4000)
    drift_audit.audit_registry(reg, epochs=2)
    reg.close()
    assert metrics_report.main([str(tmp_path / "s.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "prediction drift:" in out
    assert "#model_drift=wire_bytes_fwd_per_epoch" in out


# ---- the sentinel's cases over both packages (tests/test_perf_ledger.py) -----------

NOISE = (1.00, 0.96, 1.04, 1.08, 0.92)
CHECK = dict(k=8, min_baseline=2, nsigma=3.0, floor=0.08, max_tol=0.5)


def _run_row(warm_s, wire=1000, **over):
    row = {"kind": "run", "ts": 0.0, "run_id": "r", "algorithm": "GCNCPU", "cfg": "cfgfp",
           "graph_digest": "digest", "backend": "cpu-test", "epochs": 2,
           "warm_median_epoch_s": warm_s, "wire_bytes_fwd_per_epoch": wire}
    row.update(over)
    return row


def _serve_row(led, p99, **over):
    row = led.serve_row(latency_ms={"p50": p99 * 0.4, "p95": p99 * 0.8, "p99": p99},
                        shed_rate=0.0, throughput_rps=100.0, requests=200,
                        cfg_fingerprint="cfgfp", graph_digest="digest", mode="open",
                        replicas=3, continuous_batching=True, delta_rate=2.0,
                        deltas_applied=10)
    row["backend"] = "cpu-test"
    row.update(over)
    return row


def _sentinel_cases():
    def check(pkg, d, kind="run"):
        return pkg.sentinel.check(pkg.ledger.read_rows(directory=str(d)), kind, **CHECK)

    def seeded(pkg, d, base=0.1):
        for m in NOISE:
            pkg.ledger.append_row(_run_row(base * m), directory=str(d))

    def noise(pkg, d):
        seeded(pkg, d)
        pkg.ledger.append_row(_run_row(0.11), directory=str(d))
        return check(pkg, d)

    def regression(pkg, d):
        seeded(pkg, d)
        pkg.ledger.append_row(_run_row(0.125), directory=str(d))
        return (pkg.sentinel.main(["check", "--ledger", str(d)]),
                pkg.sentinel.main(["check", "--ledger", str(d), "--json"]), check(pkg, d))

    def thin(pkg, d):
        pkg.ledger.append_row(_run_row(0.1), directory=str(d))
        pkg.ledger.append_row(_run_row(10.0), directory=str(d))
        return pkg.sentinel.main(["check", "--ledger", str(d)]), check(pkg, d)

    def key_mismatch(pkg, d):
        for m in NOISE:
            pkg.ledger.append_row(_run_row(0.01 * m, graph_digest="OTHER"), directory=str(d))
        pkg.ledger.append_row(_run_row(0.1), directory=str(d))
        return check(pkg, d)

    def wire(pkg, d):
        seeded(pkg, d)
        pkg.ledger.append_row(_run_row(0.1, wire=2000), directory=str(d))
        return check(pkg, d)

    def hist_p99(pkg, d):
        for m in NOISE:
            pkg.ledger.append_row(_run_row(0.1 * m, hist_quantiles={"serve.latency_ms": {
                "count": 100, "p50": 5.0, "p95": 9.0, "p99": 10.0 * m}}), directory=str(d))
        pkg.ledger.append_row(_run_row(0.1, hist_quantiles={"serve.latency_ms": {
            "count": 100, "p50": 5.0, "p95": 9.0, "p99": 30.0}}), directory=str(d))
        return check(pkg, d)

    def suite_margin(pkg, d):
        pkg.ledger.append_row(pkg.ledger.suite_row(1000.0, 420, 0, 1200.0), directory=str(d))
        a = check(pkg, d, "suite")
        pkg.ledger.append_row(pkg.ledger.suite_row(700.0, 420, 0, 1200.0), directory=str(d))
        return a, check(pkg, d, "suite")

    def suite_fatal(pkg, d):
        pkg.ledger.append_row(pkg.ledger.suite_row(1100.0, 420, 0, 1200.0), directory=str(d))
        return (pkg.sentinel.main(["check", "--ledger", str(d), "--kind", "suite"]),
                pkg.sentinel.main(["check", "--ledger", str(d), "--kind", "suite",
                                   "--suite-fatal"]))

    def dots_and_failed(pkg, d):
        for _ in range(3):
            pkg.ledger.append_row(pkg.ledger.suite_row(600.0, 420, 0, 1200.0), directory=str(d))
        for _ in range(2):
            pkg.ledger.append_row(pkg.ledger.suite_row(1200.0, 150, 124, 1200.0),
                                  directory=str(d))
        pkg.ledger.append_row(pkg.ledger.suite_row(900.0, 420, 0, 1200.0), directory=str(d))
        a = check(pkg, d, "suite")
        pkg.ledger.append_row(pkg.ledger.suite_row(600.0, 390, 0, 1200.0), directory=str(d))
        return a, check(pkg, d, "suite")

    def missing(pkg, d):
        return (pkg.sentinel.main(["check", "--ledger", str(d / "nope")]),
                pkg.sentinel.main(["list-keys", "--ledger", str(d / "nowhere")]))

    def record_suite(pkg, d):
        rc = pkg.sentinel.main(["record-suite", "--ledger", str(d), "--duration", "612",
                                "--dots", "431", "--rc", "0", "--timeout", "1200"])
        rows = pkg.ledger.read_rows(directory=str(d))
        return rc, [(r["kind"], r["suite_duration_s"], r["dots_passed"]) for r in rows]

    def serve_p99(pkg, d):
        for m in NOISE:
            pkg.ledger.append_row(_serve_row(pkg.ledger, 40.0 * m), directory=str(d))
        a = pkg.sentinel.main(["check", "--ledger", str(d), "--kind", "serve"])
        pkg.ledger.append_row(_serve_row(pkg.ledger, 80.0), directory=str(d))
        return a, pkg.sentinel.main(["check", "--ledger", str(d), "--kind", "serve"])

    def list_keys(pkg, d):
        for i in range(3):
            pkg.ledger.append_row(_run_row(0.1, ts=float(100 + i)), directory=str(d))
        pkg.ledger.append_row(_run_row(0.2, cfg="othercfg", ts=50.0), directory=str(d))
        pkg.ledger.append_row(_serve_row(pkg.ledger, 10.0, ts=200.0), directory=str(d))
        pkg.ledger.append_row(pkg.ledger.fleet_row(3, 3, 0, 1, {"serve.latency_ms": {
            "count": 10, "p50": 1.0, "p95": 2.0, "p99": 3.0}}), directory=str(d))
        keys = pkg.sentinel.list_keys(pkg.ledger.read_rows(directory=str(d)))
        return (sorted((g["kind"], g["cfg"], g["rows"]) for g in keys),
                pkg.sentinel.main(["list-keys", "--ledger", str(d), "--json"]))

    return {
        "noise": (noise, lambda r: r["regressed"] == [] and r["metrics"][
            "warm_median_epoch_s"]["tol"] > 0.10),
        "regression_25pct": (regression, lambda r: r[0] == 2 and r[1] == 2 and set(
            r[2]["regressed"]) == {"warm_median_epoch_s"}),
        "thin_history": (thin, lambda r: r[0] == 0),
        "key_mismatch": (key_mismatch, lambda r: r["regressed"] == [] and r["baseline_n"] == 0),
        "wire_counter": (wire, lambda r: r["regressed"] == ["wire_bytes_fwd_per_epoch"]),
        "hist_p99": (hist_p99, lambda r: r["regressed"] == ["hist_serve.latency_ms_p99"]),
        "suite_margin": (suite_margin, lambda r: r[0].get("suite_margin_exceeded") is True
                         and not r[1].get("suite_margin_exceeded")),
        "suite_fatal": (suite_fatal, lambda r: r == (0, 2)),
        "dots_and_failed_suites": (dots_and_failed, lambda r: r[0]["regressed"] == [
            "suite_duration_s"] and any("dots_passed" in w for w in r[1]["warnings"])),
        "missing_ledger": (missing, lambda r: r == (1, 1)),
        "record_suite": (record_suite, lambda r: r == (0, [("suite", 612.0, 431)])),
        "serve_p99": (serve_p99, lambda r: r == (0, 2)),
        "list_keys": (list_keys, lambda r: len(r[0]) == 4 and r[1] == 0),
    }


SENTINEL_CASES = _sentinel_cases()


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_perf_sentinel_cases_equal_the_reference(case, tmp_path, capsys):
    """Each sentinel case of the reference's tests over each package's
    ledger and sentinel: the same verdicts (check dicts but for times),
    the same exit codes."""
    fn, expect = SENTINEL_CASES[case]
    j, t = _both(fn, tmp_path)
    capsys.readouterr()
    assert _strip(t, MACHINE_KEYS) == _strip(j, MACHINE_KEYS)
    assert expect(t)


# ---- the dashboard over the port's streams (tests/test_dashboard.py) ---------------


def _hub_stream(tmp_path, lose_r1=True, mods=(registry, exporter, TelemetryHub)):
    """A real merged hub stream: one live source, one (optionally) dying."""
    reg_mod, exp_mod, hub_cls = mods
    reg = reg_mod.MetricsRegistry("serve-r0-9", algorithm="SERVE", fingerprint="f",
                                  path=str(tmp_path / "src.jsonl"))
    for v in (5.0, 7.0, 9.0, 250.0):
        reg.hist_observe("serve.latency_ms", v)

    def fetch(url):
        if lose_r1 and "r1" in url:
            raise OSError("down")
        from collections import OrderedDict
        import time

        return exp_mod.telemetry_ndjson(OrderedDict([("", (reg, None))]), time.time())

    hub_path = tmp_path / "hub.jsonl"
    h = hub_cls(["r0.local:1", "r1.local:1"], miss_k=1,
                registry=reg_mod.MetricsRegistry("hub-none-9", algorithm="HUB",
                                                 fingerprint="f", path=str(hub_path)),
                fetch=fetch)
    try:
        h.poll_once()
        h.poll_once()
        h.registry.event("heartbeat", partition=0, epoch=0, seconds=1.0)
        h.registry.event("heartbeat", partition=1, epoch=0, seconds=2.1)
        h.registry.event("heartbeat", partition=0, epoch=1, seconds=1.0)
        h.registry.event("heartbeat", partition=1, epoch=1, seconds=2.2)
        h.registry.event("straggler", partition=1, epoch=1, seconds=2.2, median_s=1.0,
                         mad_s=0.0, threshold_s=1.25, excess=1.2, consecutive=2,
                         source="heartbeat")
    finally:
        h.registry.close()
    reg.close()
    return hub_path


def test_dashboard_fabric_model_over_a_port_hub_stream(tmp_path):
    events_ = dashboard.load_stream_events([str(_hub_stream(tmp_path))])
    model = dashboard.fabric_model(events_)
    assert model["polls"] == 2
    assert model["last"]["targets_ok"] == 1 and model["last"]["targets_lost"] == 1
    (target, info), = model["targets"].items()
    assert "r1.local" in target and info["state"] == "LOST"
    q = model["quantiles"]["serve.latency_ms"]
    assert q["count"] == 4 and abs(q["p99"] - 250.0) / 250.0 <= 0.011
    assert model["heat"][1][1] == pytest.approx(2.2)
    assert [s["partition"] for s in model["stragglers"]] == [1]
    # the reference's dashboard reads the port's stream into the same model
    assert _strip(j_dashboard.fabric_model(j_dashboard.load_stream_events(
        [str(tmp_path / "hub.jsonl")]))) == _strip(model)


def test_dashboard_models_of_both_hubs_agree(tmp_path):
    """The same fetch script through each package's hub: the port's
    dashboard makes the same model of either stream."""
    from neutronstarlite_tpu.obs.hub import TelemetryHub as JHub

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = _hub_stream(tmp_path / "j", mods=(j_registry, j_exporter, JHub))
    tp = _hub_stream(tmp_path / "t")
    jm = dashboard.fabric_model(dashboard.load_stream_events([str(jp)]))
    tm = dashboard.fabric_model(dashboard.load_stream_events([str(tp)]))
    assert _strip(tm) == _strip(jm)


def test_dashboard_rejoin_supersedes_loss():
    evs = [{"event": "target_loss", "target": "t", "ts": 1.0, "missed_polls": 3},
           {"event": "recovery", "action": "target_rejoin", "target": "t", "ts": 2.0}]
    model = dashboard.fabric_model(evs)
    assert model["targets"]["t"]["state"] == "ok" and model["targets"]["t"]["rejoined"]
    evs[0]["ts"], evs[1]["ts"] = 2.0, 1.0
    assert dashboard.fabric_model(evs)["targets"]["t"]["state"] == "LOST"


def test_dashboard_html_holds_every_panel(tmp_path):
    evs = dashboard.load_stream_events([str(_hub_stream(tmp_path))])
    rows = [{"kind": "fleet", "hist_quantiles": {"serve.latency_ms": {
        "count": 4, "p50": 7.0, "p95": 250.0, "p99": 250.0}}}]
    doc = dashboard.render_html(dashboard.fabric_model(evs, rows))
    assert doc.startswith("<!doctype html>")
    for needle in ("DEGRADED", "fleet topology", "fleet health (per poll)",
                   "latency quantiles (exact merge)", "straggler heat strip",
                   "serve.latency_ms", "LOST", "slow-but-alive, advisory",
                   "<svg class=\"spark\"", "NOT the /metrics ladder's"):
        assert needle in doc, needle
    assert "<link" not in doc and "<script" not in doc
    empty = dashboard.render_html(dashboard.fabric_model([]))
    for needle in ("no hub poll records", "no targets seen", "no histograms",
                   "no per-partition timings"):
        assert needle in empty


def test_dashboard_sparkline_and_watch_line(tmp_path):
    assert "polyline" not in dashboard.sparkline([])
    assert "polyline" not in dashboard.sparkline([None, None])
    for vals in ([3.0], [2.0, 2.0, 2.0], [1.0, None, 2.0]):
        assert "polyline" in dashboard.sparkline(vals)
    evs = dashboard.load_stream_events([str(_hub_stream(tmp_path))])
    line = dashboard.watch_line(dashboard.fabric_model(evs))
    assert "1/2 ok" in line and "(1 LOST)" in line
    assert "serve.latency_ms p99=" in line and "stragglers=1" in line
    assert dashboard.watch_line(dashboard.fabric_model([])).endswith("no hub polls yet")


def test_dashboard_cli_renders_watches_and_refuses(tmp_path, monkeypatch, capsys):
    path = _hub_stream(tmp_path)
    out = tmp_path / "dash.html"
    assert dashboard.main(["--stream", str(path), "--out", str(out)]) == 0
    doc = out.read_text()
    assert "straggler heat strip" in doc and "DEGRADED" in doc
    assert "wrote" in capsys.readouterr().err
    (tmp_path / "w").mkdir()
    path = _hub_stream(tmp_path / "w", lose_r1=False)
    assert dashboard.main(["--stream", str(path), "--watch", "--polls", "2",
                           "--interval", "0"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 2 and all("2/2 ok" in ln for ln in lines)
    assert dashboard.main(["--stream", str(tmp_path / "missing.jsonl")]) == 1
    assert "cannot load input" in capsys.readouterr().err


def test_dashboard_reads_a_live_port_exporter():
    reg = registry.MetricsRegistry("run-exp", algorithm="SERVE", fingerprint="f")
    reg.hist_observe("serve.latency_ms", 5.0)
    exp = exporter.MetricsExporter(reg, port=0)
    try:
        for url in (f"127.0.0.1:{exp.port}", f"http://127.0.0.1:{exp.port}/"):
            evs = dashboard.fetch_url_events(url)
            assert any(e["event"] == "telemetry" for e in evs)
            assert any(e["event"] == "hist" for e in evs)
    finally:
        exp.close()
        reg.close()


# ---- micro_bench --------------------------------------------------------------------


def _jax_source(name):
    with open(os.path.join(JAX_TOOLS, f"{name}.py")) as fh:
        return fh.read()


def _dict_keys(src, var, func="main"):
    """The keys of the dict literal assigned to ``var`` (None: returned) in
    ``func`` of a module's source, and of its nested dict literals by key."""
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if not isinstance(getattr(node, "value", None), ast.Dict):
            continue
        if (isinstance(node, ast.Return) and var is None) or (
                isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == var for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            nested = {k.value: [kk.value for kk in v.keys]
                      for k, v in zip(node.value.keys, node.value.values)
                      if isinstance(v, ast.Dict)}
            return keys, nested
    raise AssertionError(f"no dict {var} in {func}")


JAX_OPS = re.findall(r'^\s+\("([A-Za-z0-9_]+)", \(', _jax_source("micro_bench"), re.M)


def test_micro_bench_cli_prints_the_reference_ops_and_keys(capsys):
    assert len(JAX_OPS) == 12
    assert micro_bench.main(["--device", "cpu", "--scale", "0.0005", "--iters", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys, _ = _dict_keys(_jax_source("micro_bench"), "out")
    assert list(out) == keys
    assert out["platform"] == "cpu" and (out["V"], out["E"]) == micro_bench.shapes(0.0005)
    assert list(out["ops"]) == JAX_OPS
    for name, rec in out["ops"].items():
        assert "error" not in rec, (name, rec)
        assert rec["ms"] > 0
        assert set(rec) == {"ms", "tflops" if name.startswith("matmul") else "apparent_gbs"}


def test_micro_bench_filter_and_error_record(capsys, monkeypatch):
    assert micro_bench.main(["--device", "cpu", "--ops", "nothing_matches"]) == 2
    assert "matches none" in capsys.readouterr().err
    bench = micro_bench.MicroBench(100, 800, 7, "cpu")

    def broken(*a, **k):
        raise RuntimeError("no launch")

    monkeypatch.setattr("neutronstarlite_torch.ops.bsp_ell.bsp_aggregate", broken)
    out = micro_bench.run(bench, ["bsp_streamed_bf16", "row_gather_bf16"], iters=1)
    assert out["ops"]["bsp_streamed_bf16"] == {"error": "RuntimeError: no launch"}
    assert out["ops"]["row_gather_bf16"]["ms"] > 0


MB_V, MB_E = 200, 3000
BF16 = (2.0 ** -7, 2.0 ** -7)  # (x rms, x |ref|)
WIDE = (2.0 ** -6, 2.0 ** -6)


@pytest.fixture(scope="module")
def mb_rig():
    """One MicroBench at a small shape and the reference's tables built from
    its host graphs (one shared host graph)."""
    from neutronstarlite_tpu.ops.bsp_ell import BspEllPair as JBsp
    from neutronstarlite_tpu.ops.device_graph import DeviceGraph
    from neutronstarlite_tpu.ops.ell import EllPair as JEll
    from neutronstarlite_tpu.ops.fused_edge import FusedEdgePair as JFused
    from neutronstarlite_tpu.ops.pallas_kernels import PALLAS_MIN_K, merge_low_k_levels

    b = micro_bench.MicroBench(MB_V, MB_E, 7, "cpu")

    def jgraph(key):
        g = b.need(key)
        return JCSC(**{f.name: getattr(g, f.name) for f in dataclasses.fields(JCSC)})

    jg, jg1 = jgraph("g"), jgraph("g1")
    ell = JEll.from_host(jg)
    return b, {"dg": DeviceGraph.from_host(jg), "ell": ell, "dg1": DeviceGraph.from_host(jg1),
               "merged": merge_low_k_levels(ell.fwd, PALLAS_MIN_K),
               "bsp": JBsp.from_host(jg, dt=micro_bench.BSP_DT, vt=micro_bench.BSP_VT),
               "fused": JFused.from_host(jg1)}


def _jx(t, f32=False):
    dt = jnp.float32 if (f32 or t.dtype != torch.bfloat16) else jnp.bfloat16
    return jnp.asarray(t.float().numpy(), dt)


def _jax_chain(dg, h, a, b, slope):
    from neutronstarlite_tpu.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax

    score = jax.nn.leaky_relu(a[dg.csc_src] + b[dg.csc_dst], negative_slope=slope)
    return aggregate_edge_to_dst_weighted(dg, edge_softmax(dg, score), h)


def _want(name, b, r):
    """The reference's value of op ``name`` at s = 1 on the same inputs."""
    from neutronstarlite_tpu.ops.aggregate import gather_dst_from_src
    from neutronstarlite_tpu.ops.bsp_ell import bsp_gather_dst_from_src
    from neutronstarlite_tpu.ops.ell import ell_gather_dst_from_src
    from neutronstarlite_tpu.ops.fused_edge import fused_edge_attention_aggregate
    from neutronstarlite_tpu.ops.pallas_kernels import gather_dst_from_src_pallas

    n = b.need
    if name == "matmul_bf16_602x128":
        return _jx(n("xw")) @ _jx(n("w_mm"))
    if name == "hbm_stream_f32_64MB":
        return _jx(n("big"))
    if name == "row_gather_bf16":
        return _jx(n("x"))[jnp.asarray(n("idx").numpy())]
    if name == "ell_aggregate_xla_bf16":
        return ell_gather_dst_from_src(r["ell"], _jx(n("x")))
    if name == "sorted_scatter_bf16":
        return gather_dst_from_src(r["dg"], _jx(n("x"), f32=True))
    if name == "bsp_streamed_bf16":
        return bsp_gather_dst_from_src(r["bsp"], _jx(n("x")))
    if name.startswith("pallas_ell"):
        x = n("xw") if "602" in name else n("x")
        return gather_dst_from_src_pallas(r["merged"], _jx(x), interpret=True)
    a, bb = ("al", "ar") if "_gat_" in name else ("hs", "hd")
    slope = 0.01 if "_gat_" in name else 0.2
    if name.endswith("_eager"):
        f = jax.jit(jax.grad(lambda h, a_, b_: (_jax_chain(r["dg1"], h, a_, b_, slope) ** 2)
                             .sum()))
        return f(_jx(n("x"), True), _jx(n(a), True), _jx(n(bb), True))
    f = jax.jit(jax.grad(lambda h, a_, b_: (
        fused_edge_attention_aggregate(r["fused"], h, a_, b_, slope) ** 2).sum()))
    return f(_jx(n("x")), _jx(n(a)), _jx(n(bb)))


OP_TOL = {"ell_aggregate_xla_bf16": (0.0, 0.0), "sorted_scatter_bf16": WIDE,
          "edge_gat_eager": WIDE, "edge_ggcn_eager": WIDE}


@pytest.mark.parametrize("name", JAX_OPS)
def test_micro_bench_op_outputs_equal_the_reference(mb_rig, name):
    """The function micro_bench times for each op, called at s = 1 on the
    CPU (the kernels' plain versions), against its JAX counterpart on the
    same inputs and host graph (the Pallas kernels in interpret mode)."""
    b, r = mb_rig
    got = b.op(name)(1.0).float().numpy()
    want = np.asarray(_want(name, b, r), dtype=np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    atol, rtol = OP_TOL.get(name, BF16)
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    err = np.abs(got - want)
    assert (err <= atol * rms + rtol * np.abs(want)).all(), (name, float(err.max()), rms)


# ---- the bench graph cache ----------------------------------------------------------


def test_bench_graph_cache_round_trip_and_stale_detection(tmp_path):
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph

    d, v, e, built_s = bench_graph.build_and_cache_graph(0.0005)
    assert (v, e) == bench_graph.graph_size(0.0005) == (116, 57307)
    assert d.startswith(str(tmp_path / "bench_cache"))
    assert os.path.basename(d).endswith("_torch") and built_s > 0
    g, src, dst = bench_graph.load_cached_graph(d)
    src0, dst0 = synthetic_power_law_graph(v, e, seed=7)
    want = build_graph(src0, dst0, v, weight="gcn_norm")
    np.testing.assert_array_equal(src, src0)
    np.testing.assert_array_equal(dst, dst0)
    for f in dataclasses.fields(want):
        a, w = getattr(g, f.name), getattr(want, f.name)
        assert np.array_equal(a, w), f.name
    assert bench_graph.build_and_cache_graph(0.0005) == (d, v, e, 0.0)
    stale = d.replace(f"V{v}_", f"V{v + 1}_")
    os.rename(d, stale)
    with pytest.raises(ValueError, match="stale graph cache"):
        bench_graph.load_cached_graph(stale)
    import bench as root_bench

    # the reference's key for the same graph names another directory
    assert root_bench.cache_dir_for(0.0005, v, e) != d
    assert bench_graph.LAYERS == root_bench.LAYERS
    assert bench_graph.N_LABELS == root_bench.N_LABELS


# ---- the three benches --------------------------------------------------------------


def test_bench_matrix_measure_cfg_equals_the_reference_algorithm():
    jrow = j_bench_matrix.measure_cfg(SMOKE_CFG, epochs=1, warmup=1)
    trow = bench_matrix.measure_cfg(SMOKE_CFG, epochs=1, warmup=1, device="cpu")
    assert list(trow) == list(jrow)
    for k in ("algorithm", "vertices", "layers"):
        assert trow[k] == jrow[k]
    assert np.isfinite(trow["loss"]) and np.isfinite(jrow["loss"])
    assert trow["epoch_s"] > 0 and 0.0 <= trow["acc_train"] <= 1.0


def test_bench_matrix_records_a_failing_row(tmp_path, capsys):
    cfgs = tmp_path / "configs"
    cfgs.mkdir()
    with open(SMOKE_CFG) as fh:
        text = fh.read().replace("../tests", os.path.join(REPO, "tests"))
    (cfgs / "a_smoke.cfg").write_text(text + "EPOCHS:2\n")
    (cfgs / "b_missing.cfg").write_text(
        re.sub(r"EDGE_FILE:.*", "EDGE_FILE:" + str(tmp_path / "none" / "x.edge"), text))
    (cfgs / "c_reddit_skipped.cfg").write_text(text)
    assert bench_matrix.main(["--configs", str(cfgs), "--epochs", "1", "--warmup", "1",
                              "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    a, b = out["rows"]
    assert a["workload"] == "a_smoke" and a["algorithm"] == "GCNCPU" and a["epoch_s"] > 0
    assert b["workload"] == "b_missing" and b["error"].startswith("FileNotFoundError")
    assert str(tmp_path / "none") in b["error"]


def test_bench_sample_prints_the_reference_keys(capsys):
    assert bench_sample.main(["--device", "cpu", "--scale", "0.0005", "--batch-size", "32",
                              "--fanout", "4-4", "--batches", "3", "--warmup", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys, nested = _dict_keys(_jax_source("bench_sample"), "out")
    assert list(out) == keys and list(out["extra"]) == nested["extra"]
    assert out["metric"] == "gcn_reddit_sampled_batch_time" and out["value"] > 0
    e = out["extra"]
    assert (e["v_num"], e["e_num"]) == (116, 57307) and e["batches_timed"] == 3
    assert np.isfinite(e["final_loss"]) and e["edge_slots_per_batch"] > 0
    assert 0 < e["sample_s_median"] <= out["value"] and e["device"] == "cpu"


def test_sample_bench_modes_parity_and_ledger_rows(tmp_path, monkeypatch, capsys):
    # the tool sets NTS_FINAL_EVAL=0 for its process: set here, it is
    # restored afterwards (a later test in this process trains with it unset)
    monkeypatch.setenv("NTS_FINAL_EVAL", "0")
    monkeypatch.setenv("NTS_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("NTS_SAMPLE_PIPELINE", "sync")  # ignored: each leg picks its mode
    epochs = 2
    assert sample_bench.main(["--device", "cpu", "--scale", "0.0005", "--batch-size", "16",
                              "--fanout", "3-3", "--epochs", str(epochs),
                              "--modes", "sync,pipelined,fused"]) == 0
    cap = capsys.readouterr()
    assert "ignoring NTS_SAMPLE_PIPELINE" in cap.err
    out = json.loads(cap.out.strip().splitlines()[-1])
    keys, nested = _dict_keys(_jax_source("sample_bench"), "out")
    assert list(out) == keys and list(out["extra"]) == nested["extra"]
    modes = out["extra"]["modes"]
    row_keys, _ = _dict_keys(_jax_source("sample_bench"), None, "measure_mode")
    assert all(list(r) == row_keys for r in modes.values())
    assert out["extra"]["sync_pipelined_loss_parity"] is True
    assert modes["sync"]["loss_history"] == modes["pipelined"]["loss_history"]
    assert len(modes["sync"]["loss_history"]) == epochs
    assert modes["fused"]["sample_h2d_bytes_total"] == 0.0
    assert modes["sync"]["sample_h2d_bytes_total"] > 0
    assert modes["fused"]["dispatches"] == modes["fused"]["batches_per_epoch"] * epochs
    assert out["value"] == modes["fused"]["batches_per_sec"] > 0
    # beside each trainer's own kind=run row (finalize_metrics), one per mode
    rows = [r for r in ledger.read_rows(directory=str(tmp_path / "ledger"))
            if r["run_id"].startswith("sample_bench-")]
    assert [r["cfg"] for r in rows] == [f"sample_bench/{m}/B16/3-3/s0.0005"
                                        for m in ("sync", "pipelined", "fused")]
    assert all(r["kind"] == "run" and r["warm_median_epoch_s"] > 0 for r in rows)


def test_sample_bench_refuses_an_unknown_mode():
    with pytest.raises(SystemExit, match="unknown mode"):
        sample_bench.main(["--device", "cpu", "--modes", "sync,teleport"])


@pytest.mark.parametrize("tool", ["micro_bench", "bench_sample", "sample_bench",
                                  "bench_matrix"])
def test_tool_without_a_card_or_device_cpu_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"micro_bench": micro_bench, "bench_sample": bench_sample,
           "sample_bench": sample_bench, "bench_matrix": bench_matrix}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--scale", "0.0005"] if tool != "bench_matrix" else [])
