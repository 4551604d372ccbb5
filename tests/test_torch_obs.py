"""The obs plane of the torch port against the JAX package's.

The copied modules (``hist``, ``schema``, ``slo``, the config fingerprint)
are held against the originals on the same inputs. The trainers' streams
are held against the JAX trainers': GCN on the Cora fixture from JAX's
initial parameters (``gcn_params_from_jax``) with ``drop_rate`` 0 — the
same event kinds in the same order (``program_cost``, whose ``source``
differs, and ``model_drift``, which the port does not emit yet, left
out), the same ``run_summary`` keys and span tree, the same
``tensor_stats`` groups under ``NTS_NUMERICS=1`` (epoch 0 within 1e-4
relative, later epochs within 1e-3: f32 runs drift apart at ReLU kinks),
the same ledger row keys and the same sampling counters. Every record the
port writes passes both packages' ``validate_event``. The JAX runs are
cached at module scope, and torch runs on one intra-op thread.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.gcn import GCNTrainer as JGCN
from neutronstarlite_tpu.models.gcn_sample import GCNSampleTrainer as JSample
from neutronstarlite_tpu.obs import hist as j_hist
from neutronstarlite_tpu.obs import ledger as j_ledger
from neutronstarlite_tpu.obs import registry as j_registry
from neutronstarlite_tpu.obs import schema as j_schema
from neutronstarlite_tpu.obs import slo as j_slo
from neutronstarlite_tpu.resilience import events as j_events
from neutronstarlite_tpu.resilience import faults as j_faults
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch import obs
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
from neutronstarlite_torch.nn.param import adam_update
from neutronstarlite_torch.obs import hist as t_hist
from neutronstarlite_torch.obs import ledger as t_ledger
from neutronstarlite_torch.obs import numerics as t_numerics
from neutronstarlite_torch.obs import registry as t_registry
from neutronstarlite_torch.obs import schema as t_schema
from neutronstarlite_torch.obs import slo as t_slo
from neutronstarlite_torch.resilience import events, faults
from neutronstarlite_torch.resilience.supervisor import supervised_run
from neutronstarlite_torch.utils import profiling
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import gcn_params_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 30
SKIP_KINDS = ("program_cost", "model_drift")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_NUMERICS", "NTS_TRACE_STEP",
                 "NTS_FAULT_SPEC", "NTS_PROFILE_DIR", "NTS_METRICS_PORT", "NTS_SLO_SPEC",
                 "NTS_SAMPLE_PIPELINE", "NTS_PROGRAM_COST"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NTS_BACKOFF_BASE_S", "0")
    faults.reset()
    j_faults.reset()
    yield
    faults.reset()
    j_faults.reset()
    events.set_sink(None)
    j_events.set_sink(None)


def _cfg(cls, epochs=EPOCHS, algorithm="GCNCPU", layers=f"{F}-{H}-{C}", **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = layers
    cfg.epochs = epochs
    cfg.decay_epoch = 10
    cfg.drop_rate = 0.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls, f=F):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, f, seed=0,
    )


def _stream(d):
    files = sorted(glob.glob(os.path.join(str(d), "*.jsonl")))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _of(recs, kind):
    return [r for r in recs if r["event"] == kind]


def _kinds(recs):
    return [r["event"] for r in recs if r["event"] not in SKIP_KINDS]


def _validate_both(recs):
    assert recs
    for r in recs:
        t_schema.validate_event(r)
        j_schema.validate_event(r)


def _span_tree(recs):
    """(name, cat, parent's name) per span, in stream order."""
    spans = _of(recs, "span")
    names = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], s["cat"], names.get(s["parent_id"])) for s in spans]


# ---- the copied modules against the originals ------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "with_zeros"])
def test_hist_buckets_quantiles_merge_delta_match_reference(dist):
    rng = np.random.default_rng(3)
    a = {"lognormal": rng.lognormal(1.0, 1.5, 5000),
         "uniform": rng.uniform(0.01, 500.0, 5000),
         "with_zeros": np.concatenate([np.zeros(300), rng.exponential(3.0, 4000)])}[dist]
    b = rng.lognormal(2.0, 0.5, 700)
    hists = []
    for mod in (t_hist, j_hist):
        h1, h2 = mod.LogHistogram(), mod.LogHistogram()
        for v in a:
            h1.record(float(v))
        base = h1.copy()
        for v in b:
            h2.record(float(v))
        merged = h1.copy().merge(h2)
        for v in b[:100]:
            h1.record(float(v))
        delta = h1.delta(base)
        hists.append((h1.to_dict(), h1.quantiles(), merged.to_dict(), merged.quantiles(),
                      delta.to_dict(), delta.quantiles(), h1.quantile(0.999)))
    assert hists[0] == hists[1]


def _corpus():
    """Every known kind through a registry (the reference's own factory),
    then per record an invalid twin of each kind of fault."""
    from test_schema_roundtrip import _emit_all

    reg = j_registry.MetricsRegistry("r-1", algorithm="A", fingerprint="f")
    out = []
    orig = reg.event

    def grab(event_kind, **fields):
        rec = orig(event_kind, **fields)
        out.append(rec)
        return rec

    reg.event = grab
    _emit_all(reg)
    bad = []
    per_kind = {"epoch": {"seconds": 0}, "epoch_scan": {"dispatches": 0},
                "span": {"dur_s": -1.0}, "hist": {"buckets": [[340, 0]]},
                "program_cost": {"label": ""}, "tensor_stats": {"finite_fraction": 1.5},
                "nonfinite_provenance": {"checked": -1}, "run_summary": {"epoch_time": None},
                "fault": {"kind": ""}, "recovery": {"action": ""}}
    for rec in out:
        bad.append({k: v for k, v in rec.items() if k != "seq"})
        bad.append(dict(rec, schema=2))
        bad.append(dict(rec, run_id=""))
        if rec["event"] in per_kind:
            bad.append(dict(rec, **per_kind[rec["event"]]))
    return out + bad + [None, [], {"event": "epoch"}]


def test_validate_event_gives_the_reference_verdicts():
    corpus = _corpus()
    verdicts = []
    for mod in (t_schema, j_schema):
        got = []
        for rec in corpus:
            try:
                mod.validate_event(rec)
                got.append("ok")
            except ValueError as e:
                got.append(str(e))
        verdicts.append(got)
    assert verdicts[0] == verdicts[1]
    valid = {rec["event"] for rec, v in zip(corpus, verdicts[0]) if v == "ok"}
    assert valid == set(j_schema.KNOWN_KINDS)
    assert verdicts[0].count("ok") < len(corpus) // 2


def test_schema_version_and_known_kinds_equal():
    assert t_schema.SCHEMA_VERSION == j_schema.SCHEMA_VERSION
    assert t_schema.KNOWN_KINDS == j_schema.KNOWN_KINDS


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in
                                        glob.glob(os.path.join(REPO, "configs", "*.cfg"))))
def test_config_fingerprint_equals_reference(name):
    """Every cfg the port parses fingerprints as in the reference; the port
    refuses the rest at parse time (distributed and serving keys)."""
    path = os.path.join(REPO, "configs", name)
    want = j_registry.config_fingerprint(JInfo.read_from_cfg_file(path))
    try:
        cfg = InputInfo.read_from_cfg_file(path)
    except ValueError:
        pytest.raises(ValueError, InputInfo.read_from_cfg_file, path)
        return
    assert t_registry.config_fingerprint(cfg) == want
    assert obs.config_fingerprint(InputInfo()) == j_registry.config_fingerprint(JInfo())


@pytest.mark.parametrize("spec", [
    "epoch_p50_ms<=1@1m", "serve_p99_ms<=75@5m;shed_rate<=0.01@30s",
    "queue_p95_ms<=2.5@10s; epoch_p99_ms<=400@1h", "serve_p99_ms<75@1m",
    "epoch_p50_ms<=1@0s", "",
])
def test_parse_slo_spec_equals_reference(spec):
    def parse(mod):
        try:
            return [tuple(getattr(o, k) for k in type(o).__slots__)
                    for o in mod.parse_slo_spec(spec)]
        except ValueError as e:
            return str(e)

    assert parse(t_slo) == parse(j_slo)


# the one difference the flight copy carries: its SIGUSR2 handler keeps the
# handler it displaced and chains to it after its own dump, so that in a
# process running both packages the reference's recorder still dumps
FLIGHT_CHAIN = (
    ("_signal_installed = False\n# the SIGUSR2 handler this module displaced (another "
     "recorder's, in a\n# process that runs both packages): it still runs after our "
     "dump\n_displaced = None\n", "_signal_installed = False\n"),
    ("global _active, _signal_installed, _displaced", "global _active, _signal_installed"),
    ("_displaced = signal.signal(signal.SIGUSR2, _on_sigusr2)",
     "signal.signal(signal.SIGUSR2, _on_sigusr2)"),
    ("def _on_sigusr2(signum, frame) -> None:", "def _on_sigusr2(_signum, _frame) -> None:"),
    ("        rec.dump(\"sigusr2\")\n    if callable(_displaced) and _displaced is not "
     "_on_sigusr2:\n        _displaced(signum, frame)\n", "        rec.dump(\"sigusr2\")\n"),
)


# the copies outside obs/: the graph and delta-trace generator, the delta log
COPIED_ELSEWHERE = {"graph_gen": "tools", "log": "stream", "telemetry_hub": "tools",
                    "metrics_report": "tools", "trace_timeline": "tools",
                    "trace_summary": "tools", "drift_audit": "tools",
                    "perf_sentinel": "tools", "dashboard": "tools"}
# the one difference the log copy carries: its removal mask is the delta
# module's binary search, in place of two np.isin calls
LOG_REMOVAL = (
    ("        mask, present = delta_mod._removal_mask(keys, rm)\n",
     "        present = np.isin(rm, keys)\n"),
    ("            )\n    src = np.concatenate([old_src[mask], delta.add_src])",
     "            )\n        mask = ~np.isin(keys, rm)\n"
     "    src = np.concatenate([old_src[mask], delta.add_src])"),
)
# the one difference the sentinel copy carries: the close of one comment,
# where the reference's names its tracker entry
with open(os.path.join(REPO, "neutronstarlite_tpu", "tools", "perf_sentinel.py")) as _fh:
    SENTINEL_NOTE = (("        # instead of gating (the sentinel's contract for this leg)\n",
                      next(ln for ln in _fh if ln.startswith("        # instead of gating ("))),)


@pytest.mark.parametrize("name", ["hist", "schema", "flight", "slo", "skew", "graph_gen",
                                  "log", "httpc", "hub", "telemetry_hub", "metrics_report",
                                  "trace_timeline", "trace_summary", "drift_audit",
                                  "perf_sentinel", "dashboard"])
def test_copied_module_code_equals_the_original(name):
    """The copies differ from the originals only in their docstring's port
    note and the import paths (and flight in its SIGUSR2 chaining,
    ``FLIGHT_CHAIN``, the log in its removal mask, ``LOG_REMOVAL``, the
    sentinel in one comment, ``SENTINEL_NOTE``)."""
    sub = COPIED_ELSEWHERE.get(name, "obs")
    def body(path, pkg, diffs=()):
        with open(path) as fh:
            src = fh.read()
        for mine, original in diffs:
            assert src.count(mine) == 1, mine
            src = src.replace(mine, original)
        head, doc, rest = src.split('"""', 2)
        return doc.split("\n", 1)[0], rest.replace(pkg, "PKG")

    t = body(os.path.join(REPO, "neutronstarlite_torch", sub, f"{name}.py"),
             "neutronstarlite_torch",
             {"flight": FLIGHT_CHAIN, "log": LOG_REMOVAL,
              "perf_sentinel": SENTINEL_NOTE}.get(name, ()))
    j = body(os.path.join(REPO, "neutronstarlite_tpu", sub, f"{name}.py"),
             "neutronstarlite_tpu")
    assert t == j


@pytest.mark.skipif(not hasattr(__import__("signal"), "SIGUSR2"),
                    reason="no SIGUSR2 on this platform")
def test_sigusr2_reaches_the_reference_recorder_after_a_port_registry(tmp_path,
                                                                       monkeypatch):
    """JAX registry, port registry, JAX registry, then SIGUSR2: the JAX
    recorder dumps (the port's handler chains to the one it displaced).
    The process's SIGUSR2 handler is restored afterwards."""
    import signal

    from neutronstarlite_tpu.obs import flight as j_flight
    from neutronstarlite_torch.obs import flight as t_flight

    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    saved = signal.getsignal(signal.SIGUSR2)
    state = (j_flight._active, j_flight._signal_installed, t_flight._active,
             t_flight._signal_installed, t_flight._displaced)
    try:
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)
        j_flight._signal_installed = t_flight._signal_installed = False
        j_registry.MetricsRegistry("run-j1", algorithm="A", fingerprint="f")
        t_registry.MetricsRegistry("run-t", algorithm="A", fingerprint="f")
        assert signal.getsignal(signal.SIGUSR2) is t_flight._on_sigusr2
        reg = j_registry.MetricsRegistry("run-j2", algorithm="A", fingerprint="f")
        reg.event("epoch", epoch=0, seconds=0.1, loss=1.0)
        before = list(reg.flight.dumps)
        os.kill(os.getpid(), signal.SIGUSR2)
        assert len(reg.flight.dumps) == len(before) + 1
        with open(reg.flight.dumps[-1]) as fh:
            assert any(json.loads(line)["event"] == "epoch" for line in fh)
    finally:
        signal.signal(signal.SIGUSR2, saved)
        (j_flight._active, j_flight._signal_installed, t_flight._active,
         t_flight._signal_installed, t_flight._displaced) = state


# ---- GCN on Cora: the stream against the reference's ------------------------------

def _jax_gcn(tmp, epochs=EPOCHS, numerics=False, **env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_METRICS_DIR", str(tmp / "m"))
        mp.setenv("NTS_LEDGER_DIR", str(tmp / "l"))
        mp.setenv("NTS_NUMERICS", "1" if numerics else "0")
        for k, v in env.items():
            mp.setenv(k, v)
        src, dst = j_load_edges(EDGES)
        tr = JGCN.from_arrays(_cfg(JInfo, epochs), src, dst, _data(JDatum))
        p0 = jax.tree.map(np.asarray, tr.params)
        tr.run()
        j_events.set_sink(None)
    return p0, list(tr.loss_history), _stream(tmp / "m"), j_ledger.read_rows(str(tmp / "l"))


@pytest.fixture(scope="module")
def jax_gcn(tmp_path_factory):
    return _jax_gcn(tmp_path_factory.mktemp("jax-gcn"))


@pytest.fixture(scope="module")
def jax_gcn_numerics(tmp_path_factory):
    return _jax_gcn(tmp_path_factory.mktemp("jax-gcn-num"), numerics=True)


def _port_gcn(tmp, p0, epochs=EPOCHS, algorithm="GCNCPU", cls=None, layers=f"{F}-{H}-{C}",
              f=F, supervised=False, **env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_METRICS_DIR", str(tmp / "m"))
        mp.setenv("NTS_LEDGER_DIR", str(tmp / "l"))
        for k, v in env.items():
            mp.setenv(k, v)
        src, dst = load_edges(EDGES)
        cls = cls or get_algorithm(algorithm)
        tr = cls.from_arrays(_cfg(InputInfo, epochs, algorithm, layers,
                                  **({"checkpoint_dir": str(tmp / "ck"), "checkpoint_every": 1}
                                     if supervised else {})),
                             src, dst, _data(GNNDatum, f), device="cpu")
        if p0 is not None:
            gcn_params_from_jax(p0, tr)
        if supervised:
            supervised_run(tr)
        else:
            tr.run()
    return tr, _stream(tmp / "m"), t_ledger.read_rows(str(tmp / "l"))


@pytest.fixture(scope="module")
def port_gcn(jax_gcn, tmp_path_factory):
    return _port_gcn(tmp_path_factory.mktemp("port-gcn"), jax_gcn[0])


@pytest.fixture(scope="module")
def port_gcn_numerics(jax_gcn, tmp_path_factory):
    return _port_gcn(tmp_path_factory.mktemp("port-gcn-num"), jax_gcn[0], NTS_NUMERICS="1")


def test_port_stream_validates_under_both_schemas(port_gcn):
    _validate_both(port_gcn[1])


def test_event_kinds_in_the_reference_order(jax_gcn, port_gcn):
    _, _, jrecs, _ = jax_gcn
    trecs = port_gcn[1]
    assert _kinds(trecs) == _kinds(jrecs)
    assert len(_of(trecs, "epoch")) == EPOCHS
    assert trecs[-1]["event"] == "run_summary"


def test_run_summary_keys_and_loss_history_match(jax_gcn, port_gcn):
    js = _of(jax_gcn[2], "run_summary")[0]
    ts = _of(port_gcn[1], "run_summary")[0]
    assert set(ts) == set(js)
    for key in ("epoch_time", "memory", "result"):
        assert set(ts[key]) >= set(js[key]) and set(ts[key]) - set(js[key]) <= set(), key
    np.testing.assert_allclose(ts["loss_history"], js["loss_history"], rtol=0, atol=1e-4)
    assert ts["epochs"] == js["epochs"] == EPOCHS
    assert ts["memory"] == {"available": False, "bytes_in_use": None,
                            "peak_bytes_in_use": None, "devices": []}


def test_span_names_and_tree_match(jax_gcn, port_gcn):
    tree = _span_tree(port_gcn[1])
    assert tree == _span_tree(jax_gcn[2])
    assert ("epoch", "epoch", "run") in tree
    assert ("step_dispatch", "stage", "epoch") in tree
    assert ("step_device", "stage", "epoch") in tree
    assert tree[-1] == ("run", "lifecycle", None)


def test_ledger_row_keys_match(jax_gcn, port_gcn):
    (jrow,), (trow,) = jax_gcn[3], port_gcn[2]
    assert set(trow) == set(jrow)
    assert trow["cfg"] == jrow["cfg"] and trow["graph_digest"] == jrow["graph_digest"]
    assert trow["backend"].startswith("torch-")
    assert [c["label"] for c in trow["program_costs"]] == ["fullbatch.train_step/GCNTrainer"]


def test_program_cost_counted_once_and_not_in_the_timed_epochs(port_gcn):
    costs = _of(port_gcn[1], "program_cost")
    assert [c["label"] for c in costs] == ["fullbatch.train_step/GCNTrainer"]
    assert costs[0]["source"] == "counted" and costs[0]["flops"] > 0
    assert costs[0]["memory"] is None  # the CPU
    # the count's step was undone: the curve is the reference's
    first_epoch = _of(port_gcn[1], "epoch")[0]
    assert costs[0]["seq"] < first_epoch["seq"]


def test_numerics_leaves_the_loss_curve_bitwise(port_gcn, port_gcn_numerics):
    assert port_gcn_numerics[0].loss_history == port_gcn[0].loss_history
    _validate_both(port_gcn_numerics[1])


# later epochs: the parameter, activation and logit stats within 1e-3 of
# the reference's trajectory; the gradient stats' rms and the global norm
# within 5e-3 (measured up to 1.5e-3), their absmax within 5e-2. The absmax
# is one element of a gradient that f32 rounding moves by ~1 %: at the
# reference's own epoch-3 parameters its f32 grads/l0 absmax (0.019777,
# bitwise the port's there) sits 1.0 % from the f64 value (0.019982), so
# two f32 trajectories that agree in loss to 1e-4 part by up to ~4 % in
# that stat (measured over 30 epochs)
LATER_RTOL = 1e-3
LATER_GRAD_RTOL = {"rms": 5e-3, "grad_global_norm": 5e-3, "absmax": 5e-2}


def test_numerics_groups_and_epoch0_stats_match(jax_gcn_numerics, port_gcn_numerics):
    jst = _of(jax_gcn_numerics[2], "tensor_stats")
    tst = _of(port_gcn_numerics[1], "tensor_stats")
    assert [(r["name"], r["epoch"]) for r in tst] == [(r["name"], r["epoch"]) for r in jst]
    assert {r["name"] for r in tst} == {
        "params/l0", "params/l1", "grads/l0", "grads/l1", "acts/l0", "acts/l1",
        "logits", "grads/global"}
    for t, j in zip(tst, jst):
        assert t["finite_fraction"] == j["finite_fraction"] == 1.0
        assert abs(t["zero_fraction"] - j["zero_fraction"]) <= 1e-3, t["name"]
        for key in ("absmax", "rms", "grad_global_norm"):
            if t["epoch"] == 0:
                rtol = 1e-4
            elif t["name"].startswith("grads/"):
                rtol = LATER_GRAD_RTOL[key]
            else:
                rtol = LATER_RTOL
            if j.get(key) is None:
                assert t.get(key) is None
            else:
                np.testing.assert_allclose(t[key], j[key], rtol=rtol, err_msg=(t["name"], key))


def test_trace_step_split_keeps_the_loss(jax_gcn, port_gcn, tmp_path):
    tr, recs, _ = _port_gcn(tmp_path, jax_gcn[0], epochs=5, NTS_TRACE_STEP="1")
    assert tr.loss_history == port_gcn[0].loss_history[:5]
    stages = [r["stages"] for r in _of(recs, "epoch")]
    assert all(list(s) == ["forward_backward", "optim"] for s in stages)
    assert ("forward_backward", "stage", "epoch") in _span_tree(recs)
    _validate_both(recs)


@pytest.mark.parametrize("layer", [0, 1])
def test_provenance_names_the_injected_layer(layer, tmp_path, monkeypatch):
    """nan_loss@layer=k: the replay names layer k, before the fault record,
    and the supervised run recovers (as the reference's
    test_provenance_names_injected_layer_fullbatch)."""
    monkeypatch.setenv("NTS_FAULT_SPEC", f"nan_loss@epoch=1,layer={layer}")
    tr, recs, _ = _port_gcn(tmp_path, None, epochs=3, supervised=True)
    assert np.isfinite(tr.loss_history).all()
    prov = _of(recs, "nonfinite_provenance")
    assert len(prov) == 1
    assert prov[0]["layer"] == layer and prov[0]["op"] == "activation"
    assert prov[0]["injected"] is True and prov[0]["fault_kind"] == "nonfinite_loss"
    fault = next(r for r in recs if r["event"] == "fault")
    assert prov[0]["seq"] < fault["seq"]
    assert faults.pending_layer_poison() is None
    _validate_both(recs)


def test_provenance_without_taps_is_unattributed(tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=1,layer=0")
    tr, recs, _ = _port_gcn(tmp_path, None, epochs=3, algorithm="GINCPU", supervised=True)
    (prov,) = _of(recs, "nonfinite_provenance")
    assert prov["layer"] is None and prov["op"] is None and prov["injected"] is True
    assert faults.pending_layer_poison() is None


def test_fault_and_recovery_records_land_in_the_stream_by_default(tmp_path, monkeypatch):
    events.set_sink(None)
    monkeypatch.setenv("NTS_FAULT_SPEC", "nan_loss@epoch=1")
    tr, recs, _ = _port_gcn(tmp_path, None, epochs=3, supervised=True)
    assert [(r.get("kind") or r.get("action")) for r in recs
            if r["event"] in ("fault", "recovery")] == ["nonfinite_loss", "rollback"]
    summary = _of(recs, "run_summary")[0]
    assert summary["counters"]["resilience.faults"] == 1
    assert summary["counters"]["resilience.restarts"] == 1
    assert summary["gauges"]["resilience.state"] in ("running", "ok")
    names = [r["name"] for r in _of(recs, "span")]
    assert names.count("attempt") == 2
    _validate_both(recs)


def test_metrics_port_refuses(monkeypatch):
    """``NTS_METRICS_PORT`` no longer refuses: a trainer starts the scrape
    endpoint (``obs/exporter``) over its registry, as the reference does."""
    import urllib.request

    from neutronstarlite_torch.obs import exporter

    monkeypatch.setattr(exporter, "_singleton", None)
    monkeypatch.setenv("NTS_METRICS_PORT", "0")
    src, dst = load_edges(EDGES)
    tr = GCNTrainer.from_arrays(_cfg(InputInfo, 1), src, dst, _data(GNNDatum), device="cpu")
    exp = exporter._singleton
    try:
        assert exp is not None and exp.registry is tr.metrics
        tr.run()
        with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert r.status == 200 and "nts_train_epoch_ms_count 1" in text
    finally:
        exp.close()


def test_profile_dir_trace_holds_the_tracer_scopes(tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_PROFILE_DIR", str(tmp_path / "prof"))
    tr, recs, _ = _port_gcn(tmp_path, None, epochs=3)
    (path,) = glob.glob(str(tmp_path / "prof" / "GCNTrainer" / "*.json"))
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"epoch", "step_dispatch", "step_device"} <= names


# ---- every family and sampling mode writes a valid stream ---------------------------

@pytest.mark.parametrize("algorithm,extra", [
    ("GCNCPUEAGER", {}), ("GATCPU", {}), ("GINCPU", {"OPTIM_KERNEL": 1}), ("COMMNETCPU", {}),
    ("GGCNCPU", {}),
])
def test_every_family_writes_a_valid_stream(algorithm, extra, jax_gcn, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_METRICS_DIR", str(tmp_path))
        src, dst = load_edges(EDGES)
        cfg = _cfg(InputInfo, 2, algorithm, "16-8-7", optim_kernel=bool(extra))
        get_algorithm(algorithm).from_arrays(cfg, src, dst, _data(GNNDatum, 16),
                                             device="cpu").run()
    recs = _stream(tmp_path)
    _validate_both(recs)
    assert recs[-1]["event"] == "run_summary"
    assert set(recs[-1]) == set(_of(jax_gcn[2], "run_summary")[0])
    assert len(_of(recs, "epoch")) == 2
    if algorithm in ("GATCPU", "GGCNCPU"):
        assert recs[-1]["gauges"]["kernel.path"] == "eager_edge"
        assert recs[-1]["gauges"]["kernel.edge_hbm_bytes_per_epoch"] > 0


SAMPLE_V_F = 1433


def _sample_cfg(cls, epochs, mode="", **kw):
    cfg = cls()
    cfg.algorithm = "GCNSAMPLESINGLE"
    cfg.vertices = V
    cfg.layer_string = f"{SAMPLE_V_F}-16-7"
    cfg.fanout_string = "3-3"
    cfg.batch_size = 32
    cfg.epochs = epochs
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.0
    cfg.sample_pipeline = mode
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def sample_graph():
    src, dst = load_edges(EDGES)
    return src, dst, build_graph(src, dst, V, use_native=False)


def _port_sampled(tmp, mode, graph, epochs=2, p0=None, **env):
    src, dst, g = graph
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_METRICS_DIR", str(tmp))
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.setenv("NTS_FINAL_EVAL", "0")
        for k, v in env.items():
            mp.setenv(k, v)
        tr = GCNSampleTrainer.from_arrays(_sample_cfg(InputInfo, epochs, mode), src, dst,
                                          _data(GNNDatum, SAMPLE_V_F), device="cpu",
                                          host_graph=g)
        if p0 is not None:
            params_from_jax(p0, tr)
        tr.run()
    return tr, _stream(tmp)


@pytest.mark.parametrize("mode", ["sync", "pipelined", "device", "fused"])
def test_sampled_numerics_bitwise_and_streams_valid(mode, sample_graph, jax_gcn, tmp_path):
    plain, recs = _port_sampled(tmp_path / "a", mode, sample_graph)
    stats, srecs = _port_sampled(tmp_path / "b", mode, sample_graph, NTS_NUMERICS="1")
    assert stats.loss_history == plain.loss_history
    for p, q in zip(plain.flat_params, stats.flat_params):
        assert torch.equal(p, q)
    for r in (recs, srecs):
        _validate_both(r)
        assert r[-1]["event"] == "run_summary"
        assert set(r[-1]) == set(_of(jax_gcn[2], "run_summary")[0])
    names = {r["name"] for r in _of(srecs, "tensor_stats")}
    assert names == {"params/l0", "params/l1", "grads/l0", "grads/l1", "grads/global"}
    assert [r["epoch"] for r in _of(srecs, "tensor_stats") if r["name"] == "grads/global"] \
        == [0, 1]
    counters = srecs[-1]["counters"]
    assert counters["sample.batches"] == 2 * 51
    if mode == "fused":
        assert len(_of(srecs, "epoch_scan")) == 2 and counters["sample.h2d_bytes"] == 0
        assert [c["label"] for c in _of(srecs, "program_cost")] == ["sample.fused_step_b51"]
    if mode in ("pipelined", "device"):
        assert counters["sample.produced"] == 2 * 51
        assert {"sample_produce", "h2d_copy", "sample_wait"} <= {
            r["name"] for r in _of(srecs, "span")}


@pytest.fixture(scope="module")
def jax_sync(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax-sync")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.setenv("NTS_METRICS_DIR", str(tmp))
        mp.delenv("NTS_SAMPLE_PIPELINE", raising=False)
        src, dst = j_load_edges(EDGES)
        jg = j_build_graph(src, dst, V, use_native=False)
        tr = JSample.from_arrays(_sample_cfg(JInfo, 2), src, dst,
                                 _data(JDatum, SAMPLE_V_F), host_graph=jg)
        p0 = jax.tree.map(np.asarray, tr.params)
        tr.run()
        j_events.set_sink(None)
    return p0, list(tr.loss_history), _stream(tmp)


def test_sampled_sync_counters_match_reference(jax_sync, sample_graph, tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_NO_NATIVE", "1")  # JAX's side draws with NumPy
    p0, j_losses, jrecs = jax_sync
    tr, recs = _port_sampled(tmp_path, "sync", sample_graph, p0=p0)
    np.testing.assert_allclose(tr.loss_history, j_losses, rtol=0, atol=1e-4)
    js, ts = _of(jrecs, "run_summary")[0], recs[-1]
    sample_keys = [k for k in js["counters"] if k.startswith(("sample.", "wire."))]
    assert sample_keys
    assert {k: ts["counters"][k] for k in sample_keys} == {k: js["counters"][k]
                                                           for k in sample_keys}
    assert ts["gauges"]["wire.feature_gather_bytes_per_batch"] == \
        js["gauges"]["wire.feature_gather_bytes_per_batch"]
    assert _kinds(recs) == _kinds(jrecs)
    assert [s["stages"] for s in _of(recs, "epoch")][0].keys() == \
        [s["stages"] for s in _of(jrecs, "epoch")][0].keys()


def test_numerics_fetch_is_one_copy_of_exact_tallies():
    x = torch.tensor([0.0, 1.0, float("nan"), -3.0, float("inf")])
    st = t_numerics.step_stats(params=[{"W": x}], grads=[{"W": torch.ones(3)}])
    host = t_numerics.fetch_stats(st)
    g = host["groups"]["params/l0"]
    assert (g["nonfinite_count"], g["zero_count"], g["count"]) == (2, 1, 5)
    assert host["grad_global_norm"] == pytest.approx(3 ** 0.5)
    assert float(t_numerics.grad_global_norm([{"W": torch.ones(3)}])) == pytest.approx(3 ** 0.5)
    one = t_numerics.group_stats({"W": x})
    assert (int(one["nonfinite_count"]), int(one["zero_count"]), one["count"]) == (2, 1, 5)
    assert np.isnan(float(one["absmax"])) and np.isnan(float(one["rms"]))
    ok = t_numerics.group_stats({"W": torch.tensor([3.0, -4.0])})
    assert (float(ok["absmax"]), float(ok["rms"])) == pytest.approx((4.0, (12.5) ** 0.5))
    assert t_numerics.nonfinite_leaf_names([{"W": x, "b": torch.ones(2)}]) == ["[0]['W']"]


def test_debuginfo_reports_and_leaves_the_model(jax_gcn, tmp_path, monkeypatch):
    """NTS_DEBUGINFO=1: the forward / backward / update report after
    training, and the trained parameters and the final accuracies of a run
    without it (the timed steps are undone)."""
    import logging

    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    logging.getLogger("nts_torch").addHandler(grab)
    try:
        monkeypatch.setenv("NTS_DEBUGINFO", "1")
        a, _, _ = _port_gcn(tmp_path / "a", jax_gcn[0], epochs=3)
        monkeypatch.delenv("NTS_DEBUGINFO")
        b, _, _ = _port_gcn(tmp_path / "b", jax_gcn[0], epochs=3)
    finally:
        logging.getLogger("nts_torch").removeHandler(grab)
    report = [ln for ln in lines if ln.startswith("DEBUGINFO:")]
    assert len(report) == 1
    for key in ("#forward_time=", "#backward_time=", "#update_time=",
                "#all_train_step_time="):
        assert key in report[0]
    assert a.loss_history == b.loss_history
    for p, q in zip(a.flat_params, b.flat_params):
        assert torch.equal(p, q)
    assert a.run_summary_record["result"]["acc"] == b.run_summary_record["result"]["acc"]


# ---- the training step's profiler scopes and phase counters -----------------------

STEP_SCOPES = {"nts.step.forward", "nts.step.backward", "nts.step.optim", "nts.ell.aggregate"}
GAT_SCOPES = {"nts.gat.project", "nts.gat.scores", "nts.gat.softmax", "nts.gat.transpose",
              "nts.gat.grad_alpha"}


def _kernel_trainer(algorithm, **kw):
    """A 16-8-7 trainer on the Cora fixture over the ELL tables (OPTIM_KERNEL:1)."""
    src, dst = load_edges(EDGES)
    cfg = _cfg(InputInfo, 2, algorithm, "16-8-7", optim_kernel=True, **kw)
    return get_algorithm(algorithm).from_arrays(cfg, src, dst, _data(GNNDatum, 16),
                                                device="cpu")


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("algorithm", ["GCNCPU", "GATCPU"])
def test_step_scopes_open_under_any_profiler(algorithm):
    """A profiler opened outside ``maybe_trace`` (as the benchmark's is)
    records every scope of one ``train_step()``: GAT's scores and softmax
    once per level and layer, never per chunk."""
    tr = _kernel_trainer(algorithm)
    assert not profiling.recording()
    with _cpu_profile() as prof:
        assert profiling.recording()
        tr.train_step()
    assert not profiling.recording()
    seen = {}
    for e in prof.events():
        if e.name.startswith("nts."):
            seen[e.name] = seen.get(e.name, 0) + 1
    assert set(seen) == STEP_SCOPES | (GAT_SCOPES if algorithm == "GATCPU" else set())
    assert seen["nts.step.forward"] == seen["nts.step.backward"] == seen["nts.step.optim"] == 1
    if algorithm == "GATCPU":
        levels = tr.compute_graph.pair.fwd.nbr
        live = sum(n.shape[1] > 0 for n in levels)
        # two layers: per layer the gathers and each live level's scores,
        # each level's softmax, both transposes, the forward and backward
        # aggregation
        assert (seen["nts.gat.scores"], seen["nts.gat.softmax"]) == (2 * (1 + live),
                                                                     2 * len(levels))
        assert (seen["nts.gat.project"], seen["nts.gat.grad_alpha"]) == (2, 2)
        assert (seen["nts.gat.transpose"], seen["nts.ell.aggregate"]) == (4, 4)
    else:
        # forward at both layers, backward at the second (the first's input
        # takes no gradient)
        assert seen["nts.ell.aggregate"] == 3


def test_annotate_builds_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    assert profiling.annotate("nts.a") is profiling.annotate("nts.b")
    tr = _kernel_trainer("GATCPU")
    loss, _ = tr.train_step()
    assert torch.isfinite(loss)
    with tr.tracer.span("unit"):
        pass


def test_step_counters_rise_once_per_step(monkeypatch):
    tr = _kernel_trainer("GATCPU")
    adds = []
    add = tr.metrics.counter_add

    def spy(name, value=1.0):
        adds.append((name, value))
        add(name, value)

    monkeypatch.setattr(tr.metrics, "counter_add", spy)
    for n in (1, 2):
        tr.train_step()
        step = [(k, v) for k, v in adds if k.startswith("step.")]
        assert [k for k, _ in step] == ["step.forward_s", "step.backward_s", "step.optim_s"] * n
        assert all(v > 0 for _, v in step)
    counters = tr.metrics.snapshot(include_hists=False)["counters"]
    for name in ("step.forward_s", "step.backward_s", "step.optim_s"):
        assert counters[name] == pytest.approx(sum(v for k, v in adds if k == name))


def _unscoped_step(tr):
    """The step as the trainer ran it before its scopes and counters:
    forward, loss, backward, Adam; returns the loss and the gradients."""
    for p in tr.flat_params:
        p.grad = None
    logits = tr.model_forward(tr.params, tr.compute_graph, tr.feature, True)
    loss = tr.masked_nll_loss(logits, tr.label, tr.train01)
    loss.backward()
    grads = [p.grad.clone() for p in tr.flat_params]
    adam_update(tr.flat_params, [p.grad for p in tr.flat_params], tr.opt_state, tr.adam_cfg)
    return loss.detach(), grads


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("algorithm", ["GCNCPU", "GATCPU"])
def test_train_step_is_bitwise_the_unscoped_step(algorithm, profiled):
    """Scopes and counters leave the loss, the gradients and the update
    bitwise as they were, with dropout on and with a profiler recording."""
    new = _kernel_trainer(algorithm, drop_rate=0.5)
    old = _kernel_trainer(algorithm, drop_rate=0.5)
    for _ in range(2):
        with (_cpu_profile() if profiled else contextlib.nullcontext()):
            loss, _ = new.train_step()
        ref_loss, ref_grads = _unscoped_step(old)
        assert torch.equal(loss, ref_loss)
        for p, g in zip(new.flat_params, ref_grads):
            assert torch.equal(p.grad, g)
        for p, q in zip(new.flat_params, old.flat_params):
            assert torch.equal(p, q)


@pytest.mark.parametrize("algorithm,phases", [("GCNCPU", ["ell_tables"]),
                                              ("GATCPU", ["ell_tables", "slot_maps"])])
def test_set_up_phases_in_the_phase_report(algorithm, phases):
    tr = _kernel_trainer(algorithm)
    snap, report = tr.timers.snapshot(), tr.timers.report()
    for name in phases:
        assert snap[name]["count"] == 1 and snap[name]["total_s"] > 0
        assert f"#{name}_time=" in report
    assert ("slot_maps" in snap) == (algorithm == "GATCPU")


# ---- the distributed trainers' numerics plane (JAX test_numerics.py) ---------------

DIST_V, DIST_EPOCHS = 120, 3
DIST_ENV = ("NTS_FAULT_SPEC", "NTS_QUANT_PROBE", "NTS_DIST_SIMULATE")


def _dist_cfg(cls, wire_dtype="bf16", epochs=DIST_EPOCHS):
    return _cfg(cls, epochs, "GCNDIST", "8-8-3", vertices=DIST_V, learn_rate=0.01,
                weight_decay=1e-4, decay_epoch=-1, partitions=2,
                dist_path="ring_blocked_sim", kernel_tile=16, wire_dtype=wire_dtype)


def _dist_rig():
    from tests.test_models import _planted_data

    src, dst, jd = _planted_data(v_num=DIST_V, classes=3, f=8, seed=1)
    return src, dst, jd, GNNDatum(feature=jd.feature, label=jd.label, mask=jd.mask)


def _dist_run(tmp, jax_side, p0=None, supervised=False, **env):
    """GCNDIST on the 2-partition ring twin with a bf16 wire (JAX's
    ``_dist_sim``): the trainer and its stream."""
    src, dst, jd, datum = _dist_rig()
    with pytest.MonkeyPatch.context() as mp:
        for k in DIST_ENV:
            mp.delenv(k, raising=False)
        mp.setenv("NTS_METRICS_DIR", str(tmp / "m"))
        mp.setenv("NTS_BACKOFF_BASE_S", "0")
        for k, v in env.items():
            mp.setenv(k, v)
        if jax_side:
            from neutronstarlite_tpu.models.gcn_dist import DistGCNTrainer as JDist

            g = j_build_graph(src, dst, DIST_V, use_native=False)
            tr = JDist.from_arrays(_dist_cfg(JInfo), src, dst, jd, host_graph=g)
            p0 = params_from_jax(tr.params)
            tr.run()
            j_events.set_sink(None)
        else:
            tr = get_algorithm("GCNDIST").from_arrays(
                _dist_cfg(InputInfo), src, dst, datum, device="cpu",
                host_graph=build_graph(src, dst, DIST_V, use_native=False))
            if p0 is not None:
                tr.load_params(p0)
            supervised_run(tr) if supervised else tr.run()
            events.set_sink(None)
            faults.reset()
    return tr, _stream(tmp / "m"), p0


@pytest.fixture(scope="module")
def jax_dist_numerics(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NTS_NO_NATIVE", "1")
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        return _dist_run(tmp_path_factory.mktemp("jax-dist-num"), True, NTS_NUMERICS="1",
                         NTS_QUANT_PROBE="1")


@pytest.fixture(scope="module")
def port_dist_numerics(jax_dist_numerics, tmp_path_factory):
    return _dist_run(tmp_path_factory.mktemp("port-dist-num"), False, jax_dist_numerics[2],
                     NTS_NUMERICS="1", NTS_QUANT_PROBE="1")


def _host_quant_err(x: np.ndarray) -> float:
    """||bf16(x) - x|| / ||x|| in f64 (round to nearest even)."""
    x = np.asarray(x, dtype=np.float32)
    q = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    x64 = x.astype(np.float64)
    return float(np.sqrt(np.mean((q - x64) ** 2)) / np.sqrt(np.mean(x64 ** 2)))


def test_dist_numerics_leaves_the_loss_curve_bitwise(jax_dist_numerics, port_dist_numerics,
                                                     tmp_path):
    """``test_numerics.py:181`` on the distributed trainer: numerics on and
    off give bitwise-equal losses; the stream carries the per-layer groups
    and the wire payload's, in JAX's order."""
    off, _, _ = _dist_run(tmp_path, False, jax_dist_numerics[2])
    on, trecs, _ = port_dist_numerics
    assert on.loss_history == off.loss_history
    _validate_both(trecs)
    names = [(r["name"], r["epoch"]) for r in _of(trecs, "tensor_stats")]
    assert names == [(r["name"], r["epoch"]) for r in _of(jax_dist_numerics[1], "tensor_stats")]
    assert {n for n, _ in names} == {
        "params/l0", "params/l1", "grads/l0", "grads/l1", "acts/l0", "acts/l1", "logits",
        "grads/global", "wire/l0", "wire.payload/l0"}


def test_dist_numerics_epoch0_stats_match_jax(jax_dist_numerics, port_dist_numerics):
    jst = [r for r in _of(jax_dist_numerics[1], "tensor_stats") if r["epoch"] == 0]
    tst = [r for r in _of(port_dist_numerics[1], "tensor_stats") if r["epoch"] == 0]
    for t, j in zip(tst, jst):
        assert t["name"] == j["name"]
        for key in ("finite_fraction", "zero_fraction"):
            assert t[key] == pytest.approx(j[key], abs=1e-6), (t["name"], key)
        for key in ("absmax", "rms", "grad_global_norm"):
            if j.get(key) is not None:
                assert t[key] == pytest.approx(j[key], rel=1e-4), (t["name"], key)
        if "quant_rel_err" in j:
            assert abs(t["quant_rel_err"] - j["quant_rel_err"]) <= 1e-6


def test_dist_quant_probe_gauge_and_record(jax_dist_numerics, port_dist_numerics):
    """``test_numerics.py:363``: one payload record per epoch, the gauge the
    last record's value, within 1e-6 of the host's exact value on the same
    payload and of JAX's measurement."""
    tr, trecs, _ = port_dist_numerics
    payloads = [r for r in _of(trecs, "tensor_stats") if r["name"] == "wire.payload/l0"]
    assert len(payloads) == DIST_EPOCHS
    err = payloads[-1]["quant_rel_err"]
    assert tr.metrics.snapshot()["gauges"]["wire.quant_rel_err"] == err
    assert _of(trecs, "run_summary")[-1]["gauges"]["wire.quant_rel_err"] == err
    assert abs(err - _host_quant_err(tr.feature.numpy())) <= 1e-6
    jerr = [r for r in _of(jax_dist_numerics[1], "tensor_stats")
            if r["name"] == "wire.payload/l0"][-1]["quant_rel_err"]
    assert abs(err - jerr) <= 1e-6


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quant_rel_err_matches_host_exact(scale):
    """``test_numerics.py:345``: the measurement against a host-side exact
    computation, within 1e-6, and the probe's stats at the wire dtype."""
    from neutronstarlite_torch.parallel.ring_schedule import payload_quant_probe

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((257, 33)) * scale).astype(np.float32)
    measured = float(t_numerics.quant_rel_err(torch.from_numpy(x), torch.bfloat16))
    assert abs(measured - _host_quant_err(x)) <= 1e-6
    assert 0 < measured < 0.01
    st = payload_quant_probe(torch.bfloat16)(torch.from_numpy(x))
    assert float(st["quant_rel_err"]) == measured
    assert int(st["count"]) == x.size and int(st["nonfinite_count"]) == 0


@pytest.mark.parametrize("layer", [0, 1])
def test_provenance_names_injected_layer_dist(jax_dist_numerics, tmp_path, layer):
    """``test_numerics.py:299``: the chaos oracle on the distributed
    trainer: ``nan_loss@epoch=1,layer=k`` under supervised_run, the
    provenance replay through the forward's tap names layer k."""
    tr, recs, _ = _dist_run(tmp_path, False, jax_dist_numerics[2], supervised=True,
                            NTS_FAULT_SPEC=f"nan_loss@epoch=1,layer={layer}")
    assert np.isfinite(tr.loss_history[-1])
    prov = _of(recs, "nonfinite_provenance")
    assert len(prov) == 1
    assert (prov[0]["layer"], prov[0]["op"], prov[0]["injected"]) == (layer, "activation", True)
