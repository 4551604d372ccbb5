"""The port's autotuner, wire accounting and exchange benchmark against the JAX package's.

Rig: the 120-vertex planted graph of ``tests/test_tune.py``, one host graph
per package (NumPy builders, so both hold the same CSC order).

- Candidate lists, label for label and in order, for every family under
  each auto subset: ``dist_dense`` on the twin and with ``mesh_reachable``
  forced true on both sides, ``edge_single``, ``edge_dist``, ``sampled``,
  ``plain``; every tuple passes the port class's own ``check_cfg`` and a
  tuple it refuses is absent.
- Priors and accounting: ``analytic_priors``, ``predict_all``,
  ``accounting``, ``sample_h2d_bytes_per_epoch`` and the ``--json`` CLI
  equal JAX's exactly.
- Cache: ``CacheKey.filename`` equals JAX's; a schema change, a digest
  change, a backend change, a torn write and a crashed writer are warned
  misses; an entry either package wrote parses in the other.
- Trial legs: each ``dist_dense`` and ``edge_*`` leg's value equals JAX's
  leg on the same seeded inputs (f32, rtol 1e-5).
- A cold cache in cached mode makes JAX's prior decision.
- End to end (``NTS_TUNE=measure``, ``NTS_TUNE_STEPS=1``): schema-valid
  records, a pick no slower than any trialled candidate, a cached replay
  with no trials, the resolved run bitwise the pinned one; off mode
  refuses with JAX's words and ``DIST_PATH:auto`` keeps its legacy meaning;
  ``reconsult_for_replan`` hits a P-1 entry or falls back to the prior.
- In background processes: 4 gloo ranks tuning ``DIST_PATH:auto``
  (``tools/dist_parity --routes tune``) and the shipped cfgs through the
  port's CLI (``gcn_dist_tune_smoke.cfg`` measure then cached,
  ``gcn_dist_mesh_smoke.cfg`` with ``NTS_MESH=auto``).
- ``comm_bench``'s static columns equal JAX's, and its JSON has JAX's keys.

Torch runs on one thread.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.base import get_algorithm as j_get_algorithm
from neutronstarlite_tpu.parallel import comm_bench as j_bench
from neutronstarlite_tpu.tools import wire_accounting as j_wire
from neutronstarlite_tpu.tune import cache as j_cache
from neutronstarlite_tpu.tune import runner as j_runner
from neutronstarlite_tpu.tune import select as j_select
from neutronstarlite_tpu.tune import space as j_space
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.graph.synthetic import planted_partition_graph
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.obs.schema import validate_stream
from neutronstarlite_torch.parallel import comm_bench as t_bench
from neutronstarlite_torch.parallel import mesh as t_mesh
from neutronstarlite_torch.tools import wire_accounting as t_wire
from neutronstarlite_torch.tune import cache as t_cache
from neutronstarlite_torch.tune import runner as t_runner
from neutronstarlite_torch.tune import select as t_select
from neutronstarlite_torch.tune import space as t_space
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORA = os.path.join(REPO, "tests", "fixtures", "cora", "cora.2708.edge.self")
V, F, CLASSES = 120, 8, 3
RTOL = 1e-5
TUNE_ENV = ("NTS_TUNE", "NTS_TUNE_DIR", "NTS_TUNE_STEPS", "NTS_TUNE_MAX_TRIALS",
            "NTS_DIST_SIMULATE", "NTS_ELL_LEVELS", "NTS_WIRE_DTYPE", "NTS_MESH",
            "NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_SAMPLE_PIPELINE", "NTS_PROGRAM_COST")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in TUNE_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def _cmd_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in TUNE_ENV}
    env.update(PYTHONPATH=REPO, NTS_NO_NATIVE="1", OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The legs that run in other processes, started before the first test
    so that they run beside the in-process ones: 4 gloo ranks tuning
    ``DIST_PATH:auto`` under measure, and the port's CLI on the two
    shipped cfgs (measure then cached into one cache directory)."""
    d = tmp_path_factory.mktemp("bg")
    out = {"dir": d}
    out["gloo"] = subprocess.Popen(
        [sys.executable, "-m", "neutronstarlite_torch.tools.dist_parity", "--partitions", "4",
         "--device", "cpu", "--routes", "tune", "--vertices", "400", "--edges", "4000",
         "--layers", "31-15-7", "--epochs", "3"],
        cwd=REPO, env=_cmd_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    script = ";".join([
        "from neutronstarlite_torch.run import main",
        "import os, sys",
        "cfg, tune_dir, mdir = sys.argv[1:4]",
        "os.environ.update(NTS_TUNE_DIR=tune_dir, NTS_TUNE='measure', "
        "NTS_METRICS_DIR=mdir + '/measure')",
        "assert main([cfg, '--device', 'cpu']) == 0",
        "os.environ.update(NTS_TUNE='cached', NTS_METRICS_DIR=mdir + '/cached')",
        "assert main([cfg, '--device', 'cpu']) == 0",
    ])
    for name, extra in (("tune", dict(NTS_DIST_SIMULATE="1")), ("mesh", dict(NTS_MESH="auto"))):
        cfg = os.path.join(REPO, "configs", f"gcn_dist_{name}_smoke.cfg")
        out[name] = subprocess.Popen(
            [sys.executable, "-c", script, cfg, str(d / f"{name}_tune"), str(d / name)],
            cwd=REPO, env=_cmd_env(NTS_TUNE_STEPS="1", **extra),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield out
    for key in ("gloo", "tune", "mesh"):
        if out[key].poll() is None:
            out[key].kill()
            out[key].communicate()


@pytest.fixture
def warnings_seen():
    """The port's warning lines (its loggers do not propagate)."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = Keep(logging.WARNING)
    root = logging.getLogger("nts_torch")
    root.addHandler(h)
    yield lines
    root.removeHandler(h)


def _finish(proc, timeout=300):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (stdout[-2000:], stderr[-3000:])
    return stdout


@pytest.fixture(scope="module")
def rig():
    src, dst, feature, label = planted_partition_graph(V, CLASSES, avg_degree=10,
                                                       feature_size=F, seed=3)
    mask = (np.arange(V) % 3).astype(np.int32)
    out = {"src": src, "dst": dst,
           "datum": GNNDatum(feature=feature, label=label.astype(np.int32), mask=mask),
           "jdatum": JDatum(feature=feature, label=label.astype(np.int32), mask=mask)}
    for weight in ("gcn_norm", "ones"):
        out[("j", weight)] = j_build_graph(src, dst, V, weight=weight, use_native=False)
        out[("t", weight)] = build_graph(src, dst, V, weight=weight)
    return out


# ---- the cfgs of each family ---------------------------------------------------------

FAMILIES = {
    # name -> (ALGORITHM, weight, fields)
    "dist": ("GCNDIST", "gcn_norm", dict(partitions=4, kernel_tile=16)),
    "dist_eager": ("GCNEAGERDIST", "gcn_norm", dict(partitions=4, kernel_tile=16)),
    "gat": ("GATCPU", "ones", {}),
    "ggcn": ("GGCNCPU", "ones", {}),
    "gat_dist": ("GATDIST", "ones", dict(partitions=2)),
    "ggcn_dist": ("GGCNDIST", "ones", dict(partitions=2)),
    "sample": ("GCNSAMPLE", "gcn_norm", dict(batch_size=16, fanout_string="4-3")),
    "plain": ("GCNCPU", "gcn_norm", {}),
    "plain_cache": ("GCNDISTCACHE", "gcn_norm", dict(partitions=2)),
}


def _cfgs(family: str, autos=(), **pins):
    """(JAX cfg, port cfg) with the same fields: ``autos`` set to auto,
    ``pins`` set to their values."""
    algo, _, fields = FAMILIES[family]
    out = []
    for cls in (JInfo, InputInfo):
        cfg = cls()
        cfg.algorithm = algo
        cfg.vertices = V
        cfg.layer_string = f"{F}-8-{CLASSES}"
        cfg.epochs = 2
        cfg.decay_epoch = -1
        cfg.drop_rate = 0.0
        for k, v in dict(fields, **pins).items():
            setattr(cfg, k, v)
        for a in autos:
            setattr(cfg, a, "auto")
        out.append(cfg)
    return out


def _labels(cands):
    return [c.label() for c in cands]


SPACE_CASES = [
    ("dist", ("dist_path", "kernel", "wire_dtype"), {}, True),
    ("dist", ("dist_path", "wire_dtype", "mesh"), {}, True),
    ("dist", ("mesh",), dict(dist_path="ring_blocked_sim"), True),
    ("dist", ("wire_dtype", "mesh"), dict(dist_path="ring_blocked"), True),
    ("dist", ("dist_path", "kernel", "wire_dtype"), {}, False),
    ("dist", ("dist_path", "wire_dtype", "mesh"), {}, False),
    ("dist", ("dist_path",), {}, False),
    ("dist", ("mesh",), dict(optim_kernel=True), False),
    ("dist_eager", ("dist_path", "wire_dtype", "mesh"), {}, True),
    ("gat", ("kernel", "ell_levels"), {}, False),
    ("gat", ("ell_levels",), {}, False),
    ("gat", ("ell_levels",), dict(kernel="fused_edge"), False),
    ("gat", ("kernel",), dict(optim_kernel=True), False),
    ("ggcn", ("kernel", "ell_levels"), {}, False),
    ("gat_dist", ("kernel",), {}, True),
    ("gat_dist", ("kernel",), {}, False),
    ("ggcn_dist", ("kernel",), {}, True),
    ("sample", ("sample_pipeline",), {}, False),
    ("plain", ("kernel", "ell_levels"), {}, False),
    ("plain_cache", ("kernel", "wire_dtype"), {}, True),
]


def _reach(monkeypatch, on: bool):
    """mesh_reachable forced to ``on`` in both packages."""
    monkeypatch.setattr(j_space, "mesh_reachable", lambda P: on)
    monkeypatch.setattr(t_space, "mesh_reachable", lambda P: on)
    monkeypatch.setattr(t_runner, "mesh_reachable", lambda P: on)


@pytest.mark.parametrize("family,autos,pins,sim", SPACE_CASES)
def test_candidate_lists_equal_jax(monkeypatch, family, autos, pins, sim):
    """The port's space is JAX's, label for label and in order, and every
    tuple in it passes the port class's own check entry point."""
    _reach(monkeypatch, not sim)
    jcfg, tcfg = _cfgs(family, autos, **pins)
    P = max(int(getattr(tcfg, "partitions", 0) or 0), 1)
    jcls, tcls = j_get_algorithm(jcfg.algorithm), get_algorithm(tcfg.algorithm)
    assert t_space.family_of(tcls) == j_space.family_of(jcls)
    want = _labels(j_space.enumerate_candidates(jcls, jcfg, P, simulate=sim))
    got = t_space.enumerate_candidates(tcls, tcfg, P, simulate=sim)
    assert _labels(got) == want and want
    for cand in got:
        tcls.check_cfg(t_space.apply_candidate(tcfg, cand, t_space.auto_axes(tcfg)))


def test_refused_tuples_are_absent():
    """A tuple the funnel refuses is never proposed: fused_edge on the GCN
    family, bf16 wire beside all_gather, all_gather on the twin."""
    _, cfg = _cfgs("dist", ("dist_path", "kernel", "wire_dtype"))
    cls = get_algorithm("GCNDIST")
    autos = t_space.auto_axes(cfg)
    assert not t_space.candidate_valid(cls, cfg, t_space.Candidate(kernel="fused_edge"), autos)
    with pytest.raises(ValueError, match="fused_edge"):
        cls.check_cfg(t_space.apply_candidate(cfg, t_space.Candidate(kernel="fused_edge"),
                                              autos))
    labels = _labels(t_space.enumerate_candidates(cls, cfg, 4, simulate=True))
    assert labels == ["ring_blocked|-|-|-|-|-", "ring_blocked|-|-|bf16|-|-"]
    assert t_space.Candidate.from_label("ring_blocked|-|-|bf16|2,2|-") == t_space.Candidate(
        dist_path="ring_blocked", wire_dtype="bf16", mesh="2,2")
    with pytest.raises(ValueError):
        t_space.Candidate.from_label("ring_blocked|bf16")


# ---- priors and accounting ------------------------------------------------------------

PRIOR_CASES = [
    ("dist", ("dist_path", "wire_dtype", "mesh"), "float32", {}),
    ("dist", ("dist_path", "wire_dtype", "mesh"), "bfloat16", {}),
    ("dist_eager", ("dist_path", "wire_dtype", "mesh"), "float32", {}),
    ("gat", ("kernel", "ell_levels"), "float32", {}),
    ("ggcn", ("kernel", "ell_levels"), "float32", {}),
    ("gat_dist", ("kernel",), "float32", {}),
    ("ggcn_dist", ("kernel",), "float32", {}),
    ("sample", ("sample_pipeline",), "float32", dict(batch_size=16, fanouts=[4, 3],
                                                     n_seeds=40)),
    ("sample", ("sample_pipeline",), "float32", None),
]


@pytest.mark.parametrize("family,autos,precision,sample_cfg", PRIOR_CASES)
def test_analytic_priors_equal_jax(rig, monkeypatch, family, autos, precision, sample_cfg):
    _reach(monkeypatch, True)
    algo, weight, _ = FAMILIES[family]
    jcfg, tcfg = _cfgs(family, autos)
    P = max(int(getattr(tcfg, "partitions", 0) or 0), 1)
    jcls, tcls = j_get_algorithm(algo), get_algorithm(algo)
    cands = t_space.enumerate_candidates(tcls, tcfg, P)
    jcands = j_space.enumerate_candidates(jcls, jcfg, P)
    fam = t_space.family_of(tcls)
    sizes = tcfg.layer_sizes()
    C = tcls.edge_score_channels(sizes[1]) if fam.startswith("edge") else 1
    eager = bool(getattr(tcls, "eager", False))
    kw = dict(precision=precision, score_channels=C, eager_widths=eager, sample_cfg=sample_cfg)
    got = t_runner.analytic_priors(rig[("t", weight)], P, sizes, fam, cands, **kw)
    want = j_runner.analytic_priors(rig[("j", weight)], P, sizes, fam, jcands, **kw)
    assert got == want and all(isinstance(v, int) for v in got.values())


@pytest.fixture(scope="module")
def cora_graphs():
    src, dst = load_edges(CORA)
    js, jd = j_load_edges(CORA)
    return (j_build_graph(js, jd, 2708, weight="gcn_norm", use_native=False),
            build_graph(src, dst, 2708, weight="gcn_norm"))


@pytest.mark.parametrize("P,f,widths,itemsize,mesh", [
    (4, 32, None, 4, None), (8, 602, [602, 128], 2, (4, 2)), (3, 16, [16, 8], 1, (1, 3)),
])
def test_predict_all_equals_jax(cora_graphs, P, f, widths, itemsize, mesh):
    jg, tg = cora_graphs
    assert t_wire.predict_all(tg, P, f, widths=widths, itemsize=itemsize, mesh=mesh) == \
        j_wire.predict_all(jg, P, f, widths=widths, itemsize=itemsize, mesh=mesh)


@pytest.mark.parametrize("P,budget", [(4, 256 << 20), (8, 64 << 10)])
def test_accounting_equals_jax(cora_graphs, P, budget):
    jg, tg = cora_graphs
    got = t_wire.accounting(tg, P, 64, refresh=3, budget_bytes=budget)
    assert got == j_wire.accounting(jg, P, 64, refresh=3, budget_bytes=budget)
    assert got["comm_auto"]["wire_optimal"] and got["rep_auto"]["fits"]


@pytest.mark.parametrize("total", [4, 6, 8])
def test_mesh_shape_choice_equals_jax(cora_graphs, total):
    """``factor_shapes`` and the analytic ``choose_mesh_shape`` of the
    partitioner, as JAX's."""
    from neutronstarlite_tpu.parallel import partitioner as j_part

    from neutronstarlite_torch.parallel import partitioner as t_part

    jg, tg = cora_graphs
    assert [(m.pv, m.pf) for m in t_part.factor_shapes(total)] == \
        [(m.pv, m.pf) for m in j_part.factor_shapes(total)]
    for widths, outs in (([1433, 16], [16, 7]), ([64, 32], None)):
        got = t_part.choose_mesh_shape(tg, total, widths, out_widths=outs)
        want = j_part.choose_mesh_shape(jg, total, widths, out_widths=outs)
        assert (got.pv, got.pf) == (want.pv, want.pf)


def test_sample_bytes_equal_jax():
    for caps, fans in (([64, 16, 4], [4, 4]), ([4000, 400, 16], [10, 25])):
        assert t_wire.sample_batch_payload_bytes(caps, fans) == \
            j_wire.sample_batch_payload_bytes(caps, fans)
        for mode in ("sync", "pipelined", "device", "fused"):
            assert t_wire.sample_h2d_bytes_per_epoch(1000, caps, fans, mode) == \
                j_wire.sample_h2d_bytes_per_epoch(1000, caps, fans, mode)


@pytest.mark.parametrize("argv", [
    ["--cora", "--partitions", "4", "--feature", "32", "--json"],
    ["--cora", "--partitions", "4", "--feature", "32", "--json", "--mesh", "2x2"],
    ["--cora", "--partitions", "8", "--feature", "64"],
])
def test_wire_accounting_cli_equals_jax(capsys, argv):
    assert t_wire.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_wire.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["graph"] == "cora"


# ---- the decision cache -----------------------------------------------------------------


def _key_facts(**over):
    base = dict(graph_digest="d" * 64, family="dist_dense/DistGCNTrainer", partitions=4,
                layers="8-8-3", backend="torch-2/cpu/cpux1")
    base.update(over)
    return base


def _decision():
    return {"dist_path": "ring_blocked", "kernel": "", "ell_levels": "",
            "wire_dtype": "bf16", "mesh": "", "sample_pipeline": "",
            "candidate": "ring_blocked|-|-|bf16|-|-", "seconds": 0.01,
            "predicted_bytes": 4096, "source": "measured"}


@pytest.mark.parametrize("facts", [
    _key_facts(), _key_facts(partitions=3, layers="1433-16-7"),
    _key_facts(backend="torch-2.11.0+cu128/cuda-12.8/NVIDIA H100 80GB HBM3x1"),
])
def test_cache_filename_equals_jax(facts):
    assert t_cache.CacheKey(**facts).filename() == j_cache.CacheKey(**facts).filename()


def _stale(d, key, how):
    path = t_cache.store(key, _decision(), directory=d)
    if how == "schema":
        with open(path) as fh:
            raw = json.load(fh)
        raw["tune_schema"] = t_cache.TUNE_SCHEMA_VERSION + 1
        with open(path, "w") as fh:
            json.dump(raw, fh)
        return key
    if how == "digest":
        return t_cache.CacheKey(**_key_facts(graph_digest="e" * 64))
    if how == "backend":
        return t_cache.CacheKey(**_key_facts(backend="jax-0.4/cpu/cpux8"))
    if how == "torn":
        with open(path, "w") as fh:
            fh.write('{"tune_schema": 3,')
        return key
    assert how == "crashed"  # a writer that died before os.replace
    os.remove(path)
    with open(key.path(d) + ".tmp-999", "w") as fh:
        fh.write('{"tune_schema": 3, "key": {')
    return key


@pytest.mark.parametrize("how", ["schema", "digest", "backend", "torn", "crashed"])
def test_cache_stale_entries_are_misses(tmp_path, warnings_seen, how):
    d = str(tmp_path)
    key = t_cache.CacheKey(**_key_facts())
    assert t_cache.load(key, d) is None
    lookup = _stale(d, key, how)
    assert t_cache.load(lookup, d) is None
    if how in ("schema", "torn"):
        assert "re-tuning" in warnings_seen[-1]
    # a fresh store over it recovers
    t_cache.store(lookup, _decision(), directory=d)
    assert t_cache.load(lookup, d)["decision"]["candidate"] == "ring_blocked|-|-|bf16|-|-"


def test_entries_parse_across_packages(tmp_path, warnings_seen):
    """An entry either package wrote parses in the other; a lookup with the
    other package's backend (same other facts) is a miss."""
    d = str(tmp_path)
    jfacts = _key_facts(backend="jax-0.4.30/cpu/cpux8")
    j_cache.store(j_cache.CacheKey(**jfacts), _decision(), directory=d, autos=["wire_dtype"])
    entry = t_cache.load(t_cache.CacheKey(**jfacts), d)
    assert entry["decision"] == _decision() and entry["autos"] == ["wire_dtype"]
    t_cache.store(t_cache.CacheKey(**_key_facts()), _decision(), directory=d)
    assert j_cache.load(j_cache.CacheKey(**_key_facts()), d)["decision"] == _decision()
    ported = t_cache.CacheKey(**dict(jfacts, backend=t_cache.backend_fingerprint()))
    assert t_cache.load(ported, d) is None
    # an entry under the right name whose embedded key names the other
    # backend: a warned miss
    os.replace(j_cache.CacheKey(**jfacts).path(d), ported.path(d))
    assert t_cache.load(ported, d) is None
    assert "refusing to reuse" in warnings_seen[-1]
    assert t_cache.store(ported, _decision(), directory=None) is None
    assert t_cache.find_entries(d, partitions=4) and t_cache.flag_for_retrial(
        t_cache.find_entries(d)[0], "test")


# ---- trial legs -------------------------------------------------------------------------


def _record_legs(monkeypatch):
    """Both packages' ``_time_leg`` replaced by one call that records the
    leg's value (the loss at scale 1)."""
    got, want = {}, {}

    def j_leg(fn, steps, metrics=None, label=""):
        want[label] = float(jax.jit(fn)(jnp.float32(1.0))[0])
        return 1.0

    def t_leg(fn, steps, metrics=None, label="", device="cpu", dims=(0, 0)):
        got[label] = float(fn(1.0)[0])
        return 1.0

    monkeypatch.setattr(j_runner, "_time_leg", j_leg)
    monkeypatch.setattr(t_runner, "_time_leg", t_leg)
    return got, want


LEG_CASES = [
    ("dist", ("dist_path", "wire_dtype", "mesh"), True),
    ("dist", ("dist_path",), False),
    ("gat", ("kernel", "ell_levels"), False),
    ("ggcn", ("kernel", "ell_levels"), False),
    ("gat_dist", ("kernel",), True),
    ("ggcn_dist", ("kernel",), True),
]


@pytest.mark.parametrize("family,autos,sim", LEG_CASES)
def test_trial_legs_equal_jax(rig, monkeypatch, family, autos, sim):
    """Each leg computes JAX's leg's value: the same inputs drawn in the
    same order, the same exchange and contraction. Off the twin the port
    runs its one-process all_gather family in place of ranks (JAX runs its
    8-device CPU mesh)."""
    _reach(monkeypatch, not sim)
    if not sim:
        monkeypatch.setattr(t_mesh, "resolve_group", lambda P, s: (None, P))
        monkeypatch.setattr(t_mesh, "resolve_grid", lambda pv, pf, s: None)
    got, want = _record_legs(monkeypatch)
    algo, weight, _ = FAMILIES[family]
    jcfg, tcfg = _cfgs(family, autos)
    P = max(int(getattr(tcfg, "partitions", 0) or 0), 1)
    cls = get_algorithm(algo)
    cands = t_space.enumerate_candidates(cls, tcfg, P, simulate=sim)
    fam = t_space.family_of(cls)
    sizes = tcfg.layer_sizes()
    C = cls.edge_score_channels(sizes[1]) if fam.startswith("edge") else 1
    kw = dict(kernel_tile=tcfg.kernel_tile, score_channels=C, steps=1)
    t_out = t_runner.measure_candidates(rig[("t", weight)], P, sizes, fam, cands, sim, **kw)
    j_out = j_runner.measure_candidates(rig[("j", weight)], P, sizes, fam, [
        j_space.Candidate.from_label(c.label()) for c in cands], sim, **kw)
    assert {k: v is None for k, v in t_out.items()} == {k: v is None for k, v in j_out.items()}
    assert got.keys() == want.keys() and got
    for label, value in want.items():
        assert np.isclose(got[label], value, rtol=RTOL, atol=0), (label, got[label], value)


def test_sampled_legs_run(rig):
    """The sampled family's four legs each measure a time on the CPU (the
    fused one eagerly)."""
    cands = [t_space.Candidate(sample_pipeline=m) for m in ("", "pipelined", "device", "fused")]
    out = t_runner.measure_candidates(rig[("t", "gcn_norm")], 1, [F, 8, CLASSES], "sampled",
                                      cands, False, steps=1,
                                      sample_cfg={"batch_size": 16, "fanouts": [4, 3]})
    assert all(v is not None and v > 0 for v in out.values()) and len(out) == 4


# ---- decisions --------------------------------------------------------------------------


def _probe(cls, cfg, graph, device=None):
    p = object.__new__(cls)
    p.cfg, p.host_graph, p.metrics, p.datum = cfg, graph, None, None
    if device is not None:
        p.device = device
    return p


@pytest.mark.parametrize("family,autos,sim", [
    ("dist", ("dist_path", "kernel", "wire_dtype"), True),
    ("dist", ("dist_path", "wire_dtype", "mesh"), True),
    ("dist", ("dist_path", "wire_dtype", "mesh"), False),
    ("gat", ("kernel", "ell_levels"), False),
    ("gat_dist", ("kernel",), True),
    ("sample", ("sample_pipeline",), False),
    ("plain", ("kernel",), False),
])
def test_cold_cache_decision_equals_jax(rig, monkeypatch, tmp_path, family, autos, sim):
    """NTS_TUNE=cached on a cold cache: the prior decides, as in JAX, and
    nothing is stored."""
    _reach(monkeypatch, not sim)
    monkeypatch.setenv("NTS_TUNE", "cached")
    monkeypatch.setenv("NTS_TUNE_DIR", str(tmp_path))
    if sim:
        monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    algo, weight, _ = FAMILIES[family]
    jcfg, tcfg = _cfgs(family, autos)
    j_select.resolve_auto_knobs(_probe(j_get_algorithm(algo), jcfg, rig[("j", weight)]))
    t_select.resolve_auto_knobs(_probe(get_algorithm(algo), tcfg, rig[("t", weight)],
                                       torch.device("cpu")))
    for axis in t_space.AXES:
        assert getattr(tcfg, axis) == getattr(jcfg, axis), axis
    assert not os.listdir(tmp_path)


def _train_cfg(**over):
    _, cfg = _cfgs("dist", ("dist_path", "kernel", "wire_dtype"))
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _events(d):
    evs = []
    for p in sorted(glob.glob(os.path.join(str(d), "*.jsonl"))):
        with open(p) as fh:
            evs.extend(json.loads(line) for line in fh if line.strip())
    validate_stream(evs)
    return evs


def _of(evs, kind):
    return [e for e in evs if e["event"] == kind]


def _build(rig, cfg, algo="GCNDIST"):
    return get_algorithm(algo).from_arrays(cfg, rig["src"], rig["dst"], rig["datum"],
                                           device="cpu", host_graph=rig[("t", "gcn_norm")])


def test_measure_cached_and_pinned_end_to_end(rig, monkeypatch, tmp_path):
    """measure: schema-valid records, the pick no slower than any trialled
    candidate, its program cost; cached: the same decision, no trials;
    pinned: the resolved run's losses bitwise."""
    monkeypatch.setenv("NTS_TUNE", "measure")
    monkeypatch.setenv("NTS_TUNE_STEPS", "1")
    monkeypatch.setenv("NTS_TUNE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "m1"))
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    t1 = _build(rig, _train_cfg())
    assert t1.cfg.dist_path == "ring_blocked" and t1.cfg.kernel == ""
    t1.run()
    evs = _events(tmp_path / "m1")
    (d1,) = _of(evs, "tune_decision")
    trials = _of(evs, "tune_trial")
    assert d1["source"] == "measured" and d1["partitions"] == 4 and len(trials) == 2
    measured = [t for t in trials if t["seconds"] is not None]
    assert d1["seconds"] <= min(t["seconds"] for t in measured)
    costs = {e["label"] for e in _of(evs, "program_cost")}
    assert {f"tune.trial/{t['candidate']}" for t in measured} <= costs
    assert len(glob.glob(str(tmp_path / "cache" / "tune-*.json"))) == 1
    gauges = t1.metrics.snapshot()["gauges"]
    assert gauges["tune.decision"] == d1["candidate"]

    monkeypatch.setenv("NTS_TUNE", "cached")
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "m2"))
    t2 = _build(rig, _train_cfg())
    t2.run()
    evs = _events(tmp_path / "m2")
    assert not _of(evs, "tune_trial")
    (d2,) = _of(evs, "tune_decision")
    assert d2["source"] == "cached" and d2["candidate"] == d1["candidate"]

    monkeypatch.delenv("NTS_TUNE")
    cand = t_space.Candidate.from_label(d1["candidate"])
    t3 = _build(rig, _train_cfg(**cand.as_dict()))
    t3.run()
    assert t2.loss_history == t3.loss_history == t1.loss_history


def test_off_mode_refuses_with_jax_wording(rig):
    jcfg, tcfg = _cfgs("dist", ("dist_path", "kernel", "wire_dtype"))
    with pytest.raises(ValueError) as want:
        j_select.resolve_auto_knobs(_probe(j_get_algorithm("GCNDIST"), jcfg,
                                           rig[("j", "gcn_norm")]))
    with pytest.raises(ValueError) as got:
        _build(rig, tcfg)
    assert str(got.value) == str(want.value) and "NTS_TUNE" in str(got.value)


def test_dist_path_auto_keeps_its_legacy_meaning(rig, monkeypatch):
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    cfg = _train_cfg(kernel="", wire_dtype="", kernel_tile=0)
    tr = _build(rig, cfg)
    assert cfg.dist_path == "auto" and tr.comm_layer in ("ring", "ell", "mirror")


def test_reconsult_prior_fallback_and_p_minus_1_hit(rig, monkeypatch, tmp_path):
    """The replan re-resolves for P' = P - 1: a cold P' is the prior, a
    measured P' entry is cached; neither measures."""
    monkeypatch.setenv("NTS_TUNE", "measure")
    monkeypatch.setenv("NTS_TUNE_STEPS", "1")
    monkeypatch.setenv("NTS_TUNE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    tr = _build(rig, _train_cfg())
    trials = tr.metrics.counter_get("tune.trials")
    tr.cfg.partitions = 3
    assert t_select.reconsult_for_replan(tr)
    g = tr.metrics.snapshot()["gauges"]
    assert (g["tune.decision_source"], g["tune.partitions"]) == ("prior", 3)
    assert tr.metrics.counter_get("tune.trials") == trials

    _build(rig, _train_cfg(partitions=3))  # measures and stores P = 3
    tr.cfg.partitions = 3
    assert t_select.reconsult_for_replan(tr)
    g = tr.metrics.snapshot()["gauges"]
    assert (g["tune.decision_source"], g["tune.partitions"]) == ("cached", 3)
    assert tr.metrics.counter_get("tune.trials") == trials
    assert not t_select.reconsult_for_replan(_build(rig, _train_cfg(
        dist_path="ring_blocked", kernel="", wire_dtype="")))


def test_edge_single_measure_builds_the_decision(rig, monkeypatch, tmp_path):
    monkeypatch.setenv("NTS_TUNE", "measure")
    monkeypatch.setenv("NTS_TUNE_STEPS", "1")
    _, cfg = _cfgs("gat", ("kernel", "ell_levels"))
    tr = get_algorithm("GATCPU").from_arrays(cfg, rig["src"], rig["dst"], rig["datum"],
                                             device="cpu", host_graph=rig[("t", "ones")])
    assert cfg.kernel in ("", "fused_edge") and len(tr.tune_rows) == 3
    assert cfg.ell_levels in (("binned", "pow2") if cfg.kernel else ("",))
    assert np.isfinite(tr.run()["loss"])


# ---- the background legs ------------------------------------------------------------------


def test_gloo_ranks_tune_dist_path_auto(background):
    """4 gloo ranks under measure: all_gather is in the space and trialled,
    every rank holds the same decision, and the twin pinned to it trains
    the ranks' losses."""
    report = json.loads(_finish(background["gloo"]).strip().splitlines()[-1])
    t = report["routes"]["tune"]
    assert report["ok"] and t["ok"] and t["agree"] and t["all_gather_trialled"]
    assert len(set(t["decisions"])) == 1 and len(t["decisions"]) == 4
    for rows in t["rank_trials"]:
        assert [r["candidate"] for r in rows] == ["all_gather|-|-|-|-|-",
                                                  "ring_blocked|-|-|-|-|-"]
        assert all(r["source"] == "measured" for r in rows)
    # the MAX all-reduce gives every rank the same scores
    assert all(rows == t["rank_trials"][0] for rows in t["rank_trials"])


@pytest.mark.parametrize("name,trials", [("tune", 2), ("mesh", 3)])
def test_shipped_cfgs_through_the_cli(background, name, trials):
    """The shipped cfgs, unchanged: measure, then cached with no trials and
    the same decision."""
    _finish(background[name])
    d = background["dir"] / name
    m, c = _events(d / "measure"), _events(d / "cached")
    (dm,), (dc,) = _of(m, "tune_decision"), _of(c, "tune_decision")
    assert dm["source"] == "measured" and len(_of(m, "tune_trial")) == trials
    assert dc["source"] == "cached" and not _of(c, "tune_trial")
    assert dc["candidate"] == dm["candidate"]
    if name == "mesh":
        assert t_space.Candidate.from_label(dm["candidate"]).mesh in ("", "2,2", "1,4")


# ---- comm_bench ----------------------------------------------------------------------------


def test_comm_bench_static_columns_equal_jax():
    args = (600, 8, 16, 4, 1)
    got = t_bench.bench_layers(*args, kernel_tile=128, device="cpu")
    want = j_bench.bench_layers(*args, kernel_tile=128)
    assert got.keys() == want.keys()
    static = ("wire_rows_per_dev_layer", "wire_mb_per_dev_layer_f32", "peak_live_rows",
              "peak_live_mb_f32")
    for name in ("ring", "ell", "mirror", "ring_blocked", "blocked"):
        assert got[name].keys() == want[name].keys()
        assert {k: got[name][k] for k in static} == {k: want[name][k] for k in static}
        assert np.isclose(got[name]["check"], want[name]["check"], rtol=RTOL)
    assert got["ring_blocked"]["per_step_compute_s"].keys() == \
        want["ring_blocked"]["per_step_compute_s"].keys()
    assert {k: v for k, v in got["meta"].items() if k != "device"} == \
        {k: v for k, v in want["meta"].items() if k != "device"}


def test_comm_bench_mesh_and_edge_json_keys():
    got = t_bench.bench_mesh(600, 8, 16, 2, 2, 1, simulate=True, device="cpu")
    want = j_bench.bench_mesh(600, 8, 16, 2, 2, 1, simulate=True)
    assert got.keys() == want.keys() and got["meta"] == want["meta"]
    for name, op in got["ops"].items():
        ref = want["ops"][name]
        assert op.keys() == ref.keys()
        for k in ("wire_bytes_per_dev_layer", "peak_resident_feature_bytes", "slab_widths"):
            assert op[k] == ref[k]
        assert np.isclose(op["check"], ref["check"], rtol=RTOL)
    got = t_bench.bench_edge_family(600, 8, 8, 2, 1, device="cpu")
    want = j_bench.bench_edge_family(600, 8, 8, 2, 1)
    assert got.keys() == want.keys()
    for name in ("mirror_eager_edge", "ring_fused_edge"):
        assert got[name].keys() == want[name].keys()
        for k in ("wire_vals_per_dev_layer", "edge_hbm_bytes_per_layer"):
            assert got[name][k] == want[name][k]
        assert np.isclose(got[name]["check"], want[name]["check"], rtol=1e-4)
