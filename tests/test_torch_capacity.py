"""The capacity and roofline tools recast for one H100, on the CPU
(``tools/{roofline,aot_check,aot_bench_path,aot_bsp_scale,tpu_plan}.py``).

- ``roofline``: its aggregation term is ``obs/cost.aggregation_cost`` (at
  1.0 scale 1.0606 ms of bytes and 2.9355 ms of operations per standard
  epoch, the kernel table's bound); its ordering is JAX's
  ``test_roofline_model_sanity``; ``collect_measured`` reads fabricated
  step JSONs as JAX's does.
- ``aot_check``: on Cora its static bytes are the ``nbytes`` of the tensors
  the trainer holds; a value of 2^31 in an ``int`` is refused; the CLI's
  cases (single device, sampled, one rank of GCNDIST, GCNEAGERDIST, GATDIST
  and GGCNDIST; the 2D mesh refused); a rank's bytes against a real
  two-rank gloo run.
- ``aot_bsp_scale``: the generator's layout without its edges, the block
  estimate against real builds, and the 10x report without a card.
- ``aot_bench_path`` on a tiny bench graph.
- ``tpu_plan``: JAX's ``Plan`` mechanics (``tests/test_tpu_plan.py``) with
  the probe stubbed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
from neutronstarlite_torch.obs.cost import aggregation_cost
from neutronstarlite_torch.ops.bsp_ell import BspEll
from neutronstarlite_torch.tools import aot_bench_path, aot_bsp_scale, aot_check
from neutronstarlite_torch.tools import roofline as rf
from neutronstarlite_torch.tools import tpu_plan
from neutronstarlite_torch.tools.tpu_plan import Plan, build_steps
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
V1, E1 = 232965, 114615892


# ---- roofline -------------------------------------------------------------------

@pytest.mark.parametrize("order", ["standard", "eager"])
def test_roofline_aggregation_term_is_aggregation_cost(order):
    terms = [t for t in rf.epoch_terms(order, "ell", V1, E1) if t[0].startswith("aggregate")]
    widths = rf.aggregation_calls(order)
    assert len(terms) == len(widths) == (3 if order == "standard" else 4)
    for (_, moved, ops, peak), f in zip(terms, widths):
        assert (ops, moved) == aggregation_cost(E1, V1, f, 2)
        assert peak == rf.H100_F32_FLOPS


def test_roofline_epoch_bound_at_full_scale():
    moved_ms, ops_ms = rf.aggregation_bound_ms("standard", V1, E1)
    assert round(moved_ms, 4) == 1.0606 and round(ops_ms, 4) == 2.9355


def test_roofline_model_sanity(capsys):
    """JAX's ordering: positive, ELL under scatter, the eager order under
    the standard one on the kernel paths; markdown has a row per (order,
    path)."""
    for order in rf.ORDERS:
        assert 0 < rf.bound_s(order, "ell", V1, E1) < rf.bound_s(order, "scatter", V1, E1)
    for path in ("ell", "bsp"):
        assert 0 < rf.bound_s("eager", path, V1, E1) < rf.bound_s("standard", path, V1, E1)
    rf.main(["--markdown", "--runs-dir", "/nonexistent"])
    out = capsys.readouterr().out
    assert out.count("| standard |") == out.count("| eager |") == len(rf.PATHS)
    with pytest.raises(ValueError):
        rf.epoch_terms("standard", "pallas", V1, E1)


@pytest.mark.parametrize("mod", [rf, aot_check, aot_bsp_scale, aot_bench_path, tpu_plan])
def test_tools_name_no_tpu_constant(mod):
    """Past the docstring (which says what the JAX tool did), no TPU
    constant or topology."""
    with open(mod.__file__) as fh:
        code = fh.read().split('"""', 2)[2]
    for word in ("v5e", "VMEM", "MXU", r"\b819\b", "BSP_BLOCKS", "topolog", "jax"):
        assert not re.search(word, code), word


def test_roofline_collect_measured(tmp_path, capsys):
    good = {"metric": "m", "value": 1.5, "unit": "s", "extra": {"order": "eager", "path": "ell"}}
    stale = {"metric": "m_stale", "value": 7.0, "unit": "s",
             "extra": {"order": "standard", "path": "scatter", "stale": True}}
    null = {"metric": "m", "value": None, "extra": {"order": "x", "path": "y"}}
    for name, rec in [("a", good), ("b", stale), ("c", null)]:
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "broken.json").write_text("{not json")
    assert rf.collect_measured(str(tmp_path)) == [("a", 1.5, "eager", "ell", 0)]
    (tmp_path / "warm.json").write_text(
        "[INFO] build log line\n" + json.dumps(
            {"metric": "m", "value": 2.0,
             "extra": {"order": "eager", "path": "bsp", "kernel_tile": 2048}}))
    assert ("warm", 2.0, "eager", "bsp", 2048) in rf.collect_measured(str(tmp_path))
    rf.main(["--json", "--scale", "1.0", "--runs-dir", str(tmp_path)])
    rows = json.loads(capsys.readouterr().out)["rows"]
    row = next(r for r in rows if (r["order"], r["path"]) == ("eager", "ell"))
    assert row["measured_s"] == 1.5 and row["achieved"] == pytest.approx(row["bound_s"] / 1.5)


# ---- aot_check --------------------------------------------------------------------

def _cora_cfg(**over):
    cfg = InputInfo.read_from_cfg_file(os.path.join(CONFIGS, "gcn_cora_smoke.cfg"))
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def cora_ell():
    cfg = _cora_cfg(algorithm="GCN", optim_kernel=True, precision="bfloat16")
    tr = aot_check.build_trainer(cfg, CONFIGS)
    return cfg, tr


def test_aot_check_static_bytes_are_the_trainers_tensors(cora_ell):
    """Every tensor the built trainer holds, enumerated apart from the
    tool: the static bytes are their nbytes, once per storage."""
    cfg, tr = cora_ell
    seen, want = set(), 0
    stack = [v for k, v in vars(tr).items() if k in (
        "compute_graph", "feature", "label", "mask", "train01", "params", "opt_state")]
    while stack:
        obj = stack.pop()
        if torch.is_tensor(obj):
            s = obj.untyped_storage()
            if (s.data_ptr(), s.nbytes()) not in seen:
                seen.add((s.data_ptr(), s.nbytes()))
                want += s.nbytes()
        elif dataclasses.is_dataclass(obj):
            stack += [getattr(obj, f.name) for f in dataclasses.fields(obj)
                      if not f.name.startswith("_")]
        elif isinstance(obj, dict):
            stack += list(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack += list(obj)
    static = aot_check.static_bytes(tr)
    assert sum(static.values()) == want
    assert static["feature"] == tr.feature.numel() * tr.feature.element_size()
    assert static["adam"] == 2 * static["params"]


def test_aot_check_cora_report(cora_ell):
    cfg, tr = cora_ell
    out = aot_check.check(cfg, trainer=tr)
    assert out["case"] == "single_device" and out["route"] == "EllPair"
    assert out["fits"] and out["refused"] == []
    assert out["peak_bytes"] == (out["static_bytes"] + out["kernel_cache"] + out["transient"]
                                 + aot_check.LIBRARY_WORKSPACE)
    assert out["transient"] > 0 and out["kernel_cache"] > 0
    names = {c["name"].split(".")[-1] for c in out["checks"]}
    assert {"n_items", "grid_ctas", "smem_per_block", "f"} <= names
    assert aot_check.check(cfg, trainer=tr, memory_bytes=out["peak_bytes"] - 1)["fits"] is False


def test_aot_check_refuses_an_int_at_2_31():
    assert aot_check.limit("x", 2 ** 31 - 1)["ok"]
    assert not aot_check.limit("x", 2 ** 31)["ok"]
    src, dst = synthetic_power_law_graph(600, 9000, seed=2)
    g = build_graph(src, dst, 600)
    t = BspEll.build(600, g.column_offset, g.row_indices, g.edge_weight_forward, dt=64, vt=128)
    geo = aot_check.kernel_geometry()
    ok, _, _ = aot_check.bsp_launch_checks("bsp", t, 128, torch.bfloat16, geo, 232448)
    assert all(c["ok"] for c in ok)
    huge = dataclasses.replace(t, v_num=2 ** 31, src_num=2 ** 31)
    bad, _, _ = aot_check.bsp_launch_checks("bsp", huge, 128, torch.bfloat16, geo, 232448)
    refused = {c["name"] for c in bad if not c["ok"]}
    assert {"bsp.n_src", "bsp.v_num", "bsp.blk_key_max"} <= refused


def test_aot_check_geometry_from_the_sources():
    geo = aot_check.kernel_geometry()
    assert geo["ell_level"]["source"] == "csrc/ell_level.cu"
    assert geo["ell_level"]["cols"] == 128 and geo["bsp_ell"]["cols"] == 128
    assert geo["bsp_ell"]["max_k"] == 8 and geo["ell_level"]["warps_per_cta"] == 4


def _cora_cfg_file(tmp_path, over) -> str:
    """gcn_cora_smoke.cfg with ``over``'s keys replaced, its paths absolute."""
    lines = []
    with open(os.path.join(CONFIGS, "gcn_cora_smoke.cfg")) as fh:
        for line in fh:
            key = line.split(":", 1)[0]
            if key in over:
                continue
            lines.append(line.replace("../tests", os.path.join(REPO, "tests")))
    lines += [f"{k}:{v}\n" for k, v in over.items()]
    cfg = tmp_path / "c.cfg"
    cfg.write_text("".join(lines))
    return str(cfg)


@pytest.mark.parametrize("over,case,rc", [
    ({"ALGORITHM": "GCN", "OPTIM_KERNEL": "1", "PALLAS": "1"}, "single_device", 0),
    ({"ALGORITHM": "GCNSAMPLESINGLE", "FANOUT": "3-3", "BATCH_SIZE": "32"}, "sampled", 0),
    ({"ALGORITHM": "GCNDIST", "PARTITIONS": "4", "OPTIM_KERNEL": "1"}, "dist", 0),
    ({"ALGORITHM": "GCNDIST", "PARTITIONS": "4", "OPTIM_KERNEL": "1", "PALLAS": "1"},
     "dist", 0),
    ({"ALGORITHM": "GCNEAGERDIST", "PARTITIONS": "2", "COMM_LAYER": "ring"}, "dist", 0),
    ({"ALGORITHM": "GATDIST", "PARTITIONS": "4"}, "dist", 0),
    ({"ALGORITHM": "GGCNDIST", "PARTITIONS": "2"}, "dist", 0),
    ({"ALGORITHM": "GCNDIST", "PARTITIONS": "4", "MESH": "2,2"}, None, 2),
])
def test_aot_check_cli_cases(tmp_path, capsys, monkeypatch, over, case, rc):
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")
    cfg = _cora_cfg_file(tmp_path, over)
    assert aot_check.main([cfg]) == rc
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if case is None:
        assert "not modelled" in out["refused"]
        return
    assert out["case"] == case and out["fits"] and out["peak_bytes"] > out["static_bytes"] > 0
    if case == "dist":
        p = int(over["PARTITIONS"])
        assert out["partitions"] == p and out["vp"] % 8 == 0 and out["transient"] > 0
        assert out["rank"] == int(np.argmax(out["rank_in_edges"])) and len(
            out["rank_in_edges"]) == p
        assert out["peak_bytes"] == (out["static_bytes"] + out["kernel_cache"]
                                     + out["transient"] + aot_check.LIBRARY_WORKSPACE)
        if over.get("OPTIM_KERNEL"):
            assert out["kernel_cache"] > 0 and out["checks"]


_GLOO_RANK = """
import json, os, sys
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.tools import aot_check
from neutronstarlite_torch.utils.config import InputInfo

mesh.maybe_init_process_group("cpu")
cfg = InputInfo.read_from_cfg_file(sys.argv[1])
tr = aot_check.build_trainer(cfg, os.path.dirname(sys.argv[1]))
geo = aot_check.kernel_geometry()
static, cache, transient, checks, route = aot_check.rank_bytes(tr, geo, 232448)
with open(sys.argv[2] + "." + os.environ["RANK"], "w") as fh:
    json.dump({"static": static, "kernel_cache": cache, "transient": transient,
               "route": route}, fh)
"""


@pytest.mark.parametrize("over", [
    {"OPTIM_KERNEL": "1"}, {"OPTIM_KERNEL": "1", "PALLAS": "1"}, {"COMM_LAYER": "ring"},
    {"ALGORITHM": "GATDIST"},
], ids=["ell", "bsp", "ring", "gat_mirror"])
def test_aot_check_dry_rank_is_a_real_gloo_rank(tmp_path, capsys, over):
    """Two real ranks over gloo count their own bytes with the tool's
    counter (the kernels stood in, the collectives real); the dry rank
    that aot_check builds alone gives the same static bytes, kernel caches
    and transient."""
    import socket
    import subprocess

    cfg = _cora_cfg_file(tmp_path, {"ALGORITHM": "GCNDIST", "PARTITIONS": "2", **over})
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out = str(tmp_path / "rank")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("NTS_DIST_SIMULATE", None)
        procs.append(subprocess.Popen([sys.executable, "-c", _GLOO_RANK, cfg, out], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    assert aot_check.main([cfg]) == 0
    dry = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(f"{out}.{dry['rank']}") as fh:
        real = json.load(fh)
    assert dry["static"] == real["static"] and dry["kernel_cache"] == real["kernel_cache"]
    assert dry["route"] == real["route"] and dry["transient"] == real["transient"]


# ---- aot_bsp_scale ------------------------------------------------------------------

def test_generator_layout_without_the_edges():
    v, e = 1500, 40000
    src, dst = synthetic_power_law_graph(v, e, seed=aot_bsp_scale.SEED)
    perm, deg = aot_bsp_scale.generator_layout(v, e, exact_degrees=True)
    np.testing.assert_array_equal(deg.astype(np.int64), np.bincount(dst, minlength=v))
    rng = np.random.default_rng(aot_bsp_scale.SEED)
    n = e - v
    rng.random(n), rng.random(n)
    np.testing.assert_array_equal(perm, rng.permutation(v))
    _, expected = aot_bsp_scale.generator_layout(v, e)
    assert expected.sum() == pytest.approx(e)


@pytest.mark.parametrize("v,e", [(5000, 500000), (9000, 2000000)])
def test_block_estimate_against_a_real_build(v, e):
    """The estimate for the bench graph within 6 % of the tables a build
    makes; the bound holds."""
    perm, deg = aot_bsp_scale.generator_layout(v, e)
    est = aot_bsp_scale.estimate_blocks(v, e, 512, 8192, 8, 128, deg, perm)
    src, dst = synthetic_power_law_graph(v, e, seed=aot_bsp_scale.SEED)
    g = build_graph(src, dst, v)
    t = BspEll.build(v, g.column_offset, g.row_indices, g.edge_weight_forward)
    real = int(t.tile_ptr[-1])
    assert abs(est["data_blocks"] - real) <= 0.06 * real
    assert aot_bsp_scale.geometry(v, e, 602)["blocks_bound"] >= t.nbr.shape[0]


def test_aot_bsp_scale_at_10x_without_a_card(capsys):
    assert aot_bsp_scale.main(["--scale", "10", "--f", "602"]) == 0
    out = json.loads(capsys.readouterr().out)
    geo = out["geometry"]
    assert out["v_num"] == 2329650 and out["ok"] and "launch" not in out
    assert 3_000_000 < geo["blocks"] <= geo["blocks_bound"]
    for name in ("n_pieces", "grid_ctas", "blk_key_max", "n_src", "src_base_max"):
        assert geo["ints"][name]["ok"] and geo["ints"][name]["headroom"] > 0
    assert geo["slots_vs_2_31"]["value"] == geo["blocks"] * 8 * 128
    assert "64 bits" in geo["slots_vs_2_31"]["note"]
    assert geo["device_bytes"]["x_bf16"] == 2329650 * 602 * 2
    assert geo["fits"] == (geo["device_bytes_total"] <= out["memory_bytes"])


def test_aot_bsp_scale_dist_takes_the_exact_vp(capsys):
    from neutronstarlite_torch.graph.storage import partition_offsets
    from neutronstarlite_torch.parallel.vertex_space import round_up

    assert aot_bsp_scale.main(["--scale", "0.02", "--dist", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    v, e = out["v_num"], out["e_num"]
    _, dst = synthetic_power_law_graph(v, e, seed=aot_bsp_scale.SEED)
    offs = partition_offsets(v, np.bincount(dst, minlength=v), 4)
    assert out["vp"] == round_up(int(np.diff(offs).max()), 8)
    assert out["geometry"]["ints"]["n_src"]["value"] == 4 * out["vp"]


# ---- aot_bench_path ------------------------------------------------------------------

@pytest.mark.parametrize("order,path", [("eager", "bsp"), ("standard", "ell"),
                                        ("standard", "scatter")])
def test_aot_bench_path_tiny(tmp_path, monkeypatch, order, path):
    monkeypatch.setenv("NTS_BENCH_CACHE", str(tmp_path))
    out = aot_bench_path.report(order, path, 0.002)
    assert out["fits"] and out["refused"] == [] and out["build_s"] > 0
    assert out["static"]["tables"] > 0 and out["peak_bytes"] > out["static_bytes"]
    assert out["route"] == {"bsp": "BspEllPair", "ell": "EllPair",
                            "scatter": "ScatterGraph"}[path]


# ---- tpu_plan (JAX's Plan mechanics) ---------------------------------------------------

def _mk(tmp_path):
    return Plan(str(tmp_path), probe_timeout_s=5.0, step_retries=1)


def test_step_ok_writes_marker_and_salvages_json(tmp_path):
    plan = _mk(tmp_path)
    cmd = [sys.executable, "-c", "print('noise'); print('{\"epoch_s\": 1.5}')"]
    assert plan.run_step("s1", cmd, timeout_s=30, env_over={})
    assert os.path.exists(tmp_path / "s1.ok")
    with open(tmp_path / "s1.json") as fh:
        assert json.load(fh) == {"epoch_s": 1.5}
    steps = [("s1", cmd, 30, {}), ("s2", cmd, 30, {})]
    assert [s[0] for s in plan.pending(steps)] == ["s2"]


def test_step_failure_with_the_card_gone_stays_pending(tmp_path):
    plan = _mk(tmp_path)
    plan.probe = lambda: None
    cmd = [sys.executable, "-c", "raise SystemExit(1)"]
    assert not plan.run_step("s1", cmd, timeout_s=30, env_over={})
    assert not os.path.exists(tmp_path / "s1.ok")
    assert not os.path.exists(tmp_path / "s1.failed")
    assert [s[0] for s in plan.pending([("s1", cmd, 30, {})])] == ["s1"]


def test_step_failure_with_the_card_up_retries_then_fails(tmp_path):
    plan = _mk(tmp_path)
    plan.probe = lambda: {"ok": True}
    cmd = [sys.executable, "-c", "import sys; print('{\"partial\": 2}'); sys.exit(1)"]
    assert plan.run_step("s1", cmd, timeout_s=30, env_over={})
    assert not os.path.exists(tmp_path / "s1.failed")
    assert [s[0] for s in plan.pending([("s1", cmd, 30, {})])] == ["s1"]
    assert plan.run_step("s1", cmd, timeout_s=30, env_over={})
    assert os.path.exists(tmp_path / "s1.failed")
    assert plan.pending([("s1", cmd, 30, {})]) == []
    with open(tmp_path / "s1.json") as fh:
        assert json.load(fh) == {"partial": 2}


def test_timed_out_step_still_salvages_json(tmp_path):
    plan = _mk(tmp_path)
    plan.probe = lambda: {"ok": True}
    cmd = [sys.executable, "-u", "-c",
           "import time; print('{\"epoch_s\": 3.25}', flush=True); time.sleep(600)"]
    plan.run_step("s1", cmd, timeout_s=10, env_over={})
    with open(tmp_path / "s1.json") as fh:
        assert json.load(fh) == {"epoch_s": 3.25}
    assert not os.path.exists(tmp_path / "s1.ok")
    with open(tmp_path / "s1.log") as fh:
        assert "STEP TIMEOUT" in fh.read()


def test_env_override_reaches_step(tmp_path):
    plan = _mk(tmp_path)
    cmd = [sys.executable, "-c", "import os, json; print(json.dumps({'v': os.environ['NTS_X']}))"]
    assert plan.run_step("s1", cmd, timeout_s=30, env_over={"NTS_X": "7"})
    with open(tmp_path / "s1.json") as fh:
        assert json.load(fh)["v"] == "7"


def test_probe_without_a_card_is_none(tmp_path):
    assert _mk(tmp_path).probe() is None  # this machine has no card


def test_build_steps_shape_list_and_only(tmp_path, capsys):
    steps = build_steps(str(tmp_path))
    names = [s[0] for s in steps]
    assert names[0] == "micro_bench" and len(names) == len(set(names))
    assert {"bench_sample", "sample_bench", "bench_matrix", "aot_bsp_scale"} <= set(names)
    assert {f"epoch_{o}_{p}" for o in rf.ORDERS for p in rf.PATHS} <= set(names)
    assert names[-1] == "roofline" and str(tmp_path) in steps[-1][1]
    scaled = {s[0]: s[1] for s in build_steps(str(tmp_path), 0.1)}
    for name in ("bench_sample", "epoch_standard_ell", "roofline"):
        assert scaled[name][scaled[name].index("--scale") + 1] == "0.1"
    assert not any("bench.py" in " ".join(s[1]) for s in steps)
    assert tpu_plan.main(["--out", str(tmp_path), "--list"]) == 0
    assert capsys.readouterr().out.count("timeout=") == len(steps)
    assert tpu_plan.main(["--out", str(tmp_path), "--only", "nope", "--list"]) == 2


def test_plan_runs_one_step_and_leaves_its_marker(tmp_path, monkeypatch):
    """The loop with the probe stubbed up: one step to its ``.ok``."""
    monkeypatch.setattr(tpu_plan, "build_steps", lambda out, scale: [
        ("one", [sys.executable, "-c", "print('{\"v\": 1}')"], 60, {})])
    monkeypatch.setattr(Plan, "probe", lambda self: {"ok": True, "name": "stub"})
    assert tpu_plan.main(["--out", str(tmp_path), "--max-wall-s", "60"]) == 0
    assert os.path.exists(tmp_path / "one.ok")
    with open(tmp_path / "status") as fh:
        assert "plan COMPLETE" in fh.read()
