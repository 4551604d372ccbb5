"""BENCHMARK.json against the contract, and the files it names."""

import ast
import json
import os
import re

import pytest

from h100bench import check

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
HERE = os.path.join(ROOT, "h100bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "neutronstarlite_tpu"}
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert BENCH["paths"] == ["h100bench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and (kind in ("configs", "workloads") or key == "layer"):
                assert text_ok(e[key]), (e["name"], key)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_files_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(HERE, "reference", f"{cfg['family']}.py"))
        assert os.path.exists(os.path.join(HERE, "counts", f"{cfg['family']}.py"))
    for name, w in CELLS.items():
        cell = json.load(open(os.path.join(HERE, "workloads", f"{name}.json")))
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert os.path.exists(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        assert set(cell["limits"]) <= set(check.NAMES)
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]


def test_every_config_is_used_and_cells_report_enough():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in CELLS.values()}
    assert len({(w["config"], w["traffic"]) for w in CELLS.values()}) == len(CELLS)
    for name in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(name in m.get("workloads", CELLS) for m in BENCH["per_layer"])


def test_moves_is_reported_by_each_cell_of_the_metric():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        target = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in target.get("workloads", CELLS)


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"`{layer}`" in perf, f"PERF.md's layer list lacks {layer!r}"


def test_four_chip_cells_and_budget():
    fours = [w for w in CELLS.values() if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in CELLS.values())
    assert len(fours) <= max(1, len(CELLS) // 4)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(HERE, "reference")):
        if f.endswith(".py"):
            assert "neutronstarlite_torch" not in set(
                _imports(os.path.join(HERE, "reference", f))), f
