"""Whole runs at a tiny size on the CPU: the harness's look for a chip is
skipped and the rest of a run is driven, once sound and once with each
fault a one-chip training cell can have planted in the timed path; and the
harness's refusals. The control's test needs the card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from h100bench import calibrate, check, run
from h100bench.reference import drive

BENCH = os.path.join(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in json.load(open(BENCH))["workloads"] if w["chips"] == 1]
TINY = {"vertices": 300, "edges": 6000}
SEED = 2 ** 31 + 99


def tiny_run(cell, seconds=0.3, trace=False):
    return run.run_cell(cell, SEED, seconds, trace, "cpu", BENCH, time.perf_counter(), TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_agrees_with_the_reference(cell):
    # the limits are set at the cell's own size (PERF.md); at this size a
    # sound run reads within 1e-2 of the reference on every number
    out = tiny_run(cell, trace=True)
    assert list(out)[-1] == "check"
    assert all(v["value"] < 1e-2 for v in out["check"].values()), out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"mfu", "dispatch_ms", "graph_build_s", "model_build_s"} <= set(out["metrics"])
    out = tiny_run(cell)
    assert set(out["metrics"]) == {"setup_s", "epoch_ms", "peak_mem_gib"}


def _frozen(monkeypatch):
    from neutronstarlite_torch.models import fullbatch

    monkeypatch.setattr(fullbatch, "adam_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from neutronstarlite_torch.models.base import ToolkitBase

    monkeypatch.setattr(ToolkitBase, "masked_nll_loss",
                        staticmethod(calibrate.half_batch_loss))


def _stale_loss(monkeypatch):
    from neutronstarlite_torch.models.fullbatch import FullBatchTrainer

    step = FullBatchTrainer.train_step
    last = {}

    def stale(self):
        loss, logits = step(self)
        prev = last.get(id(self), torch.zeros_like(loss))
        last[id(self)] = loss
        return prev, logits

    monkeypatch.setattr(FullBatchTrainer, "train_step", stale)


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _stale_loss])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert tiny_run(cell)["correct"] is False


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    # the sandbox has no card: the run exits non-zero and prints no result
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # only BENCHMARK.json and the benchmark's folder
            shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
            shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                            ignore=shutil.ignore_patterns(".cache", "__pycache__"))
        p = subprocess.run([sys.executable, "h100bench/run.py", "--workload", CELLS[0],
                            "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                           cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and '"correct"' not in p.stdout


def test_forbidden_module_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "neutronstarlite_tpu.models", object())
    assert run.forbidden_modules() == ["neutronstarlite_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda_device):
    """The reference in the precision below the configuration's (fp8 under
    bfloat16, TF32 under float32), put in the program's place, fails the
    cell's limits."""
    _, spec, cfg, traffic = run.load_cell(cell, BENCH)
    cfg = dict(cfg, vertices=20000, edges=2000000)
    from h100bench import inputs

    inp = inputs.make_inputs(cfg, SEED, cuda_device)
    steps = traffic["checked_steps"]
    ref = drive.run(cfg, inp, SEED, steps, cuda_device)
    ctl = drive.run(cfg, inp, SEED, steps, cuda_device, mode=cfg["control"])
    assert not check.judge(check.numbers(ctl, ref), spec["limits"])
