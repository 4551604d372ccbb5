"""Readings for the limits of ``correct`` (``check.py``), at a cell's own size.

    python3 h100bench/calibrate.py --workload <cell> --seeds 11,12,13

For each seed, in one process: the program's checked steps against the
reference (the lower readings), then the reference put in the program's
place in the configuration's control precision (``control`` in the
configuration: ``fp8`` for a bfloat16 program, ``tf32`` for a float32
one) and with each fault planted: ``frozen`` (the update skipped, the
state returned unchanged), ``half_batch`` (the loss and its gradient over
half of the training vertices, the mean taken over them) and
``stale_loss`` (each step reports the previous step's loss, the first
0). Each reading is printed as one JSON line; nothing here is part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from h100bench import check, inputs, program, run  # noqa: E402
from h100bench.reference import common, drive  # noqa: E402


def half_batch_loss(logits, label, train01):
    """The masked loss over the first half of the training vertices."""
    import torch

    ids = torch.nonzero(train01 > 0)[:, 0]
    half = torch.zeros_like(train01)
    half[ids[: ids.numel() // 2]] = 1.0
    return common.masked_nll(logits, label, half)


def frozen(r: common.Readings) -> common.Readings:
    return common.Readings(losses=r.losses, logits=r.logits, grads=r.grads, p0=r.p0,
                           p_end=[p.clone() for p in r.p0])


def stale(r: common.Readings) -> common.Readings:
    return common.Readings(losses=[0.0] + r.losses[:-1], logits=r.logits, grads=r.grads,
                           p0=r.p0, p_end=r.p_end)


def readings(name: str, seed: int, device):
    import torch

    _, cell, cfg, traffic = run.load_cell(name, run.BENCH)
    steps = int(traffic["checked_steps"])
    inp = inputs.make_inputs(cfg, seed, device)
    out = {"seed": seed}
    t0 = time.perf_counter()
    trainer = program.build(cfg, inp, seed, device, {})
    prog = program.checked_steps(trainer, steps, float(cfg["adam"]["beta1"]))
    out["program_s"] = time.perf_counter() - t0
    del trainer
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = drive.run(cfg, inp, seed, steps, device)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = check.numbers(prog, ref)
    ctl = drive.run(cfg, inp, seed, steps, device, mode=cfg["control"])
    out["control"] = check.numbers(ctl, ref)
    out["frozen"] = check.numbers(frozen(ref), ref)
    out["stale_loss"] = check.numbers(stale(ref), ref)
    half = drive.run(cfg, inp, seed, steps, device, loss_fn=half_batch_loss)
    out["half_batch"] = check.numbers(half, ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args()
    for s in args.seeds.split(","):
        rec = readings(args.workload, int(s), "cuda:0")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
