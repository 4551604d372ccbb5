#!/usr/bin/env python3
"""Drive the torch port (neutronstarlite_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 0.1] [--epochs 5] [--seed 0]

Phases (each prints its lines; any failure exits non-zero):

1. device: the card's name, and name + power limit from nvidia-smi;
2. build: both CUDA kernels from neutronstarlite_torch/csrc with nvcc;
3. kernel checks: each kernel, f32 and bf16, forward and backward through
   its autograd.Function, against its plain PyTorch version on the card, on
   a synthetic power-law graph with a hub row (split-K) and a bsp dst tile
   that runs in several pieces, f in {41, 128, 602};
4. main path: GCN 602-128-41 (the widths of configs/gcn_reddit_full.cfg,
   PRECISION:bfloat16) on a synthetic power-law graph at --scale of Reddit
   (0.1: V=23,296, E=11,461,589), built through from_arrays and trained by
   the trainer: one epoch on the plain scatter route, --epochs on the bsp
   route (OPTIM_KERNEL:1 PALLAS:1) and on the ELL route (the same with
   NTS_PALLAS_RESIDENT=1), all from the same seeded parameters with
   drop_rate 0. Each kernel route's first forward's logits are held
   against the plain route's, and its first-epoch loss too (a disagreement
   there is printed at once and fails the run after phase 6, so that a
   failing run still prints its numbers); each kernel route's launch count
   is read from that run;
5. the Cora fixture through the CLI entry point (run.main) on the card
   with OPTIM_KERNEL:1 PALLAS:1;
6. main-path checks and timing: on the trainers' own tables, for every
   (tables, width) pair one training epoch runs (forward at 602 and 128,
   backward at 128), each kernel against its plain version (bf16), then
   the CUDA-event times of the kernel, the plain version and one
   torch.sparse.mm call on the same inputs, beside the bound; and the bsp
   launch geometry of each pair (pieces, the heaviest piece's blocks, CTAs,
   shared bytes per CTA, CTAs per SM from the CUDA occupancy API).

The bound of one aggregation is the same for both kernels, taken from the
graph: the bytes it must move (E int32 indices and f32 weights, V+1 int32
offsets, x read once and the output written once) over 3.35 TB/s, or its
2*E*f float32 operations over 67 TFLOP/s, whichever is larger. In the
{"kernels": [...]} line, ms, plain_ms, library_ms and bound_ms are those of
one training epoch's aggregation calls: the sums over the pairs above.

Tolerances scale with the reference: atol is a fraction of the reference's
root mean square, so a wrong kernel cannot hide under a fixed atol when the
outputs are small.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing either.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# (atol as a fraction of the reference's RMS, rtol)
F32_TOL = (4e-5, 1e-4)  # summation order differs
BF16_TOL = (2.0 ** -7, 2.0 ** -7)  # one bf16 ulp of rounding either way
LOGITS_TOL = (2.0 ** -4, 2.0 ** -4)  # bf16 GCN logits after two bf16 layers
LOSS_RTOL = 1e-3  # first-epoch loss, bf16 kernel route vs plain route


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check_close(name, got, want, tol) -> float:
    """Max abs error of got against want; raises where an element is off
    by more than tol[0] * rms(want) + tol[1] * |want|."""
    import torch

    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    if not want.numel():
        return 0.0
    rms = float(want.pow(2).mean().sqrt())
    err = (got - want).abs()
    bad = err > tol[0] * rms + tol[1] * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max abs err "
            f"{float(err.max()):.3e}, reference rms {rms:.3e}"
        )
    return float(err.max())


def epoch_calls(sizes):
    """(tables, width) of each aggregation one training epoch runs in the
    standard order: every layer's forward at its input width, and the
    backward of every layer but the first (the features need no gradient)."""
    return [("fwd", s) for s in sizes[:-1]] + [("bwd", s) for s in sizes[1:-1]]


def bound_ms(g, f: int, elem_bytes: int):
    """(bytes ms, operations ms) of one aggregation over g at width f: the
    bytes it must move (E int32 indices + f32 weights, V+1 int32 offsets,
    x read once, the output written once) over the memory rate, and its
    2*E*f float32 operations over the f32 rate. Padding is a cost of a
    layout, so it is not counted."""
    moved = g.e_num * 8 + (g.v_num + 1) * 4 + 2 * g.v_num * f * elem_bytes
    return moved / HBM_BYTES_PER_S * 1e3, 2.0 * g.e_num * f / F32_FLOPS * 1e3


def bsp_geometry(tables, f: int, dtype) -> dict:
    """The bsp kernel's launch at width f over these tables: its pieces,
    the heaviest piece's blocks, the tiles split into several pieces, the
    CTAs, and the kernel instance's occupancy."""
    import numpy as np

    from neutronstarlite_torch.ops import _build
    from neutronstarlite_torch.ops.bsp_ell import occupancy

    ptr = tables.pieces(f).cpu().numpy()
    tile_ptr = tables.tile_ptr.cpu().numpy()
    sizes = np.diff(ptr)
    per_tile = np.bincount(np.searchsorted(tile_ptr, ptr[:-1], side="right") - 1)
    chunks = -(-f // _build.kernel_cols("bsp_ell"))
    return {
        "pieces": len(sizes), "heaviest_blocks": int(sizes.max(initial=0)),
        "data_blocks": int(tile_ptr[-1]), "tiles": len(tile_ptr) - 1,
        "split_tiles": int((per_tile > 1).sum()), "ctas": chunks * len(sizes),
        **occupancy(dtype, f),
    }


def bsp_geometry_text(g: dict) -> str:
    return (f"{g['pieces']} pieces of its {g['data_blocks']} data blocks in {g['tiles']} "
            f"dst tiles ({g['split_tiles']} split), heaviest piece {g['heaviest_blocks']} "
            f"blocks, {g['ctas']} CTAs, {g['smem_bytes']} shared bytes per CTA, "
            f"{g['ctas_per_sm']} CTAs per SM (CUDA occupancy API; {g['regs']} registers, "
            f"{g['local_bytes']} spill bytes per thread)")


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel_checks(dev, seed: int) -> dict:
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
    from neutronstarlite_torch.ops import _build
    from neutronstarlite_torch.ops.bsp_ell import BspAggregate, BspEllPair, bsp_tables_aggregate
    from neutronstarlite_torch.ops.ell import EllPair
    from neutronstarlite_torch.ops.ell_kernel import EllAggregate, split_count

    v, e = 30000, 600000
    g = build_graph(*synthetic_power_law_graph(v, e, seed=seed + 7), v)
    ell = EllPair.from_host(g, device=dev)
    bsp = BspEllPair.from_host(g, device=dev)
    top = ell.fwd.nbr[-1].shape
    splits = split_count(top[0], top[1], 602, _build.kernel_cols("ell_level"))
    log(f"check graph V={v} E={g.e_num} max in-degree {int(g.in_degree.max())}, "
        f"top ELL level {tuple(top)} in {splits} K splits at f=602")
    if top[1] <= 2048:
        raise AssertionError("the check graph has no hub level to split")
    for f in (41, 128, 602):
        for direction in ("fwd", "bwd"):
            geo = bsp_geometry(getattr(bsp, direction), f, torch.float32)
            if geo["split_tiles"] <= 0:
                raise AssertionError(f"the check graph's bsp {direction} tables split "
                                     f"no dst tile at f={f}")
            log(f"check graph bsp {direction} tables at f={f}: {bsp_geometry_text(geo)}")
    rng = np.random.default_rng(seed)
    worst = {}
    cases = {
        "ell_level": (EllAggregate.apply, ell, lambda t, x: t.plain(x)),
        "bsp_ell": (BspAggregate.apply, bsp, bsp_tables_aggregate),
    }
    for f in (41, 128, 602):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x0 = torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32))
            c0 = torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32))
            for name, (fn, pair, plain) in cases.items():
                x = x0.to(dev, dtype).requires_grad_(True)
                c = c0.to(dev, dtype)
                out = fn(x, pair.fwd, pair.bwd)
                out.backward(c)
                torch.cuda.synchronize()
                e_f = check_close(f"{name} fwd f={f} {dtype}", out,
                                  plain(pair.fwd, x.detach()), tol)
                e_b = check_close(f"{name} bwd f={f} {dtype}", x.grad,
                                  plain(pair.bwd, c), tol)
                log(f"check {name:9s} f={f:3d} {str(dtype):14s} max abs err "
                    f"fwd {e_f:.3e} bwd {e_b:.3e}")
                worst[name] = max(worst.get(name, 0.0), e_f, e_b)
    del ell, bsp
    torch.cuda.empty_cache()
    return worst


def phase_main_path(dev, scale: float, epochs: int, seed: int):
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import reddit_scaled, synthetic_power_law_graph
    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.utils.config import InputInfo

    v, e = reddit_scaled(scale)
    t0 = time.perf_counter()
    src, dst = synthetic_power_law_graph(v, e, seed=seed)
    g = build_graph(src, dst, v)
    rng = np.random.default_rng(seed)
    datum = GNNDatum(
        feature=rng.standard_normal((v, 602), dtype=np.float32) * 0.1,
        label=rng.integers(0, 41, size=v, dtype=np.int32),
        mask=(np.arange(v) % 3).astype(np.int32),
    )
    log(f"main path graph V={v} E={g.e_num} max in-degree {int(g.in_degree.max())}: "
        f"host generate+CSC/CSR build {time.perf_counter() - t0:.1f} s")

    def trainer(route: str, n_epochs: int):
        cfg = InputInfo(
            algorithm="GCN", vertices=v, layer_string="602-128-41", epochs=n_epochs,
            drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
            weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
            optim_kernel=route != "plain", pallas_kernel=route != "plain",
        )
        os.environ["NTS_PALLAS_RESIDENT"] = "1" if route == "ell" else "0"
        return GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                      host_graph=g)

    results = {}
    plain = trainer("plain", 1)
    plain_logits = plain.eval_logits()  # drop_rate 0: the first forward's logits
    plain.run()
    results["plain"] = {"losses": list(plain.loss_history)}
    log(f"route plain: epoch-0 loss {plain.loss_history[0]:.6f} "
        f"({plain.epoch_times[0]:.3f} s)")
    del plain
    counters = {"bsp": bsp_aggregate, "ell": ell_level_aggregate}
    # a route that disagrees with the plain route fails the run at its end,
    # after the later phases have run and printed their numbers
    failures = results["failures"] = []

    def defer(msg):
        failures.append(msg)
        log(f"FAILED {msg} (the later phases still run; the script fails at the end)")

    for route in ("bsp", "ell"):
        tr = trainer(route, epochs)
        try:
            logits_err = check_close(f"route {route} first logits", tr.eval_logits(),
                                     plain_logits, LOGITS_TOL)
        except AssertionError as exc:
            defer(str(exc))
            logits_err = float("nan")
        rms = float(plain_logits.pow(2).mean().sqrt())
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        tr.run()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        for c in counters.values():
            c.launches = 0
        tr.train_step()
        torch.cuda.synchronize()
        per_epoch = counters[route].launches
        losses = tr.loss_history
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"route {route}: non-finite loss {losses}")
        ref = results["plain"]["losses"][0]
        if abs(losses[0] - ref) > LOSS_RTOL * abs(ref):
            defer(f"route {route}: epoch-0 loss {losses[0]} vs plain {ref}")
        if launches[route] <= 0:
            raise AssertionError(f"route {route}: its kernel was never launched")
        other = "ell" if route == "bsp" else "bsp"
        if launches[other]:
            raise AssertionError(f"route {route} launched the {other} kernel")
        results[route] = {
            "trainer": tr, "losses": losses, "launches": launches[route],
            "launches_per_epoch": per_epoch, "epoch_times": list(tr.epoch_times),
            "build_s": tr.phase_times.get("build_model", 0.0),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        }
        log(f"route {route}: first logits max abs err {logits_err:.3e} against the "
            f"plain route's (their rms {rms:.3e}); epoch-0 loss {losses[0]:.6f} vs "
            f"plain {ref:.6f} (rel {abs(losses[0] - ref) / abs(ref):.2e})")
        log(f"route {route}: losses {[round(x, 6) for x in losses]}; "
            f"{launches[route]} launches in {epochs} epochs + eval, "
            f"{per_epoch} per training epoch; epochs (s) "
            f"{[round(t, 4) for t in tr.epoch_times]}, {epochs}-epoch wall "
            f"{sum(tr.epoch_times):.3f} s; host table build "
            f"{results[route]['build_s']:.1f} s; peak device memory "
            f"{results[route]['peak_gib']:.2f} GiB")
    return g, results


def phase_cora_cli(dev) -> None:
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate

    fix = os.path.join(REPO, "tests", "fixtures", "cora")
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    logging.getLogger("nts_torch").addHandler(grab)
    bsp_aggregate.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = os.path.join(tmp, "cora_bsp.cfg")
            with open(cfg, "w") as fh:
                fh.write(
                    "ALGORITHM:GCNCPU\nVERTICES:2708\nLAYERS:1433-16-7\nEPOCHS:5\n"
                    f"EDGE_FILE:{fix}/cora.2708.edge.self\n"
                    f"LABEL_FILE:{fix}/cora.labeltable\nMASK_FILE:{fix}/cora.mask\n"
                    "LEARN_RATE:0.01\nWEIGHT_DECAY:0.0001\nDECAY_EPOCH:-1\n"
                    "DROP_RATE:0.5\nOPTIM_KERNEL:1\nPALLAS:1\n"
                )
            os.environ["NTS_PALLAS_RESIDENT"] = "0"
            rc = run.main([cfg, "--device", dev.type])
    finally:
        logging.getLogger("nts_torch").removeHandler(grab)
    torch.cuda.synchronize()
    acc = [ln for ln in lines if ln.startswith("Train Acc:")]
    if rc != 0 or not acc or bsp_aggregate.launches <= 0:
        raise AssertionError(f"Cora CLI run: rc {rc}, {len(acc)} Train Acc lines, "
                             f"{bsp_aggregate.launches} bsp launches")
    log(f"Cora CLI on {dev}: rc 0, {acc[-1]}, {bsp_aggregate.launches} bsp launches")


def phase_timing(dev, g, results, check_errs: dict, seed: int):
    import numpy as np
    import torch

    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate, bsp_tables_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    v = g.v_num
    calls = epoch_calls(results["bsp"]["trainer"].cfg.layer_sizes())
    rng = np.random.default_rng(seed + 3)
    xs = {f: torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32)).to(
        dev, torch.bfloat16) for f in sorted({f for _, f in calls})}
    csr = {
        "fwd": (g.column_offset, g.row_indices, g.edge_weight_forward),
        "bwd": (g.row_offset, g.column_indices, g.edge_weight_backward),
    }
    library = {}  # (tables, f) -> (ms, output) of one torch.sparse.mm
    for direction in sorted({d for d, _ in calls}):
        ptr, idx, w = csr[direction]
        a = torch.sparse_csr_tensor(
            torch.from_numpy(ptr).to(dev), torch.from_numpy(idx.astype(np.int64)).to(dev),
            torch.from_numpy(w).to(dev, torch.bfloat16), size=(v, v),
        )
        for d, f in calls:
            if d == direction:
                library[(d, f)] = (cuda_ms(lambda: torch.sparse.mm(a, xs[f])),
                                   torch.sparse.mm(a, xs[f]))
        del a
    specs = {
        "ell_level": ("ell", ell_level_aggregate,
                      lambda t, y: t.plain(y),
                      "neutronstarlite_torch/csrc/ell_level.cu",
                      "neutronstarlite_tpu/ops/pallas_kernels.py:91"),
        "bsp_ell": ("bsp", bsp_aggregate, bsp_tables_aggregate,
                    "neutronstarlite_torch/csrc/bsp_ell.cu",
                    "neutronstarlite_tpu/ops/bsp_ell.py:503"),
    }
    rows = []
    for name, (route, wrapper, plain, source, replaces) in specs.items():
        pair = results[route]["trainer"].compute_graph
        err = check_errs[name]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0}
        for direction, f in calls:
            tables, x = getattr(pair, direction), xs[f]
            got = wrapper(tables, x)
            e = check_close(f"{name} main path {direction} f={f}", got,
                            plain(tables, x), BF16_TOL)
            err = max(err, e)
            ms = cuda_ms(lambda: wrapper(tables, x))
            plain_ms = cuda_ms(lambda: plain(tables, x), n=3, warmup=1)
            lib_ms, lib_out = library[(direction, f)]
            lib_dev = float((got.float() - lib_out.float()).abs().max())
            t_bytes, t_ops = bound_ms(g, f, x.element_size())
            for k, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", max(t_bytes, t_ops)), ("bytes_ms", t_bytes),
                           ("ops_ms", t_ops)):
                tot[k] += val
            if name == "bsp_ell":
                log(f"main path bsp_ell {direction} f={f} bf16 launch: "
                    f"{bsp_geometry_text(bsp_geometry(tables, f, x.dtype))}")
            log(f"main path {name} {direction} tables V={v} E={g.e_num} f={f} bf16 "
                f"({tables.slot_count()} table slots): max abs err {e:.3e} against "
                f"the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.sparse.mm {lib_ms:.4f} ms (max abs deviation from the kernel "
                f"{lib_dev:.3e}: its bf16 sums), bound {max(t_bytes, t_ops):.4f} ms "
                f"(bytes {t_bytes:.4f}, f32 ops {t_ops:.4f})")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results[route]["launches"], "max_abs_err": err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
        log(f"timing {name}, one epoch's {len(calls)} aggregations {calls}: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, torch.sparse.mm "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (bytes "
            f"{tot['bytes_ms']:.4f}, f32 ops {tot['ops_ms']:.4f}); launches per "
            f"epoch {results[route]['launches_per_epoch']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1, help="fraction of Reddit's V and E")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from neutronstarlite_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    build_s = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    log(f"built {', '.join(_build.KERNELS)} for sm_90a in {build_s:.1f} s")

    check_errs = phase_kernel_checks(dev, args.seed)
    g, results = phase_main_path(dev, args.scale, args.epochs, args.seed)
    phase_cora_cli(dev)
    rows = phase_timing(dev, g, results, check_errs, args.seed)
    if results["failures"]:
        for msg in results["failures"]:
            log(f"FAILED {msg}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
