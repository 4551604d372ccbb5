"""Sampling-pipeline benchmark: steady-state batches/sec per sampling mode.

Port of ``neutronstarlite_tpu/tools/sample_bench.py``. ``bench_sample``
times the sampled path's batches serially; this tool runs the trainer's own
epoch loop (``GCNSampleTrainer.run``) in each ``SAMPLE_PIPELINE`` mode of
``--modes`` (``sync``, ``pipelined``, ``device``, ``fused``) over ONE
shared host graph (``tools/bench_graph.py``), and reports the steady-state
batches/sec of each with the telemetry that explains the difference: the
sync path's serial sample time, the pipelined path's residual
``sample.stall_ms``, the fused path's dispatches (one CUDA-graph replay
per batch) and ``sample.h2d_bytes`` (0 when fused). Sync and pipelined
draw the same batches, so their loss curves are held bitwise
(``sync_pipelined_loss_parity``); fused draws on the device, so it reports
its largest per-epoch loss gap to sync instead.

With ``NTS_LEDGER_DIR`` set, each mode writes one kind=run ledger row (cfg
key ``sample_bench/<mode>/B<batch>/<fanout>/s<scale>``), which
``tools/perf_sentinel`` trend-gates per mode.

Usage: python -m neutronstarlite_torch.tools.sample_bench [--scale S]
         [--batch-size 512] [--fanout 25-10] [--epochs 3]
         [--modes sync,pipelined,fused] [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises. Prints ONE JSON line:
  {"metric": "sample_pipeline_batches_per_sec", "value": <head mode's bps>,
   "extra": {per-mode epoch times, stall/sample ms, loss parity}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

MODES = ("sync", "pipelined", "device", "fused")


def measure_mode(mode, cfg_proto, src, dst, datum, host_graph, device):
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
    from neutronstarlite_torch.obs.hist import LogHistogram

    cfg = dataclasses.replace(cfg_proto, sample_pipeline="" if mode == "sync" else mode)
    t0 = time.time()
    tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, host_graph=host_graph,
                                      device=device)
    result = tr.run()
    wall_s = time.time() - t0
    snap = tr.metrics.snapshot()
    counters = snap["counters"]
    epochs = tr.epoch_times
    warm = epochs[1:] if len(epochs) > 1 else epochs
    batches = int(counters.get("sample.batches", 0)) / max(len(epochs), 1)
    warm_epoch_s = float(np.median(warm)) if warm else 0.0
    hists = snap.get("hists") or {}

    def _hq(name):
        # a distribution, not a peak: the depth histogram tells a queue that
        # sat empty (producer-bound) from one that sat full (consumer-bound)
        d = hists.get(name)
        if not d or not d.get("count"):
            return None
        h = LogHistogram.from_dict(d)
        q = h.quantiles()
        q["max"] = h.max
        q["count"] = h.count
        return q

    return {
        "mode": mode,
        "warm_epoch_s": round(warm_epoch_s, 5),
        "batches_per_epoch": int(batches),
        "batches_per_sec": round(batches / warm_epoch_s, 2) if warm_epoch_s > 0 else None,
        "sample_stall_ms_total": counters.get("sample.stall_ms"),
        "sample_stall_ms_dist": _hq("sample.stall_ms"),
        "sample_h2d_ms_total": counters.get("sample.h2d_ms"),
        # fused: exactly 0; sync prices the wire_accounting formula;
        # pipelined and device measure it per staged batch
        "sample_h2d_bytes_total": counters.get("sample.h2d_bytes"),
        # fused: one graph replay per batch
        "dispatches": counters.get("sample.dispatches"),
        "epoch_compiles": {
            k: int(v) for k, v in counters.items() if k.startswith("sample.epoch_compiles.")
        } or None,
        "queue_depth_peak": snap["gauges"].get("sample.queue_depth"),
        "queue_depth_dist": _hq("sample.queue_depth"),
        # full precision: the sync == pipelined flag is a bitwise claim
        "loss_history": [float(v) for v in tr.loss_history],
        "final_loss": result["loss"],
        "wall_s": round(wall_s, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.02,
                    help="fraction of the Reddit-scale synthetic graph")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--fanout", default="25-10")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--modes", default="sync,pipelined",
                    help="comma list of SAMPLE_PIPELINE modes to sweep "
                    "(sync, pipelined, device, fused)")
    ap.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="run device (default: the CUDA card; raises when there is none)")
    args = ap.parse_args(argv)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m!r} in --modes")
    from neutronstarlite_torch.models.base import resolve_device

    dev = resolve_device(args.device)
    # the env override outranks cfg.sample_pipeline: left set, every leg
    # would run the same mode
    if os.environ.pop("NTS_SAMPLE_PIPELINE", None) is not None:
        print("sample_bench: ignoring NTS_SAMPLE_PIPELINE -- each --modes leg "
              "selects its own mode", file=sys.stderr)

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.obs import ledger
    from neutronstarlite_torch.tools import bench_graph
    from neutronstarlite_torch.utils.config import InputInfo

    cache_dir, v_num, e_num, gen_s = bench_graph.build_and_cache_graph(args.scale)
    host_graph, src, dst = bench_graph.load_cached_graph(cache_dir)
    sizes = [int(s) for s in bench_graph.LAYERS.split("-")]
    datum = GNNDatum.random_generate(v_num, sizes[0], bench_graph.N_LABELS, seed=7)

    cfg = InputInfo()
    cfg.algorithm = "GCNSAMPLESINGLE"
    cfg.vertices = v_num
    cfg.layer_string = bench_graph.LAYERS
    cfg.batch_size = args.batch_size
    cfg.fanout_string = args.fanout
    cfg.epochs = args.epochs
    cfg.learn_rate = 0.01
    cfg.weight_decay = 0.0001
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.5
    cfg.precision = args.precision

    os.environ.setdefault("NTS_FINAL_EVAL", "0")
    rows = {m: measure_mode(m, cfg, src, dst, datum, host_graph, dev) for m in modes}

    head = rows.get("fused") or rows.get("pipelined") or rows[modes[0]]
    sync = rows.get("sync")
    parity = None
    if sync is not None and "pipelined" in rows:
        parity = sync["loss_history"] == rows["pipelined"]["loss_history"]
    fused_vs_sync = None
    if sync is not None and "fused" in rows:
        fl, sl = rows["fused"]["loss_history"], sync["loss_history"]
        if fl and sl and len(fl) == len(sl):
            fused_vs_sync = round(max(abs(a - b) for a, b in zip(fl, sl)), 6)
    out = {
        "metric": "sample_pipeline_batches_per_sec",
        "value": head["batches_per_sec"],
        "unit": "batches/s",
        "vs_baseline": (
            round(head["batches_per_sec"] / sync["batches_per_sec"], 3)
            if sync and sync["batches_per_sec"] and head["batches_per_sec"] else None
        ),
        "extra": {
            "scale": args.scale,
            "v_num": v_num,
            "e_num": e_num,
            "batch_size": args.batch_size,
            "fanout": args.fanout,
            "epochs": args.epochs,
            "modes": rows,
            "sync_pipelined_loss_parity": parity,
            "fused_sync_loss_maxdiff": fused_vs_sync,
            "graph_cache_build_s": round(gen_s, 1),
        },
    }
    if ledger.ledger_dir():
        for m, r in rows.items():
            ledger.append_row({
                "kind": "run",
                "ts": time.time(),
                "run_id": f"sample_bench-{m}",
                "algorithm": "GCNSAMPLESINGLE",
                "cfg": f"sample_bench/{m}/B{args.batch_size}/{args.fanout}/s{args.scale}",
                "graph_digest": None,
                "backend": ledger.backend_fingerprint(),
                "epochs": args.epochs,
                "warm_median_epoch_s": r["warm_epoch_s"],
                "avg_epoch_s": r["warm_epoch_s"],
                "sample_stall_ms_per_epoch": (
                    r["sample_stall_ms_total"] / max(args.epochs, 1)
                    if r["sample_stall_ms_total"] is not None else None
                ),
                "sample_h2d_bytes_per_epoch": (
                    r["sample_h2d_bytes_total"] / max(args.epochs, 1)
                    if r["sample_h2d_bytes_total"] is not None else None
                ),
                "batches_per_sec": r["batches_per_sec"],
                "dispatches": r["dispatches"],
                "final_loss": r["final_loss"],
            })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
