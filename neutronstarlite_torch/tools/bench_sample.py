"""Mini-batch sampled GCN benchmark at Reddit scale.

Port of ``neutronstarlite_tpu/tools/bench_sample.py``. The workload is the
bench graph (``tools/bench_graph.py``: the Reddit-scale synthetic
power-law graph at ``--scale``, cached on disk) with GraphSAGE-convention
sampling (batch 512, fanout 25-10) over the reference's Reddit widths
602-128-41, trained by the port's ``GCNSampleTrainer``.

The loop times a bounded number of batches, one at a time, through the
trainer's own batch step (``GCNSampleTrainer._train_batch``): each batch is
drawn by the train-split sampler, copied to the device and stepped, and
its time includes the host sampling (the serial sum, an upper bound on a
pipelined epoch's). Metrics: the median batch time and the sampled edge
slots per second; the epoch time extrapolated to the whole train split.

Usage: python -m neutronstarlite_torch.tools.bench_sample [--scale S]
         [--batch-size 512] [--fanout 25-10] [--batches N] [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises. Prints ONE JSON line:
{"metric": "gcn_reddit_sampled_batch_time", ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _time_batches(tr, n: int, dev):
    """``n`` batches of the train-split sampler through the trainer's batch
    step, one at a time: (seconds per batch, sampling seconds per batch,
    the last loss, the last batch)."""
    import torch

    sampler = tr.samplers[0]
    gen = sampler.sample_epoch()
    times, sample_times = [], []
    loss = b = None
    for bi in range(n):
        t0 = time.time()
        try:
            b = next(gen)
        except StopIteration:
            gen = sampler.sample_epoch()
            b = next(gen)
        t_sampled = time.time()
        nodes, hops, seed_mask, seeds = tr._to_device(b)
        loss = tr._train_batch(nodes, hops, seed_mask, seeds, 0, bi)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.time() - t0)
        sample_times.append(t_sampled - t0)
    return times, sample_times, loss, b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--fanout", default="25-10")
    ap.add_argument("--batches", type=int, default=60,
                    help="timed batches after warmup (steady state needs tens, "
                    "not an epoch's hundreds)")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("NTS_SAMPLE_DEADLINE_S", 1500)),
                    help="hard wall bound: dump stacks and exit 3")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="run device (default: the CUDA card; raises when there is none)")
    args = ap.parse_args(argv)

    from neutronstarlite_torch.models.base import resolve_device

    dev = resolve_device(args.device)
    from neutronstarlite_torch.tools import bench_graph

    watchdog = bench_graph.start_watchdog(args.deadline)
    try:
        return _run(args, dev, bench_graph)
    finally:
        watchdog.cancel()


def _run(args, dev, bench_graph) -> int:
    import torch

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
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
    cfg.epochs = 1
    cfg.learn_rate = 0.01
    cfg.weight_decay = 0.0001
    cfg.decay_epoch = -1
    cfg.drop_rate = 0.5
    cfg.precision = args.precision

    t0 = time.time()
    tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, host_graph=host_graph, device=dev)
    build_s = time.time() - t0
    sampler = tr.samplers[0]
    n_train = len(sampler.seed_nids)
    batches_per_epoch = -(-n_train // args.batch_size)
    try:
        times, sample_times, loss, b = _time_batches(tr, args.warmup + args.batches, dev)
    finally:
        tr.par_sampler.close()

    batch_s = float(np.median(times[args.warmup:]))
    sample_s = float(np.median(sample_times[args.warmup:]))
    # padded slot capacities: the shape the device runs (real edges vary)
    slots_per_batch = int(sum(int(h.src_local.shape[0]) for h in b.hops))
    out = {
        "metric": "gcn_reddit_sampled_batch_time",
        "value": round(batch_s, 5),
        "unit": "s",
        "vs_baseline": None,  # the reference publishes no sampled numbers
        "extra": {
            "scale": args.scale,
            "v_num": v_num,
            "e_num": e_num,
            "layers": bench_graph.LAYERS,
            "batch_size": args.batch_size,
            "fanout": args.fanout,
            "precision": args.precision,
            "batches_timed": args.batches,
            "sample_s_median": round(sample_s, 5),
            "device_pad_s_median": round(batch_s - sample_s, 5),
            "edge_slots_per_batch": slots_per_batch,
            "edge_slots_per_sec": round(slots_per_batch / batch_s, 0),
            "train_seeds": int(n_train),
            "batches_per_epoch": int(batches_per_epoch),
            "epoch_s_extrapolated": round(batch_s * batches_per_epoch, 3),
            "final_loss": float(loss),
            "build_s": round(build_s, 1),
            "graph_cache_build_s": round(gen_s, 1),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
