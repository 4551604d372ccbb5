"""Workload-matrix benchmark: epoch time for every cfg in configs/.

Port of ``neutronstarlite_tpu/tools/bench_matrix.py``. Each cfg (all of
``--configs`` but those whose name holds a ``--skip`` substring; the
default skips the Reddit workloads) is built by the port's
``get_algorithm`` in this process with EPOCHS set to warmup + epochs, and
trained by its ``run``; the row's metric is the median epoch time after
the warm-up from the trainer's own ``epoch_times``. A cfg whose data is
missing gets the data-prep tool (``graph/prep.py``) once when its name
holds a dataset prep knows; for cora, prep converts the directory the
cfg's EDGE_FILE names. A workload that fails to build or run is recorded
with its error, never fatal.

Usage: python -m neutronstarlite_torch.tools.bench_matrix [--configs DIR]
       [--epochs N] [--warmup N] [--skip reddit] [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises. Prints a table on stderr and one JSON
line {"device", "rows"}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def measure_cfg(cfg_path: str, epochs: int, warmup: int, device=None):
    from neutronstarlite_torch.models import get_algorithm
    from neutronstarlite_torch.utils.config import InputInfo

    cfg = InputInfo.read_from_cfg_file(cfg_path)
    cfg.epochs = warmup + epochs
    cls = get_algorithm(cfg.algorithm)
    toolkit = cls(cfg, base_dir=os.path.dirname(os.path.abspath(cfg_path)), device=device)
    t0 = time.time()
    toolkit.init_graph()
    toolkit.init_nn()
    build_s = time.time() - t0
    result = toolkit.run()
    times = toolkit.epoch_times[warmup:]
    med = float(np.median(times)) if times else None
    return {
        "algorithm": cfg.algorithm,
        "vertices": cfg.vertices,
        "layers": cfg.layer_string,
        "epoch_s": round(med, 5) if med is not None else None,
        "first_epoch_s": round(toolkit.epoch_times[0], 3) if toolkit.epoch_times else None,
        "build_s": round(build_s, 2),
        "loss": result.get("loss"),
        "acc_train": (result.get("acc") or {}).get("train"),
    }


def _prep_missing(cfg_path: str, name: str) -> bool:
    """Materialise a synthesizable dataset the cfg names; False when prep
    knows none of its name."""
    from neutronstarlite_torch.graph import prep
    from neutronstarlite_torch.utils.config import InputInfo

    dataset = next((d for d in prep.DATASETS if d in name), None)
    if dataset is None:
        return False
    base = os.path.dirname(os.path.abspath(cfg_path))
    argv = ["--dataset", dataset, "--out", os.path.join(base, "..", "data")]
    if dataset == "cora":
        edge_file = InputInfo.read_from_cfg_file(cfg_path).edge_file
        argv += ["--reference-data", os.path.dirname(os.path.join(base, edge_file))]
    prep.main(argv)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs"))
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--skip", default="reddit",
                    help="comma-separated substrings of cfg names to skip (default: the "
                    "reddit workloads)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="run device (default: the CUDA card; raises when there is none)")
    args = ap.parse_args(argv)

    import torch

    from neutronstarlite_torch.models.base import resolve_device

    dev = resolve_device(args.device)
    skips = [s for s in args.skip.split(",") if s]
    rows = []
    for cfg_path in sorted(glob.glob(os.path.join(args.configs, "*.cfg"))):
        name = os.path.basename(cfg_path)[: -len(".cfg")]
        if any(s in name for s in skips):
            continue
        print(f"== {name}", file=sys.stderr, flush=True)
        try:
            try:
                row = {"workload": name,
                       **measure_cfg(cfg_path, args.epochs, args.warmup, dev)}
            except FileNotFoundError:
                if not _prep_missing(cfg_path, name):
                    raise
                row = {"workload": name,
                       **measure_cfg(cfg_path, args.epochs, args.warmup, dev)}
        except Exception as e:  # a broken workload must not sink the matrix
            row = {"workload": name, "error": f"{type(e).__name__}: {e}"[:200]}
        rows.append(row)
        print(f"   {row}", file=sys.stderr, flush=True)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"\nworkload matrix on {name} (median of {args.epochs} epochs after "
          f"{args.warmup} warmup):", file=sys.stderr)
    for r in rows:
        if r.get("epoch_s") is not None:
            print(f"  {r['workload']:<22} {r['algorithm']:<18} "
                  f"{r['epoch_s'] * 1000:9.2f} ms/epoch", file=sys.stderr)
        else:
            print(f"  {r['workload']:<22} FAILED: {r.get('error')}", file=sys.stderr)
    print(json.dumps({"device": name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
