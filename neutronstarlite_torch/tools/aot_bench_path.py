"""The capacity report for one bench (order, path) program — the port's
counterpart of ``neutronstarlite_tpu/tools/aot_bench_path.py``.

The JAX tool compiled the exact program the bench would run against a TPU
topology, to learn its compile time and seed the compile cache with no
chip claimed. The card compiles nothing per program (the kernels build
once from ``csrc/``), so the question left is the one ``aot_check``
answers: does the program the bench graph (``tools/bench_graph.py``, the
Reddit-scale synthetic graph at ``--scale``) would run fit the card, and
does every launch fit the kernels' limits? This tool builds that
program's trainer on the CPU (602-128-41, the same graph cache, the same
tables) and reports its host build seconds, its device bytes by category,
the kernel caches, the transient of one step and every limit check, by
``tools/aot_check.full_batch_case``.

Paths: ``scatter`` (the plain route), ``ell`` (``csrc/ell_level.cu``),
``bsp`` (``csrc/bsp_ell.cu``), ``blocked`` (plain blocked ELL at
``--kernel-tile``). Orders: ``standard`` (aggregate, then transform) and
``eager`` (transform, then aggregate).

Usage: python -m neutronstarlite_torch.tools.aot_bench_path
         [--order eager] [--path bsp] [--scale 1.0] [--precision bfloat16]
         [--kernel-tile 8192] [--memory-gib G]
Prints ONE JSON line; exits 0 when it fits, 1 when not.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def bench_trainer(order: str, path: str, scale: float, precision: str = "bfloat16",
                  kernel_tile: int = 8192):
    """The bench program's trainer on the CPU and its host build seconds."""
    import numpy as np

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.models import get_algorithm
    from neutronstarlite_torch.tools.bench_graph import build_and_cache_graph, load_cached_graph
    from neutronstarlite_torch.utils.config import InputInfo

    d, v, _e, _ = build_and_cache_graph(scale)
    g, src, dst = load_cached_graph(d)
    rng = np.random.default_rng(0)
    datum = GNNDatum(
        feature=rng.standard_normal((v, 602), dtype=np.float32) * 0.1,
        label=rng.integers(0, 41, size=v, dtype=np.int32),
        mask=(np.arange(v) % 3).astype(np.int32),
    )
    cfg = InputInfo(
        algorithm="GCN" if order == "standard" else "GCNEAGER", vertices=v,
        layer_string="602-128-41", epochs=1, drop_rate=0.0, precision=precision,
        optim_kernel=path != "scatter", pallas_kernel=path in ("ell", "bsp"),
        kernel_tile=kernel_tile if path in ("bsp", "blocked") else 0,
    )
    os.environ["NTS_PALLAS_RESIDENT"] = "1" if path == "ell" else "0"
    t0 = time.perf_counter()
    tr = get_algorithm(cfg.algorithm).from_arrays(cfg, src, dst, datum, seed=0,
                                                  device="cpu", host_graph=g)
    return tr, time.perf_counter() - t0


def report(order: str, path: str, scale: float, precision: str = "bfloat16",
           kernel_tile: int = 8192, memory_bytes=None) -> dict:
    from neutronstarlite_torch.tools import aot_check
    from neutronstarlite_torch.tools.roofline import device_limits

    limits = device_limits()
    hbm = float(memory_bytes or limits["hbm_bytes"])
    tr, build_s = bench_trainer(order, path, scale, precision, kernel_tile)
    out = {"order": order, "path": path, "scale": scale, "precision": precision,
           "v_num": tr.host_graph.v_num, "e_num": tr.host_graph.e_num, "build_s": build_s,
           "route": type(tr.compute_graph).__name__, "memory_bytes": hbm,
           "memory_source": limits["source"] if not memory_bytes else "--memory-gib"}
    out.update(aot_check.full_batch_case(tr, aot_check.kernel_geometry(),
                                         int(limits["smem_per_block"])))
    out["refused"] = [c["name"] for c in out["checks"] if not c["ok"]]
    out["fits"] = bool(out["peak_bytes"] <= hbm and not out["refused"])
    out["peak_gib"] = out["peak_bytes"] / 2 ** 30
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="eager", choices=["standard", "eager"])
    ap.add_argument("--path", default="bsp", choices=["scatter", "ell", "bsp", "blocked"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--kernel-tile", type=int, default=8192)
    ap.add_argument("--memory-gib", type=float, default=None)
    args = ap.parse_args(argv)
    out = report(args.order, args.path, args.scale, args.precision, args.kernel_tile,
                 args.memory_gib * 2 ** 30 if args.memory_gib else None)
    out.pop("checks")  # the verdicts are in "refused"
    print(json.dumps(out))
    return 0 if out["fits"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
