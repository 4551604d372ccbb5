"""Single-card kernel micro-benchmarks at fixed shapes.

Port of ``neutronstarlite_tpu/tools/micro_bench.py``. The shapes are the
tool's own: the 5 %-Reddit edge set (E 5,730,794) over the half-Reddit
vertex table ([116,482, f]), a synthetic power-law graph from ``--seed``
(7), bf16 inputs; ``--scale`` shrinks V and E. Every op of the reference
keeps its name and its ``traffic_bytes`` / ``flops``:

- ``matmul_bf16_602x128``, ``hbm_stream_f32_64MB``, ``row_gather_bf16``:
  library ops, the yardstick (a matmul, a 32 MB stream, a random row
  gather);
- ``ell_aggregate_xla_bf16``: the plain ELL version
  (``ops/ell.ell_tables_aggregate``, the tables' ``plain``);
- ``sorted_scatter_bf16``: ``ops/aggregate.gather_dst_from_src`` on a
  ``ScatterGraph`` (an ``index_add_`` per edge chunk);
- ``bsp_streamed_bf16``: ``csrc/bsp_ell.cu`` through
  ``ops/bsp_ell.bsp_aggregate`` over ``BspEllPair.from_host(g, dt=512,
  vt=8192)``'s forward tables;
- ``pallas_ell_resident_bf16`` (f 128) and ``pallas_ell_fchunked_602_bf16``
  (f 602): ``csrc/ell_level.cu`` through
  ``ops/ell_kernel.ell_level_aggregate`` on ``EllPair.fwd``. The
  reference's low-K level merge and its feature-column chunking exist only
  for Mosaic (its compile count and VMEM) and are not ported: the kernel
  runs the tables as ``EllPair`` builds them, at the whole width;
- ``edge_{gat,ggcn}_{eager,fused}``: the edge chain of ``ops/edge.py``
  (score, per-destination softmax, weighted sum) and ``ops/fused_edge.py``
  on a unit-weight build of the graph, forward and backward under
  ``torch.autograd``.

Timing: each op is a function of a scalar ``s`` (the input times ``s``
stays inside the timed function, as in the reference); after ``WARMUP``
calls, each of ``--iters`` calls is timed with its own pair of CUDA events
(on the CPU with the host clock) and the median is reported. An op that
raises is recorded with its error and the run goes on.

Usage: python -m neutronstarlite_torch.tools.micro_bench [--iters 10]
    [--scale 1.0] [--ops SUBSTR,...] [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given (for the tests);
without a card and without ``--device cpu`` it raises. Prints ONE JSON
line: {"platform": "gpu"|"cpu", "device": name, "V", "E", "ops": {name:
{"ms", "apparent_gbs"|"tflops"} or {"error"}}}. A ``--ops`` filter that
matches no op exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import zlib
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

V = 116482  # half Reddit
E = 5730794  # 5 % of Reddit's edges
F = 128
F_WIDE = 602
BSP_DT, BSP_VT = 512, 8192
WARMUP = 2  # untimed calls before the timed ones
# the ops that launch a hand-written kernel on the card, by the wrapper
# whose launch counter they raise
KERNEL_OPS = {
    "bsp_streamed_bf16": "bsp_ell",
    "pallas_ell_resident_bf16": "ell_level",
    "pallas_ell_fchunked_602_bf16": "ell_level",
}


def shapes(scale: float) -> Tuple[int, int]:
    """(V, E) at ``scale`` (the reference's floors: 64 and 512)."""
    return max(int(V * scale), 64), max(int(E * scale), 512)


def eager_edge_chain(sg, h, a_src, a_dst, slope: float):
    """The decoupled score -> per-destination softmax -> weighted-aggregate
    chain over the edge space (models/gat.py / ggcn.py)."""
    from neutronstarlite_torch.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax

    score = torch.nn.functional.leaky_relu(
        a_src[sg.csc_src] + a_dst[sg.csc_dst], negative_slope=slope)
    return aggregate_edge_to_dst_weighted(sg, edge_softmax(sg, score), h)


def _grad_of(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """d/dx of sum(fn(x)**2): the op's forward and its backward."""
    h = x.detach().requires_grad_(True)
    (out,) = torch.autograd.grad((fn(h).float() ** 2).sum(), h)
    return out


class MicroBench:
    """The tool's inputs, built lazily by key, and its op table."""

    def __init__(self, v_num: int, e_num: int, seed: int, device):
        self.v_num, self.e_num, self.seed = v_num, e_num, seed
        self.device = torch.device(device)
        self.built: Dict[str, object] = {}

    def key_rng(self, key: str) -> np.random.Generator:
        # one stream per key: an input's values do not depend on which ops
        # a filtered run builds, or in which order
        return np.random.default_rng([self.seed, zlib.crc32(key.encode())])

    def normal(self, key: str, shape, dtype=torch.bfloat16) -> torch.Tensor:
        a = self.key_rng(key).standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(self.device, dtype)

    def _graph(self, weight: str):
        from neutronstarlite_torch.graph.storage import build_graph
        from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph

        src, dst = synthetic_power_law_graph(self.v_num, self.e_num, seed=self.seed)
        return build_graph(src, dst, self.v_num, weight=weight)

    def need(self, key: str):
        if key not in self.built:
            print(f"building {key} (host)...", file=sys.stderr, flush=True)
            self.built[key] = self._build(key)
        return self.built[key]

    def _build(self, key: str):
        from neutronstarlite_torch.ops.aggregate import ScatterGraph
        from neutronstarlite_torch.ops.bsp_ell import BspEllPair
        from neutronstarlite_torch.ops.ell import EllPair
        from neutronstarlite_torch.ops.fused_edge import FusedEdgePair

        v, e, dev = self.v_num, self.e_num, self.device
        builders = {
            "g": lambda: self._graph("gcn_norm"),
            "sg": lambda: ScatterGraph.from_host(self.need("g"), device=dev),
            "ell": lambda: EllPair.from_host(self.need("g"), device=dev),
            "bsp": lambda: BspEllPair.from_host(self.need("g"), dt=BSP_DT, vt=BSP_VT,
                                                device=dev),
            "x": lambda: self.normal("x", (v, F)),
            "xw": lambda: self.normal("xw", (v, F_WIDE)),
            "w_mm": lambda: self.normal("w_mm", (F_WIDE, F)),
            "idx": lambda: torch.from_numpy(
                self.key_rng("idx").integers(0, v, size=e)).to(dev),
            "big": lambda: self.normal("big", (8 << 20,), torch.float32),  # 32 MB
            # the edge family: a unit-weight graph, the chain vs the fused op
            "g1": lambda: self._graph("ones"),
            "sg1": lambda: ScatterGraph.from_host(self.need("g1"), device=dev),
            "fused": lambda: FusedEdgePair.from_host(self.need("g1"), device=dev),
            "al": lambda: self.normal("al", (v, 1), torch.float32),
            "ar": lambda: self.normal("ar", (v, 1), torch.float32),
            "hs": lambda: self.normal("hs", (v, F)),
            "hd": lambda: self.normal("hd", (v, F)),
        }
        return builders[key]()

    def ops(self) -> List[tuple]:
        """(name, inputs, factory, rate kwargs): ``factory(*inputs)`` is the
        timed function of the scalar s. The one place op names live."""
        from neutronstarlite_torch.ops.aggregate import gather_dst_from_src
        from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
        from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
        from neutronstarlite_torch.ops.fused_edge import fused_edge_attention_aggregate

        v, e = self.v_num, self.e_num
        return [
            ("matmul_bf16_602x128", ("xw", "w_mm"),
             lambda xw, w_mm: lambda s: (xw * s) @ w_mm,
             dict(flops=2.0 * v * F_WIDE * F)),
            ("hbm_stream_f32_64MB", ("big",),
             lambda big: lambda s: big * s,
             dict(traffic_bytes=2 * (8 << 20) * 4)),
            ("row_gather_bf16", ("x", "idx"),
             lambda x, idx: lambda s: (x * s)[idx],
             dict(traffic_bytes=e * F * 2)),
            ("ell_aggregate_xla_bf16", ("ell", "x"),
             lambda ell, x: lambda s: ell.fwd.plain(x * s),
             dict(traffic_bytes=e * F * 2)),
            ("sorted_scatter_bf16", ("sg", "x"),
             lambda sg, x: lambda s: gather_dst_from_src(sg, x * s),
             dict(traffic_bytes=e * F * 2)),
            ("bsp_streamed_bf16", ("bsp", "x"),
             lambda bsp, x: lambda s: bsp_aggregate(bsp.fwd, x * s),
             dict(traffic_bytes=e * F * 2)),
            # the edge family, forward and backward: the fused backward is
            # three streamed passes, which forward-only timing would hide
            ("edge_gat_eager", ("sg1", "x", "al", "ar"),
             lambda sg, x, al, ar: lambda s: _grad_of(
                 lambda h: eager_edge_chain(sg, h, al, ar, 0.01), x * s),
             dict(traffic_bytes=3 * e * F * 2)),
            ("edge_gat_fused", ("fused", "x", "al", "ar"),
             lambda fe, x, al, ar: lambda s: _grad_of(
                 lambda h: fused_edge_attention_aggregate(fe, h, al, ar, 0.01), x * s),
             dict(traffic_bytes=3 * e * F * 2)),
            ("edge_ggcn_eager", ("sg1", "x", "hs", "hd"),
             lambda sg, x, hs, hd: lambda s: _grad_of(
                 lambda h: eager_edge_chain(sg, h, hs, hd, 0.2), x * s),
             dict(traffic_bytes=3 * e * F * 2)),
            ("edge_ggcn_fused", ("fused", "x", "hs", "hd"),
             lambda fe, x, hs, hd: lambda s: _grad_of(
                 lambda h: fused_edge_attention_aggregate(fe, h, hs, hd, 0.2), x * s),
             dict(traffic_bytes=3 * e * F * 2)),
            ("pallas_ell_resident_bf16", ("ell", "x"),
             lambda ell, x: lambda s: ell_level_aggregate(ell.fwd, x * s),
             dict(traffic_bytes=e * F * 2)),
            ("pallas_ell_fchunked_602_bf16", ("ell", "xw"),
             lambda ell, xw: lambda s: ell_level_aggregate(ell.fwd, xw * s),
             dict(traffic_bytes=e * F_WIDE * 2)),
        ]

    def op(self, name: str) -> Callable:
        """The timed function of op ``name`` on its built inputs."""
        for n, needs, factory, _ in self.ops():
            if n == name:
                return factory(*[self.need(k) for k in needs])
        raise KeyError(name)


def median_s(fn: Callable, iters: int, device: torch.device) -> float:
    """The median seconds of ``iters`` calls of ``fn(s)``, each with a fresh
    scalar, after ``WARMUP`` calls: CUDA events on the card (one pair per
    call), the host clock on the CPU."""
    for i in range(WARMUP):
        fn(1.0 + 1e-6 * i)
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for i, (a, b) in enumerate(pairs):
            a.record()
            fn(1.0 + 1e-6 * (i + 1))
            b.record()
        torch.cuda.synchronize(device)
        ts = [a.elapsed_time(b) / 1e3 for a, b in pairs]
    else:
        for i in range(iters):
            t0 = time.perf_counter()
            fn(1.0 + 1e-6 * (i + 1))
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def run(bench: MicroBench, names: List[str], iters: int) -> dict:
    """Time the named ops; one record per op (its error when it raises)."""
    dev = bench.device
    out = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "V": bench.v_num, "E": bench.e_num, "ops": {},
    }
    for name, needs, factory, rates in bench.ops():
        if name not in names:
            continue
        try:
            fn = factory(*[bench.need(k) for k in needs])
            med = median_s(fn, iters, dev)
            rec = {"ms": round(med * 1e3, 4)}
            if rates.get("traffic_bytes"):
                rec["apparent_gbs"] = round(rates["traffic_bytes"] / med / 1e9, 1)
            if rates.get("flops"):
                rec["tflops"] = round(rates["flops"] / med / 1e12, 1)
            out["ops"][name] = rec
            print(f"{name}: {rec}", file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 -- recorded, the run goes on
            out["ops"][name] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
            print(f"{name} FAILED: {out['ops'][name]}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink V and E (1.0: V 116,482, E 5,730,794)")
    ap.add_argument("--ops", default="",
                    help="comma-separated op-name substrings to run (default: all)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="run device (default: the CUDA card; raises when there is none)")
    args = ap.parse_args(argv)

    from neutronstarlite_torch.models.base import resolve_device

    dev = resolve_device(args.device)
    v_num, e_num = shapes(args.scale)
    bench = MicroBench(v_num, e_num, args.seed, dev)
    op_filter = [s for s in args.ops.split(",") if s]
    names = [op[0] for op in bench.ops()
             if not op_filter or any(s in op[0] for s in op_filter)]
    if not names:
        print(f"FATAL: --ops {args.ops!r} matches none of {[op[0] for op in bench.ops()]}",
              file=sys.stderr, flush=True)
        return 2
    print(json.dumps(run(bench, names, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
