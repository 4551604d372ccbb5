"""Compare the distributed aggregation exchanges — port of
``neutronstarlite_tpu/parallel/comm_bench.py``.

``python -m neutronstarlite_torch.parallel.comm_bench [--vertices N]
[--avg-degree D] [--feature F] [--partitions P] [--steps K]
[--kernel-tile VT] [--edge-family | --mesh Pv,Pf [--side both|1d|2d]]
[--device cpu|cuda]``

For each exchange (``ring``: P - 1 send/recv rounds; ``ell``: all_gather
and the per-shard rectangular ELL tables through the hand-written
``ell_level`` kernel; ``mirror``: the uniform mirror's all_to_all;
``ring_blocked``: the pipelined ring over blocked step tables; with
``--kernel-tile``, ``blocked``: all_gather and the per-shard blocked
tables) it builds the layout on a seeded power-law graph, runs one
aggregation forward and backward per step, and reports:

- wire rows per partition per layer (what ``COMM_LAYER:auto`` compares)
  and the f32 MiB they make;
- the peak exchange-buffer rows and MiB live at once
  (``tools/wire_accounting.peak_resident_rows``);
- seconds per step, and for ``ring_blocked`` each ring step's table work
  alone (``per_step_compute_s``).

Under ``torch.distributed`` (one process per partition, e.g. ``python -m
torch.distributed.run --nproc_per_node P -m
neutronstarlite_torch.parallel.comm_bench``) it times the real exchanges on
this rank's rows; in one process it times each exchange's collective-free
twin over P partitions. ``--edge-family`` compares the attention family's
mirror chain with the fused edge ring instead; ``--mesh Pv,Pf`` the 1D
ring over Pv*Pf partitions with the 2D (vertex x feature) ring, as a
micro_bench-shaped ``{"platform", "ops", "meta"}`` line (``--side`` one
leg of the two). The entry runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _graph(v_num: int, avg_degree: int, seed: int, weight: str):
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph

    src, dst = synthetic_power_law_graph(v_num, v_num * avg_degree, seed=seed)
    return build_graph(src, dst, v_num, weight=weight)


def _group(partitions: int):
    """(group, P): the joined ranks, or None and P for the twin."""
    from neutronstarlite_torch.parallel import mesh

    if mesh.world_size() > 1:
        return mesh.resolve_group(partitions, False)
    return None, partitions or 2


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _rows(space, arr: np.ndarray, group) -> np.ndarray:
    """This rank's rows of a padded vertex-space array (all in the twin)."""
    padded = space.pad_vertex_array(arr)
    if group is None:
        return padded
    return padded[group.rank * space.vp:(group.rank + 1) * space.vp]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _loss_step(fn, x: torch.Tensor):
    """One forward and backward: the loss value (a 0-dim tensor)."""
    xl = x.detach().requires_grad_(True)
    val = (fn(xl) ** 2).sum()
    val.backward()
    return val.detach()


def _time_steps(fn, x: torch.Tensor, steps: int, device):
    """(seconds per step after one excluded call, the loss value)."""
    val = _loss_step(fn, x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        val = _loss_step(fn, x)
    _sync(device)
    return (time.perf_counter() - t0) / max(steps, 1), float(val)


def bench_layers(v_num, avg_degree, f, partitions, steps, seed=3, kernel_tile=0,
                 device=None, keep=None):
    """Every exchange's row of the table (module docstring). ``keep``, a
    dict, receives the input ``x`` and the ``ell`` leg's per-shard tables,
    for a caller that checks the kernel on them."""
    from neutronstarlite_torch.ops.blocked_ell import BlockedEll
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.parallel.dist_blocked import build_dist_blocked
    from neutronstarlite_torch.parallel.dist_edge_ops import (
        UniformMirror,
        dist_gather_dst_from_src_mirror,
    )
    from neutronstarlite_torch.parallel.dist_ell import build_dist_ell
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ops import (
        GatherExchange,
        RingExchange,
        RingTables,
        dist_gather_dst_from_src,
    )
    from neutronstarlite_torch.parallel.dist_ring_blocked import (
        RingBlockedExchange,
        RingBlockedPair,
        default_ring_vt,
    )
    from neutronstarlite_torch.parallel.mirror import MirrorGraph
    from neutronstarlite_torch.tools.wire_accounting import peak_resident_rows

    device = torch.device(device or "cuda")
    g = _graph(v_num, avg_degree, seed, "gcn_norm")
    group, P = _group(partitions)
    shards = range(P) if group is None else [group.rank]
    dist = DistGraph.build(g, P)
    mg = MirrorGraph.build(g, P)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_rows(dist, rng.standard_normal((v_num, f)).astype(np.float32),
                               group)).to(device)

    ring_vt = default_ring_vt(dist.vp, kernel_tile)
    rblk = RingBlockedPair.build(dist, ring_vt, shards, device=device)
    exchanges = {
        "ring": (RingExchange(RingTables.build(dist, shards, device), group),
                 (P - 1) * dist.vp, peak_resident_rows("ring", P, dist.vp)),
        "ell": (GatherExchange(build_dist_ell(dist, shards, device=device),
                               ell_level_aggregate, group, "ell_level"),
                (P - 1) * dist.vp,  # all_gather ships the same shard rows
                peak_resident_rows("ell", P, dist.vp)),
        "mirror": (UniformMirror(mg, group, device),
                   (P - 1) * mg.mb,  # the p -> p chunk stays on the device
                   peak_resident_rows("mirror", P, dist.vp, mg.mb)),
        "ring_blocked": (RingBlockedExchange(rblk, group),
                         (P - 1) * dist.vp,  # the same volume over P - 1 hops
                         peak_resident_rows("ring_blocked", P, dist.vp)),
    }
    if kernel_tile:
        exchanges["blocked"] = (
            GatherExchange(build_dist_blocked(dist, shards, kernel_tile, device=device),
                           BlockedEll.aggregate, group),
            (P - 1) * dist.vp, peak_resident_rows("blocked", P, dist.vp))

    results = {}
    for name, (ex, wire_rows, peak_rows) in exchanges.items():
        if name == "mirror":
            fn = lambda v, e=ex: dist_gather_dst_from_src_mirror(e, v)  # noqa: E731
        else:
            fn = lambda v, e=ex: dist_gather_dst_from_src(e, v)  # noqa: E731
        dt, check = _time_steps(fn, x, steps, device)
        results[name] = {
            "step_s": round(dt, 5),
            "wire_rows_per_dev_layer": int(wire_rows),
            "wire_mb_per_dev_layer_f32": round(wire_rows * f * 4 / 2**20, 2),
            "peak_live_rows": int(peak_rows),
            "peak_live_mb_f32": round(peak_rows * f * 4 / 2**20, 2),
            "check": check,
        }
    if keep is not None:
        keep.update(x=x, ell=exchanges["ell"][0].tables)
    results["ring_blocked"]["per_step_compute_s"] = ring_step_times(
        rblk.fwd, f, steps, device=device, rank=shards[0])
    results["meta"] = {
        "v_num": v_num, "e_num": int(g.e_num), "feature": f, "P": P,
        "vp": dist.vp, "mb": mg.mb, "eb": dist.eb, "el": mg.el,
        "ring_vt": ring_vt, "ring_work_steps": rblk.fwd.work_steps(),
        "device": _device_name(device),
    }
    return results


def bench_edge_family(v_num, avg_degree, f, partitions, steps, seed=3, kernel_tile=0,
                      device=None):
    """The attention family's leg: the mirror chain (one all_to_all and
    [El, .] edge tensors per layer) against the fused edge ring
    (``KERNEL:fused_edge``), one GAT layer forward and backward each, with
    the wire values both ship."""
    from neutronstarlite_torch.models.gat import LEAKY_SLOPE
    from neutronstarlite_torch.parallel.dist_edge_ops import UniformMirror, dist_gated_chain
    from neutronstarlite_torch.parallel.dist_fused_edge import (
        RingFusedEdgePair,
        dist_fused_edge_aggregate,
        fused_wire_cols,
    )
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ring_blocked import default_ring_vt
    from neutronstarlite_torch.parallel.mirror import MirrorGraph

    device = torch.device(device or "cuda")
    g = _graph(v_num, avg_degree, seed, "ones")
    group, P = _group(partitions)
    shards = range(P) if group is None else [group.rank]
    mg = MirrorGraph.build(g, P)
    chain = UniformMirror(mg, group, device)
    dist = DistGraph.build(g, P)
    ring_vt = default_ring_vt(dist.vp, kernel_tile)
    pair = RingFusedEdgePair.build(dist, ring_vt, shards, device=device)

    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.standard_normal((f, f)).astype(np.float32)).to(device)
    a = torch.from_numpy(rng.standard_normal((2 * f, 1)).astype(np.float32)).to(device)
    x_host = rng.standard_normal((v_num, f)).astype(np.float32)
    x_mirror = torch.from_numpy(_rows(mg, x_host, group)).to(device)
    x_ring = torch.from_numpy(_rows(dist, x_host, group)).to(device)

    def eager_layer(x):
        h = x @ W
        return dist_gated_chain(chain, torch.cat([h, h @ a[:f]], dim=1), h @ a[f:], f,
                                LEAKY_SLOPE)

    def fused_layer(x):
        h = x @ W
        return dist_fused_edge_aggregate(pair, group, h, h @ a[:f], h @ a[f:], LEAKY_SLOPE)

    legs = {
        "mirror_eager_edge": (eager_layer, x_mirror,
                              (P - 1) * mg.mb * (f + 1),  # [h || h.a_src] rows
                              mg.el * (2 * f + 3) * 4),  # [El, .] edge-tensor bytes
        "ring_fused_edge": (fused_layer, x_ring,
                            (P - 1) * dist.vp * fused_wire_cols(f, 1)["fwd"],
                            0),  # no edge tensors
    }
    results = {}
    for name, (fn, x, wire_vals, edge_bytes) in legs.items():
        dt, check = _time_steps(fn, x, steps, device)
        results[name] = {
            "step_s": round(dt, 5),
            "wire_vals_per_dev_layer": int(wire_vals),
            "edge_hbm_bytes_per_layer": int(edge_bytes),
            "check": check,
        }
    results["meta"] = {
        "v_num": v_num, "e_num": int(g.e_num), "feature": f, "P": P,
        "vp": dist.vp, "mb": mg.mb, "ring_vt": ring_vt, "device": _device_name(device),
    }
    return results


def bench_mesh(v_num, avg_degree, f, pv, pf, steps, seed=3, kernel_tile=0, side="both",
               simulate=None, device=None):
    """The ``--mesh Pv,Pf`` leg: the 1D ring over Pv*Pf partitions against
    the 2D ring (``parallel/partitioner.py``) on the same graph, one
    exchange forward and backward each, with ``predict_mesh``'s wire and
    residency. ``simulate`` (default: no process group of Pv*Pf ranks)
    times the twins."""
    from neutronstarlite_torch.parallel import mesh
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ops import dist_gather_dst_from_src
    from neutronstarlite_torch.parallel.dist_ring_blocked import (
        RingBlockedExchange,
        RingBlockedPair,
        default_ring_vt,
    )
    from neutronstarlite_torch.parallel.partitioner import pad_feature_cols, slab_width
    from neutronstarlite_torch.tools.wire_accounting import predict_mesh

    device = torch.device(device or "cuda")
    P = pv * pf
    if simulate is None:
        simulate = mesh.world_size() != P or P == 1
    g = _graph(v_num, avg_degree, seed, "gcn_norm")
    rng = np.random.default_rng(seed)

    legs = {}
    if side in ("both", "1d"):
        d1 = DistGraph.build(g, P)
        group = None if simulate else mesh.resolve_group(P, False)[0]
        shards = range(P) if group is None else [group.rank]
        p1 = RingBlockedPair.build(d1, default_ring_vt(d1.vp, kernel_tile), shards,
                                   device=device)
        x1 = _rows(d1, rng.standard_normal((v_num, f)).astype(np.float32), group)
        legs["mesh_exchange_1d"] = (RingBlockedExchange(p1, group), x1,
                                    predict_mesh(g, P, 1, [f]))
    if side in ("both", "2d"):
        d2 = DistGraph.build(g, pv)
        grid = None if simulate else mesh.resolve_grid(pv, pf, False)
        shards = range(pv) if grid is None else [grid.v]
        p2 = RingBlockedPair.build(d2, default_ring_vt(d2.vp, kernel_tile), shards,
                                   device=device)
        x2 = pad_feature_cols(d2.pad_vertex_array(
            rng.standard_normal((v_num, f)).astype(np.float32)), pf)
        if grid is not None:
            sw = slab_width(x2.shape[1], pf)
            x2 = x2[grid.v * d2.vp:(grid.v + 1) * d2.vp, grid.f * sw:(grid.f + 1) * sw]
        legs["mesh_exchange_2d"] = (
            RingBlockedExchange(p2, grid.vertex if grid is not None else None), x2,
            predict_mesh(g, pv, pf, [f]))

    ops = {}
    for name, (ex, xh, pred) in legs.items():
        x = torch.from_numpy(np.ascontiguousarray(xh)).to(device)
        dt, check = _time_steps(lambda v, e=ex: dist_gather_dst_from_src(e, v), x, steps,
                                device)
        ops[name] = {
            "ms": round(dt * 1e3, 4),
            "wire_bytes_per_dev_layer": pred["bytes_per_epoch"],
            "peak_resident_feature_bytes": pred["peak_resident_feature_bytes"],
            "slab_widths": pred["slab_widths"],
            "check": check,
        }
    return {
        "platform": _device_name(device),
        "ops": ops,
        "meta": {"v_num": v_num, "e_num": int(g.e_num), "feature": f, "pv": pv, "pf": pf,
                 "simulated": bool(simulate)},
    }


def ring_step_times(rbe, f: int, steps: int, seed: int = 5, device="cpu", rank: int = 0):
    """Each ring step's table work alone: rank ``rank``'s step tables over
    a random ``[vp, f]`` shard, seconds per call ({step: s})."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rbe.vp, f)).astype(np.float32)).to(device)
    acc = torch.zeros((rbe.vp, f), dtype=torch.float32, device=device)
    out = {}
    for s in rbe.work_steps():
        table = rbe.tables[rank][s]
        table.aggregate_into(acc, x)  # warm
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            table.aggregate_into(acc, x)
        _sync(device)
        out[str(s)] = round((time.perf_counter() - t0) / max(steps, 1), 6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=20000)
    ap.add_argument("--avg-degree", type=int, default=25)
    ap.add_argument("--feature", type=int, default=128)
    ap.add_argument("--partitions", type=int, default=0,
                    help="P (default: the world size under torch.distributed, else 2)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--kernel-tile", type=int, default=0,
                    help="also bench the all_gather family's blocked tables (KERNEL_TILE)")
    ap.add_argument("--edge-family", action="store_true",
                    help="bench the attention family instead: the mirror chain against "
                    "the fused edge ring (KERNEL:fused_edge)")
    ap.add_argument("--mesh", default="",
                    help="Pv,Pf: bench the 1D ring over Pv*Pf partitions against the 2D "
                    "(vertex x feature) ring; one micro_bench-shaped JSON line")
    ap.add_argument("--side", default="both", choices=("both", "1d", "2d"),
                    help="with --mesh: one leg only")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (cpu must be asked for)")
    args = ap.parse_args(argv)

    from neutronstarlite_torch.models.base import resolve_device
    from neutronstarlite_torch.parallel import mesh

    device = mesh.maybe_init_process_group(args.device)
    device = resolve_device(device)
    if args.mesh:
        from neutronstarlite_torch.parallel.partitioner import MeshSpec

        spec = MeshSpec.parse(args.mesh)
        out = bench_mesh(args.vertices, args.avg_degree, args.feature, spec.pv, spec.pf,
                         args.steps, kernel_tile=args.kernel_tile, side=args.side,
                         device=device)
        print(json.dumps(out))
        return 0
    bench = bench_edge_family if args.edge_family else bench_layers
    out = bench(args.vertices, args.avg_degree, args.feature, args.partitions, args.steps,
                kernel_tile=args.kernel_tile, device=device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
