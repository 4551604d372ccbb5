"""Run a distributed trainer as P ranks and hold it against its sim twin.

    python -m neutronstarlite_torch.tools.dist_parity --partitions 4 \\
        [--device cpu] [--routes ell,bsp,ring,blocked,ring_blocked,mirror,mesh2x2] \\
        [--vertices V --edges E] [--layers 602-128-41] [--precision bfloat16] \\
        [--epochs 3] [--drop 0] [--kernel-tile 512] [--exchange-check] \\
        [--edge-chunk N] [--rep-threshold D]    (routes also: tune, resume, ...)

Launched without ``RANK`` in the environment, it starts itself as P
processes under ``torch.distributed.run`` (127.0.0.1, a free port; gloo on
the CPU, NCCL with one card per rank), each training ``GCNDIST`` on every
route in turn on a seeded power-law graph (``graph/synthetic.py``); then it
trains the collective-free twin (``NTS_DIST_SIMULATE=1``) in this process
on the same graph, data and parameters, and compares every epoch's loss:
within ``--atol`` (f32) or ``--rtol`` of the twin's. The routes: ``ell``,
``bsp``, ``blocked`` (the all_gather family), ``ring``, ``ring_blocked``
(``DIST_PATH:ring_blocked``), ``mirror`` (``COMM_LAYER:mirror``) and
``mesh2x2`` (``MESH:2,2`` on the ring, P = 4); ``route:ALGORITHM`` (e.g.
``mesh2x2:GINDIST``) trains another distributed family on the route. The
uniform mirror family: ``mirror:GATDIST`` / ``mirror:GGCNDIST`` (the ranks
run the chunked chain, ``--edge-chunk`` setting ``NTS_EDGE_CHUNK``; the
twin the whole chain), ``fused_ring:GATDIST`` (``KERNEL:fused_edge`` on
``DIST_PATH:ring_blocked``), ``depcache`` (``GCNDISTCACHE`` with
``PROC_REP:1``, ``REP_THRESHOLD:--rep-threshold`` and ``CACHE_REFRESH:2``)
and ``getdep`` (``TEST_GETDEP``: every rank must pass, and its mirror rows
must be bitwise the twin's). ``tune``: ``DIST_PATH:auto`` under
``NTS_TUNE=measure`` on the ranks (a fresh ``NTS_TUNE_DIR``), so the
all_gather family is a candidate and its trial runs the rectangular
``ell_level`` kernel; every rank must hold the same decision, and the
twin trains that decision pinned. ``resume`` (the ELL route): every rank
gets a CHECKPOINT_DIR of its own (not shared), trains half the epochs, then
a new trainer resumes to ``--epochs`` (rank 0 alone writes; the resume
epoch and the state reach the other ranks by broadcast); the two runs'
curve must match the twin's straight run, and the report says which ranks'
directories filled and where each rank resumed; ``resume_orbax`` does the
same with ``CKPT_BACKEND:orbax`` (the sharded backend: every rank saves,
rank 0's directory alone holds the data, the resume is broadcast).
``--exchange-check`` also
runs the pipelined ring's exchange alone on the ranks, forward and
backward, with the f32 and the bf16 wire, and reports whether every
rank's output is bitwise the twin's. It prints one JSON line (each
route's rank and twin curves, epoch times, accuracies, the largest gap,
``ok``) and exits 1 when a route disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--routes", default="ell,ring")
    ap.add_argument("--vertices", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=40000)
    ap.add_argument("--layers", default="64-32-7")
    ap.add_argument("--precision", default="float32")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--drop", type=float, default=0.5)
    ap.add_argument("--kernel-tile", type=int, default=512,
                    help="the blocked and bsp routes' source tile (KERNEL_TILE)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exchange-check", action="store_true",
                    help="also hold the ranks' pipelined ring exchange against the twin")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--edge-chunk", type=int, default=0,
                    help="NTS_EDGE_CHUNK for the chunked edge chain (0: its default)")
    ap.add_argument("--rep-threshold", type=int, default=8,
                    help="the depcache route's REP_THRESHOLD")
    ap.add_argument("--out", default="", help="rank curves' file prefix (internal)")
    return ap.parse_args(argv)


ROUTES = {
    # route -> the cfg fields that select it
    "ell": dict(optim_kernel=True),
    "bsp": dict(optim_kernel=True, pallas_kernel=True),
    "blocked": dict(optim_kernel=True),
    "ring": dict(comm_layer="ring"),
    "ring_blocked": dict(dist_path="ring_blocked"),
    "mirror": dict(comm_layer="mirror"),
    "mesh2x2": dict(dist_path="ring_blocked", mesh="2,2"),
    "fused_ring": dict(kernel="fused_edge", dist_path="ring_blocked"),
    "depcache": dict(process_rep=True, cache_refresh=2),
    "getdep": {},
    "tune": dict(dist_path="auto"),
    "resume": dict(optim_kernel=True),
    "resume_orbax": dict(optim_kernel=True, ckpt_backend="orbax"),
}
DEFAULT_ALGORITHM = {"depcache": "GCNDISTCACHE", "getdep": "TEST_GETDEP"}


def _graph(a):
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph

    return synthetic_power_law_graph(a.vertices, a.edges, seed=a.seed)


def _train(a, route: str, device):
    """``route`` (``name[:ALGORITHM]``, GCNDIST by default); returns its
    curve, epoch times and accuracies."""
    import torch

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.models import get_algorithm
    from neutronstarlite_torch.utils.config import InputInfo

    route, _, algorithm = route.partition(":")
    v = a.vertices
    src, dst = _graph(a)
    sizes = [int(t) for t in a.layers.split("-")]
    rng = np.random.default_rng(a.seed)
    datum = GNNDatum(
        feature=rng.standard_normal((v, sizes[0]), dtype=np.float32),
        label=rng.integers(0, sizes[-1], size=v, dtype=np.int32),
        mask=(np.arange(v) % 3).astype(np.int32),
    )
    cfg = InputInfo(
        algorithm=algorithm or DEFAULT_ALGORITHM.get(route, "GCNDIST"), vertices=v,
        layer_string=a.layers, epochs=a.epochs,
        drop_rate=a.drop, precision=a.precision, learn_rate=0.01, weight_decay=1e-4,
        decay_rate=0.97, decay_epoch=max(a.epochs // 2, 1), partitions=a.partitions,
        kernel_tile=a.kernel_tile if route in ("bsp", "blocked") else 0, **ROUTES[route],
    )
    if route == "depcache":
        cfg.rep_threshold = a.rep_threshold
    pin = getattr(a, "tune_pin", "")
    if route == "tune" and pin:  # the twin: the ranks' decision, pinned
        from neutronstarlite_torch.tune.space import Candidate

        for axis, value in Candidate.from_label(pin).as_dict().items():
            if value:
                setattr(cfg, axis, value)
    cls = get_algorithm(cfg.algorithm)
    if route.startswith("resume") and os.environ.get("NTS_DIST_SIMULATE") != "1":
        return _resume(a, cls, cfg, src, dst, datum, device)
    tr = cls.from_arrays(cfg, src, dst, datum, seed=a.seed, device=device)
    if route == "getdep":
        res = tr.run()
        return {"losses": [], "pass": bool(res["pass"]), "fwd_err": res["fwd_err"],
                "bwd_err": res["bwd_err"], "mirrors": tr.mirrors[:, 0].cpu().tolist(),
                "rows": int(tr.mg.vp if tr.group is not None else tr.mg.padded_v),
                "vp": tr.mg.vp, "tables": "UniformMirror"}
    ex = tr.compute_graph
    kind = type(ex).__name__
    if route in ("ell", "bsp", "blocked") or route.startswith("resume"):
        kind = type(next(iter(ex.tables.fwd.values()))).__name__
    chunks = getattr(getattr(ex, "chunk_list", None), "n_chunks", None)
    res = tr.run()
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    out = {"losses": [float(x) for x in tr.loss_history],
           "epoch_s": [float(t) for t in tr.epoch_times], "acc": res["acc"],
           "rows": int(tr.feature.shape[0]), "vp": tr.dist.vp, "tables": kind,
           "chunks": chunks}
    rows = getattr(tr, "tune_rows", None)
    if route == "tune" and rows is not None:
        gauges = tr.metrics.snapshot()["gauges"]
        out.update(decision=gauges["tune.decision"], source=gauges["tune.decision_source"],
                   trials=rows, launches=_launches())
    return out


def _resume(a, cls, cfg, src, dst, datum, device) -> dict:
    """The ranks' side of the ``resume`` route: half the epochs into a
    CHECKPOINT_DIR of this rank's own, then a new trainer to the end."""
    import torch.distributed as dist

    from neutronstarlite_torch.utils.checkpoint import have_checkpoint

    ckpt_dir = os.path.join(os.path.dirname(a.out),
                            f"ckpt-{cfg.ckpt_backend or 'npz'}.{dist.get_rank()}")
    cfg.checkpoint_dir, cfg.checkpoint_every = ckpt_dir, 1
    cfg.epochs = a.epochs // 2
    first = cls.from_arrays(cfg, src, dst, datum, seed=a.seed, device=device)
    first.run()
    filled = have_checkpoint(ckpt_dir, backend=cfg.ckpt_backend)
    cfg.epochs = a.epochs
    second = cls.from_arrays(cfg, src, dst, datum, seed=a.seed, device=device)
    res = second.run()
    return {"losses": [float(x) for x in first.loss_history + second.loss_history],
            "epoch_s": [float(t) for t in first.epoch_times + second.epoch_times],
            "acc": res["acc"], "rows": int(second.feature.shape[0]), "vp": second.dist.vp,
            "tables": type(next(iter(second.compute_graph.tables.fwd.values()))).__name__,
            "dir_filled": filled, "resumed_at": second._first_epoch_trained,
            "epochs_run": len(second.loss_history), "final_loss": float(res["loss"])}


def _launches() -> dict:
    """The hand-written kernels' launch counts in this process."""
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    return {"ell_level": int(ell_level_aggregate.launches),
            "bsp_ell": int(bsp_aggregate.launches)}


def _exchange(a, group, device):
    """The pipelined ring's exchange alone on a seeded x: {"fwd", "bwd",
    "fwd_bf16"} as lists of this rank's rows (all rows in the twin)."""
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ring_blocked import RingBlockedPair, ring_apply

    src, dst = _graph(a)
    d = DistGraph.build(build_graph(src, dst, a.vertices), a.partitions)
    ranks = range(a.partitions) if group is None else [group.rank]
    pair = RingBlockedPair.build(d, min(d.vp, 128), ranks, device=device)
    rng = np.random.default_rng(a.seed + 1)
    x = torch.from_numpy(rng.standard_normal((a.partitions * d.vp, 13), dtype=np.float32))
    if group is not None:
        x = x[group.rank * d.vp:(group.rank + 1) * d.vp]
    x = x.to(device)
    out = {"fwd": ring_apply(pair.fwd, x, group), "bwd": ring_apply(pair.bwd, x, group),
           "fwd_bf16": ring_apply(pair.fwd, x, group, torch.bfloat16)}
    return {k: v.cpu().numpy().tolist() for k, v in out.items()}


def _rank_main(a) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from neutronstarlite_torch.parallel import mesh

    if a.edge_chunk > 0:
        os.environ["NTS_EDGE_CHUNK"] = str(a.edge_chunk)
    device = mesh.maybe_init_process_group("cpu" if a.device == "cpu" else None)
    try:
        curves = {route: _train(a, route, device) for route in a.routes.split(",")}
        if a.exchange_check:
            curves["exchange"] = _exchange(a, mesh.ProcessGroup(), device)
        with open(f"{a.out}.{dist.get_rank()}", "w") as fh:
            json.dump(curves, fh)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    a = _args(argv)
    if "RANK" in os.environ:
        return _rank_main(a)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "curves")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env.pop("NTS_DIST_SIMULATE", None)
        if "tune" in [r.partition(":")[0] for r in a.routes.split(",")]:
            env.update(NTS_TUNE="measure", NTS_TUNE_DIR=os.path.join(tmp, "tune"))
        argv = sys.argv[1:] if argv is None else list(argv)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
             str(a.partitions), "--master_addr", "127.0.0.1", "--master_port",
             str(_free_port()), "-m", "neutronstarlite_torch.tools.dist_parity", *argv,
             "--out", out],
            env=env, capture_output=True, text=True, timeout=a.timeout,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return 1
        ranks = []
        for r in range(a.partitions):
            with open(f"{out}.{r}") as fh:
                ranks.append(json.load(fh))
    import torch

    torch.set_num_threads(1)
    os.environ["NTS_DIST_SIMULATE"] = "1"
    report, ok = {"partitions": a.partitions, "device": a.device, "routes": {}}, True
    for route in a.routes.split(","):
        if route == "tune":
            decisions = sorted({r[route]["decision"] for r in ranks})
            a.tune_pin = decisions[0]
        twin = _train(a, route, "cpu" if a.device == "cpu" else None)
        if route.partition(":")[0] == "getdep":
            want = np.asarray(twin["mirrors"], dtype=np.float32).reshape(a.partitions, -1)
            bitwise = all(np.array_equal(np.asarray(r[route]["mirrors"], dtype=np.float32),
                                         want[i]) for i, r in enumerate(ranks))
            route_ok = twin["pass"] and bitwise and all(r[route]["pass"] for r in ranks)
            ok = ok and route_ok
            report["routes"][route] = {
                "ok": route_ok, "exchange_bitwise": bitwise, "max_loss_gap": 0.0,
                "rank0": {k: v for k, v in ranks[0][route].items() if k != "mirrors"},
                "twin": {k: v for k, v in twin.items() if k != "mirrors"},
                "fwd_err": max(r[route]["fwd_err"] for r in ranks),
                "bwd_err": max(r[route]["bwd_err"] for r in ranks),
            }
            continue
        ref = np.asarray(twin["losses"])
        gap = max(float(np.abs(np.asarray(r[route]["losses"]) - ref).max()) for r in ranks)
        tol = a.atol + a.rtol * float(np.abs(ref).max())
        same_rows = all(r[route]["rows"] == twin["vp"] for r in ranks)
        route_ok = gap <= tol and same_rows and all(
            r[route]["tables"] == twin["tables"] for r in ranks)
        entry = {}
        if route.startswith("resume"):
            # rank 0 alone wrote; every rank resumed at the same epoch and
            # finished with the same loss and accuracies
            entry = {"dir_filled": [r[route]["dir_filled"] for r in ranks],
                     "resumed_at": [r[route]["resumed_at"] for r in ranks],
                     "epochs_run": [r[route]["epochs_run"] for r in ranks],
                     "final_loss": [r[route]["final_loss"] for r in ranks],
                     "acc": [r[route]["acc"] for r in ranks]}
            route_ok = (route_ok and entry["dir_filled"] == [True] + [False] * (a.partitions - 1)
                        and len(set(entry["resumed_at"])) == 1
                        and entry["resumed_at"][0] == a.epochs // 2)
        if route == "tune":
            # every rank decided the same tuple, over a space holding all_gather
            agree = len(decisions) == 1
            labels = [row["candidate"] for row in ranks[0][route]["trials"]]
            entry = {"decisions": [r[route]["decision"] for r in ranks], "agree": agree,
                     "all_gather_trialled": any(
                         lab.startswith("all_gather|") and row["source"] == "measured"
                         for lab, row in zip(labels, ranks[0][route]["trials"])),
                     "rank_trials": [r[route]["trials"] for r in ranks]}
            route_ok = route_ok and agree and entry["all_gather_trialled"]
        ok = ok and route_ok
        report["routes"][route] = {
            "ok": route_ok, "max_loss_gap": gap, "tol": tol,
            "rank0": ranks[0][route], "twin": twin, **entry,
        }
    if a.exchange_check:
        twin = _exchange(a, None, "cpu" if a.device == "cpu" else "cuda")
        rows = len(twin["fwd"]) // a.partitions
        check = {}
        for k, full in twin.items():
            want = np.asarray(full, dtype=np.float32)
            got = np.concatenate([np.asarray(r["exchange"][k], dtype=np.float32)
                                  for r in ranks])
            check[k] = {"bitwise": bool(np.array_equal(got, want)),
                        "max_abs_diff": float(np.abs(got - want).max()), "rows": rows}
        report["exchange"] = check
        ok = ok and all(c["bitwise"] for c in check.values())
    report["ok"] = ok
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
