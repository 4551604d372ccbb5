"""Serving load generator: closed/open-loop SLO measurement — port of
``neutronstarlite_tpu/tools/serve_bench.py``.

``python -m neutronstarlite_torch.tools.serve_bench <cfg> [<ckpt_dir>]
[--train] [--mode closed|open] [--clients C | --rps R] [--requests N]
[--replicas N] [--cb 0|1] [--delta-rate R [--delta-edges K]] [--device cpu]``
or ``... serve_bench --targets host:port,... [--v-num V] [--trace]``

Drives the in-process serving stack (serve/server.py — or the
multi-replica fleet, serve/fleet.py, with ``--replicas N``) on the CUDA
card (``--device cpu``: the CPU) and reports tail latency + throughput
**from the obs records**: the serving run writes its typed JSONL
stream(s) (serve_request / batch_flush / shed / serve_summary; one stream
per replica in fleet mode) under NTS_METRICS_DIR (a temp dir when unset),
and the percentiles printed here are read back from those streams'
mergeable ``hist`` records (``obs/hist.latest_hists``: the fleet p99 is
the merge of the replicas' histograms, not an average).

Two load models:
- **closed** (default): C concurrent clients, each submits its next
  request only after the previous completes — measures capacity at a
  fixed concurrency (the classic closed-loop knee).
- **open**: requests arrive at a fixed rate R regardless of completions —
  measures behavior under offered load, including the shedding path once
  R exceeds capacity.

``--replicas N`` serves through a ReplicaSet (SLO-routed, supervised);
``--cb 0|1`` pins continuous batching (SERVE_CB) for the run;
``--delta-rate R`` applies R live graph-delta batches per second
(``--delta-edges`` random novel edge inserts each, the previous batch
removed) DURING the load — the "predictions track a live graph" leg. Each
delta rebuilds the host graph (serve/delta.plan_delta sorts the whole edge
list), so R must stay below what the host keeps up with; a delta that
fails to apply stops the deltas (logged) while the load finishes.

``--train`` first runs the cfg's training loop (with CHECKPOINT_DIR set
to the serving checkpoint dir) when no checkpoint exists yet — the
zero-to-serving path for smoke configs.

Prints ONE JSON line:
  {"metric": "serve_p99_latency_ms", "value": ..., "unit": "ms",
   "vs_baseline": null, "extra": {p50/p95/p99, throughput, sheds, ...}}

When ``NTS_LEDGER_DIR`` is set, one ``kind=serve`` row (p50/p95/p99,
shed rate, replica count, delta rate and deltas applied — keyed by cfg
fingerprint + load shape + the PRE-delta graph digest) is appended to the
cross-run perf ledger.

``--targets host:port,...`` drives already-running replica PROCESSES
(serve/crosshost, e.g. the children of tools/serve_router) through the
cross-host router instead of building an in-process server; cfg and ckpt
are unused, ``--v-num`` is the seed-id space, and the latency comes from
the router's merged fleet histograms (the replicas' side), with the
clients' own submit -> answer p50/p95/p99 beside it (``client_*_ms``: the
router and the wire included). Its ``kind=serve`` ledger row is
keyed ``targets{N}``. ``--trace`` (targets mode) then merges the router's
and the replicas' span streams (tools/trace_timeline's ``--fleet`` join;
``--trace-dirs`` names them, default NTS_METRICS_DIR) and reports the
complete-chain fraction and the router overhead's p50/p95/p99 (client
latency minus the replica's summed stage time per traced request); the
replicas must run with NTS_TRACE on.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict

import numpy as np

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve_bench")


def ensure_checkpoint(cfg, base_dir: str, ckpt_dir: str, train: bool, device=None) -> None:
    """Train the cfg's toolkit into ``ckpt_dir`` when empty and --train."""
    from neutronstarlite_torch.utils.checkpoint import have_checkpoint

    if have_checkpoint(ckpt_dir):
        return
    if not train:
        raise SystemExit(
            f"no checkpoint under {ckpt_dir!r}; pass --train to train one "
            "from the cfg first"
        )
    from neutronstarlite_torch.models import get_algorithm

    log.info("no checkpoint under %s; training %d epochs first",
             ckpt_dir, cfg.epochs)
    prev = os.environ.get("NTS_SAMPLE_WORKERS")
    os.environ.setdefault("NTS_SAMPLE_WORKERS", "0")
    try:
        toolkit = get_algorithm(cfg.algorithm)(cfg, base_dir=base_dir, device=device)
        toolkit.init_graph()
        toolkit.init_nn()
        toolkit.run()
    finally:
        if prev is None:
            os.environ.pop("NTS_SAMPLE_WORKERS", None)


def run_closed_loop(server, v_num: int, n_requests: int, clients: int,
                    seeds_per_request: int, seed: int, done=None) -> int:
    """C clients, each with one request outstanding; returns error count.
    ``done`` (a list), when given, receives every request submitted."""
    counter = {"next": 0, "errors": 0}
    lock = threading.Lock()

    def client(idx: int) -> None:
        rng = np.random.default_rng(seed + 1000 + idx)
        while True:
            with lock:
                if counter["next"] >= n_requests:
                    return
                counter["next"] += 1
            req = server.submit(rng.integers(0, v_num, seeds_per_request))
            if done is not None:
                done.append(req)
            try:
                req.result(timeout=120.0)
            except Exception:
                with lock:
                    counter["errors"] += 1

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(max(clients, 1))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return counter["errors"]


def run_open_loop(server, v_num: int, n_requests: int, rps: float,
                  seeds_per_request: int, seed: int, done=None, stop=None) -> int:
    """Fixed arrival rate; sheds count as completed-with-error. ``stop`` (a
    threading.Event), when given, ends the arrivals once set instead of
    after ``n_requests``; ``done`` (a list) receives every request."""
    rng = np.random.default_rng(seed + 2000)
    interval = 1.0 / max(rps, 1e-6)
    pending = []
    t_next = time.perf_counter()
    while (not stop.is_set()) if stop is not None else len(pending) < n_requests:
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)
        t_next += interval
        pending.append(
            server.submit(rng.integers(0, v_num, seeds_per_request))
        )
        if done is not None:
            done.append(pending[-1])
    errors = 0
    for req in pending:
        try:
            req.result(timeout=120.0)
        except Exception:
            errors += 1
    return errors


def percentiles_from_streams(paths) -> Dict[str, Any]:
    """The SLO numbers read back from one or many serving obs streams
    (fleet mode: one stream per replica + the front door): every record
    validated, quantiles from the streams' merged ``hist`` records (a
    rotated ``<path>.1`` chunk is read first, so counts cover the whole
    run), sheds and batches counted off the typed records."""
    from neutronstarlite_torch.obs import schema
    from neutronstarlite_torch.obs.hist import latest_hists

    events = []
    for path in paths:
        rotated = path + ".1"
        chunks = [rotated, path] if os.path.exists(rotated) else [path]
        for chunk in chunks:
            with open(chunk, "r", encoding="utf-8") as fh:
                for raw in fh:
                    raw = raw.strip()
                    if not raw:
                        continue
                    obj = json.loads(raw)
                    schema.validate_event(obj)
                    events.append(obj)
    reqs = [e for e in events if e["event"] == "serve_request"]
    served = [
        e for e in reqs
        if e["status"] != "shed" and e.get("total_ms") is not None
    ]
    ts = [e["ts"] for e in served]
    summary = None
    for e in events:
        if e["event"] == "serve_summary":
            summary = e
    flushes = [e for e in events if e["event"] == "batch_flush"]
    out: Dict[str, Any] = {
        "served": len(served),
        "shed": sum(1 for e in reqs if e["status"] == "shed"),
        "batches": len(flushes),
        "mean_flush_requests": (
            sum(e["n_requests"] for e in flushes) / len(flushes) if flushes else None
        ),
        "summary": summary,
    }
    h = latest_hists(events).get("serve.latency_ms")
    if h is not None and h.count:
        out["latency_ms"] = h.quantiles()
        out["latency_source"] = "hist"
        out["served"] = max(out["served"], h.count)
    else:
        out["latency_ms"] = {"p50": None, "p95": None, "p99": None}
        out["latency_source"] = None
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    out["throughput_rps"] = len(ts) / span if span > 0 else None
    return out


def run_delta_loop(target, rate: float, edges_per_delta: int, seed: int,
                   stop: threading.Event, counts: Dict[str, int]) -> None:
    """Apply live graph-delta batches at ``rate``/s while the load runs:
    each batch inserts ``edges_per_delta`` random NOVEL edges and removes
    the previous batch's — the graph keeps changing, its size stays
    bounded, and the base graph is never damaged. Novelty matters:
    removal drops EVERY occurrence of a listed pair, so a random insert
    that collided with a pre-existing edge would take the original down
    with it on the next round — candidates are filtered against the
    current edge set. ``target`` is an InferenceServer or ReplicaSet (both
    expose apply_delta). ``counts["applied"]`` counts the deltas applied
    and ``counts["seconds"]`` their summed apply seconds."""
    from neutronstarlite_torch.serve.delta import GraphDelta, _edge_keys

    rng = np.random.default_rng(seed + 31337)
    interval = 1.0 / max(rate, 1e-6)
    last: list = []
    while not stop.wait(interval):
        g = target.engine.sampler.graph
        v = g.v_num
        existing = set(_edge_keys(
            g.row_indices.astype(np.int64), g.dst_of_edge.astype(np.int64)
        ).tolist())
        add: list = []
        chosen = set()
        for _ in range(20 * max(edges_per_delta, 1)):  # bounded tries
            if len(add) >= max(edges_per_delta, 1):
                break
            u, w = int(rng.integers(0, v)), int(rng.integers(0, v))
            key = (u << 32) | w
            if key in existing or key in chosen:
                continue
            chosen.add(key)
            add.append((u, w))
        if not add:
            continue
        t0 = time.perf_counter()
        try:
            target.apply_delta(GraphDelta.edges(add=add, remove=last))
        except Exception as e:  # the load must finish; deltas are the leg
            log.warning("delta application failed (%s); stopping deltas", e)
            return
        counts["seconds"] = counts.get("seconds", 0.0) + time.perf_counter() - t0
        last = add
        counts["applied"] += 1


def measure(engine, options=None, replicas: int = 1, mode: str = "closed",
            clients: int = 4, rps: float = 200.0, requests: int = 200,
            seeds_per_request: int = 1, seed: int = 0, delta_rate: float = 0.0,
            delta_edges: int = 4) -> Dict[str, Any]:
    """Serve one load over a built engine: an InferenceServer (or a
    ``replicas``-replica ReplicaSet) with ``options`` (default: the
    engine's), the closed or open load model, with ``delta_rate`` live
    graph deltas per second during it, then the numbers read back from the
    run's streams — the ``extra`` dict of the JSON line."""
    from neutronstarlite_torch.serve.fleet import ReplicaSet
    from neutronstarlite_torch.serve.server import InferenceServer

    opts = options or engine.opts
    if replicas > 1:
        server = ReplicaSet.from_engine(engine, replicas, options=opts, seed=seed)
        stream_paths = server.stream_paths()
    else:
        server = InferenceServer(engine, options=opts)
        stream_paths = [engine.metrics.path] if engine.metrics.path else []
    v_num = engine.toolkit.host_graph.v_num
    # the PRE-delta digest is the run's workload identity (the ledger key):
    # the count of deltas applied depends on wall-clock timing
    initial_digest = engine.graph_digest()
    delta_stop = threading.Event()
    delta_counts: Dict[str, Any] = {"applied": 0, "seconds": 0.0}
    delta_thread = None
    if delta_rate > 0:
        delta_thread = threading.Thread(
            target=run_delta_loop,
            args=(server, delta_rate, delta_edges, seed, delta_stop, delta_counts),
            daemon=True,
        )
        delta_thread.start()
    t0 = time.perf_counter()
    try:
        if mode == "closed":
            errors = run_closed_loop(server, v_num, requests, clients, seeds_per_request, seed)
        else:
            errors = run_open_loop(server, v_num, requests, rps, seeds_per_request, seed)
    finally:
        delta_stop.set()
        if delta_thread is not None:
            delta_thread.join(timeout=120.0)
    wall_s = time.perf_counter() - t0
    stats = server.close()
    if replicas > 1:
        # normalize the fleet stats onto the single-server report shape:
        # the bucket ladder is SHARED across replicas (clone warm start), so
        # r0's compile counts are the fleet's; cache stats sum
        per = stats.get("per_replica") or {}
        first = per.get("r0") or {}
        stats["compile_counts"] = first.get("compile_counts", {})
        agg: Dict[str, int] = {}
        for s in per.values():
            for k, v in (s.get("cache") or {}).items():
                agg[k] = agg.get(k, 0) + int(v)
        stats["cache"] = agg

    stream_paths = [p for p in stream_paths if p and os.path.exists(p)]
    if stream_paths:
        obs_view = percentiles_from_streams(stream_paths)
    else:  # metrics dir unusable: fall back to the in-memory view
        obs_view = {
            "served": stats["requests"], "shed": stats["shed"],
            "batches": None, "mean_flush_requests": None,
            "latency_ms": stats["latency_ms"], "latency_source": "memory",
            "throughput_rps": stats["throughput_rps"], "summary": None,
        }
    lat = obs_view["latency_ms"]
    # the serving-side sampling-pipeline telemetry (SAMPLE_PIPELINE:
    # pipelined/device): queue depth + residual stall ride the
    # serve_summary record's registry snapshot
    summary = obs_view.get("summary") or {}
    s_counters = summary.get("counters") or {}
    s_gauges = summary.get("gauges") or {}
    return {
        "mode": mode,
        "clients": clients if mode == "closed" else None,
        "rps_offered": rps if mode == "open" else None,
        "requests": requests,
        "seeds_per_request": seeds_per_request,
        "p50_ms": lat["p50"],
        "p95_ms": lat["p95"],
        "p99_ms": lat["p99"],
        "throughput_rps": obs_view["throughput_rps"],
        "latency_source": obs_view.get("latency_source"),
        "served": obs_view["served"],
        "shed": obs_view["shed"],
        "errors": errors,
        "batches": obs_view["batches"],
        "mean_flush_requests": obs_view["mean_flush_requests"],
        "compile_counts": {
            str(k): v for k, v in stats["compile_counts"].items()
        },
        "cache": stats["cache"],
        "sample_pipeline": opts.sample_pipeline,
        "sample_queue_depth": s_gauges.get("sample.queue_depth"),
        "sample_stall_ms": s_counters.get("sample.stall_ms"),
        "continuous_batching": opts.continuous_batching,
        "replicas": replicas,
        "fleet_shed": stats.get("fleet_shed"),
        "restarts": stats.get("restarts"),
        "delta_rate": delta_rate,
        "deltas_applied": delta_counts["applied"],
        "delta_apply_s": delta_counts["seconds"],
        "initial_graph_digest": initial_digest,
        # the graph digest the run ENDED on (deltas bump it)
        "graph_digest": engine.graph_digest(),
        "device": str(engine.device),
        "wall_s": wall_s,
        "metrics_stream": stream_paths[0] if stream_paths else None,
    }


def client_latency_ms(requests) -> Dict[str, Any]:
    """p50/p95/p99 of submit -> answer over the answered requests, in ms:
    what a client of the router sees (the fleet histograms are the
    replicas' own, without the router and the wire)."""
    ms = [1e3 * (r.t_done - r.t_submit) for r in requests
          if r.error is None and r.t_done is not None]
    if not ms:
        return {"p50": None, "p95": None, "p99": None}
    q = np.percentile(np.asarray(ms), [50, 95, 99])
    return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2])}


def _run_targets_mode(args) -> int:
    """Drive already-running replica processes through the cross-host
    router (serve/crosshost): the same load loops over the same front door
    (``submit()`` -> future), the latency from the router's merged fleet
    histograms (the exact bucket-addition view)."""
    from neutronstarlite_torch.serve.crosshost import CrossHostFleet

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    if args.trace and not os.environ.get("NTS_METRICS_DIR"):
        # the router's span stream must land somewhere readable: the
        # post-run merge joins it with the replicas' streams by trace_id
        os.environ["NTS_METRICS_DIR"] = tempfile.mkdtemp(
            prefix="nts_serve_bench_trace_"
        )
    fleet = CrossHostFleet.from_targets(targets)
    done: list = []
    t0 = time.perf_counter()
    try:
        if args.mode == "closed":
            errors = run_closed_loop(
                fleet, args.v_num, args.requests, args.clients,
                args.seeds_per_request, args.seed, done=done,
            )
        else:
            errors = run_open_loop(
                fleet, args.v_num, args.requests, args.rps,
                args.seeds_per_request, args.seed, done=done,
            )
        wall_s = time.perf_counter() - t0
    finally:
        stats = fleet.close()
    client = client_latency_ms(done)
    trace_view: Dict[str, Any] = {}
    if args.trace:
        # merge the router's and the replicas' span streams (all processes
        # share NTS_METRICS_DIR, or pass --trace-dirs) and derive each
        # request's chain as trace_timeline --fleet does
        from neutronstarlite_torch.tools.metrics_report import (
            expand_paths,
            load_events,
        )
        from neutronstarlite_torch.tools.trace_timeline import (
            request_tracing_report,
        )

        dirs = (args.trace_dirs or
                [os.environ.get("NTS_METRICS_DIR", "")])
        merged = []
        for p in expand_paths([d for d in dirs if d]):
            try:
                merged.extend(load_events(p))
            except OSError as e:
                log.warning("serve_bench --trace: cannot read %s (%s)", p, e)
        rep = request_tracing_report(merged)
        if rep is None:
            log.warning("serve_bench --trace: no request traces found "
                        "(is NTS_TRACE on in the replicas?)")
        else:
            trace_view = {
                "trace_complete_frac": rep["complete_frac"],
                "trace_chains": rep["n_traces"],
                "router_overhead_p50_ms": rep["router_overhead_p50_ms"],
                "router_overhead_p95_ms": rep["router_overhead_p95_ms"],
                "router_overhead_p99_ms": rep["router_overhead_p99_ms"],
            }
    lat = stats["latency_ms"]
    served = stats["requests"]
    throughput = served / wall_s if wall_s > 0 else None
    result = {
        "metric": "serve_p99_latency_ms",
        "value": lat.get("p99"),
        "unit": "ms",
        "vs_baseline": None,
        "extra": {
            "mode": args.mode,
            "clients": args.clients if args.mode == "closed" else None,
            "rps_offered": args.rps if args.mode == "open" else None,
            "requests": args.requests,
            "seeds_per_request": args.seeds_per_request,
            "p50_ms": lat.get("p50"),
            "p95_ms": lat.get("p95"),
            "p99_ms": lat.get("p99"),
            "client_p50_ms": client["p50"],
            "client_p95_ms": client["p95"],
            "client_p99_ms": client["p99"],
            "throughput_rps": throughput,
            "latency_source": "fleet_hist",
            "served": served,
            "shed": stats["shed"],
            "errors": errors,
            "restarts": stats["restarts"],
            "targets": targets,
            "replicas": stats["replicas"],
            "targets_lost": stats["targets_lost"],
            "wall_s": wall_s,
            **trace_view,
        },
    }
    # one kind=serve row (NTS_LEDGER_DIR): targets-mode runs share the
    # serve trajectory keyed by the target count; with --trace the row
    # carries router_overhead_* and trace_complete_frac
    from neutronstarlite_torch.obs import ledger

    if ledger.ledger_dir():
        shed = stats["shed"]
        total = served + shed
        ledger.append_row(ledger.serve_row(
            latency_ms=lat,
            shed_rate=(shed / total) if total > 0 else None,
            throughput_rps=throughput,
            requests=args.requests,
            cfg_fingerprint=f"targets{len(targets)}",
            graph_digest=None,
            mode=args.mode,
            replicas=stats["replicas"],
            continuous_batching=False,
            extra={
                "clients": args.clients if args.mode == "closed" else None,
                "rps_offered": args.rps if args.mode == "open" else None,
                **trace_view,
            },
        ))
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m neutronstarlite_torch.tools.serve_bench",
        description="closed/open-loop serving benchmark over the serve/ "
        "stack; prints one JSON line"
    )
    ap.add_argument("cfg", nargs="?", default="",
                    help="cfg file (unused in --targets mode)")
    ap.add_argument("ckpt", nargs="?", default="",
                    help="checkpoint dir (default: cfg CHECKPOINT_DIR, "
                    "or a temp dir with --train)")
    ap.add_argument("--train", action="store_true",
                    help="train the cfg first when no checkpoint exists")
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--clients", type=int, default=4,
                    help="closed-loop concurrency")
    ap.add_argument("--rps", type=float, default=200.0,
                    help="open-loop arrival rate")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seeds-per-request", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=None,
                    help="serve through an N-replica ReplicaSet "
                    "(default: cfg SERVE_REPLICAS / NTS_SERVE_REPLICAS)")
    ap.add_argument("--route", choices=("least_burn", "round_robin"),
                    default=None, help="fleet routing policy override")
    ap.add_argument("--cb", choices=("0", "1"), default=None,
                    help="pin continuous batching (SERVE_CB) for the run")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="serving (and --train) device (default: the CUDA "
                    "card; raises when there is none)")
    ap.add_argument("--delta-rate", type=float, default=0.0,
                    help="apply this many live graph-delta batches per "
                    "second during the load (0 = frozen graph)")
    ap.add_argument("--delta-edges", type=int, default=4,
                    help="edge inserts per delta batch (the previous "
                    "batch is removed)")
    ap.add_argument("--targets", default=None,
                    help="drive a cross-host fleet (serve/crosshost) at "
                    "these replica addresses instead of an in-process "
                    "server; cfg/ckpt are ignored")
    ap.add_argument("--v-num", type=int, default=2708,
                    help="seed-id space for --targets mode (the remote "
                    "graph is not introspectable)")
    ap.add_argument("--trace", action="store_true",
                    help="targets mode: after the load, merge the router's "
                    "and the replicas' span streams (trace_timeline --fleet "
                    "join) and report the complete-chain fraction and the "
                    "router overhead's p50/p95/p99 (needs NTS_TRACE on in "
                    "the replicas)")
    ap.add_argument("--trace-dirs", nargs="+", default=None,
                    help="metrics dirs/files holding the fleet's span "
                    "streams (default: NTS_METRICS_DIR)")
    args = ap.parse_args(argv)
    if args.targets:
        return _run_targets_mode(args)
    if not args.cfg:
        ap.error("cfg is required without --targets")
    if args.cb is not None:
        os.environ["NTS_SERVE_CB"] = args.cb
    if args.route is not None:
        os.environ["NTS_SERVE_ROUTE"] = args.route

    from neutronstarlite_torch.utils.config import InputInfo

    cfg = InputInfo.read_from_cfg_file(args.cfg)
    base_dir = os.path.dirname(os.path.abspath(args.cfg))
    scratch = None
    ckpt_dir = args.ckpt or cfg.checkpoint_dir
    if not ckpt_dir:
        if not args.train:
            raise SystemExit(
                "no checkpoint dir: pass one, set CHECKPOINT_DIR in the "
                "cfg, or use --train"
            )
        scratch = tempfile.mkdtemp(prefix="nts_serve_bench_")
        ckpt_dir = os.path.join(scratch, "ckpt")
    cfg.checkpoint_dir = ckpt_dir
    if not os.environ.get("NTS_METRICS_DIR"):
        # the SLO numbers below are read back from this stream
        os.environ["NTS_METRICS_DIR"] = (
            scratch or tempfile.mkdtemp(prefix="nts_serve_bench_")
        )

    ensure_checkpoint(cfg, base_dir, ckpt_dir, args.train, device=args.device)

    from neutronstarlite_torch.serve.engine import (
        InferenceEngine,
        ServeSetupError,
    )
    from neutronstarlite_torch.serve.fleet import FleetOptions

    try:
        engine = InferenceEngine.from_config(
            cfg, base_dir=base_dir, ckpt_dir=ckpt_dir,
            rng=np.random.default_rng(args.seed), device=args.device,
        )
    except ServeSetupError as e:
        raise SystemExit(f"serve_bench: {e}")

    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    replicas = (
        args.replicas if args.replicas is not None
        else FleetOptions.from_cfg(cfg).replicas
    )
    extra = measure(
        engine, replicas=replicas, mode=args.mode, clients=args.clients,
        rps=args.rps, requests=args.requests,
        seeds_per_request=args.seeds_per_request, seed=args.seed,
        delta_rate=args.delta_rate, delta_edges=args.delta_edges,
    )
    extra["warmup_compile_s"] = warmup_s
    result = {
        "metric": "serve_p99_latency_ms",
        "value": extra["p99_ms"],
        "unit": "ms",
        "vs_baseline": None,
        "extra": extra,
    }
    # one kind=serve row into the cross-run perf ledger (NTS_LEDGER_DIR);
    # the key embeds mode/replicas/CB, so load shapes never mix
    from neutronstarlite_torch.obs import config_fingerprint, ledger

    if ledger.ledger_dir():
        total = extra["served"] + extra["shed"]
        ledger.append_row(ledger.serve_row(
            latency_ms={q: extra[f"{q}_ms"] for q in ("p50", "p95", "p99")},
            shed_rate=(extra["shed"] / total) if total > 0 else None,
            throughput_rps=extra["throughput_rps"],
            requests=args.requests,
            cfg_fingerprint=config_fingerprint(cfg),
            graph_digest=extra["initial_graph_digest"],
            mode=args.mode,
            replicas=replicas,
            continuous_batching=extra["continuous_batching"],
            delta_rate=args.delta_rate,
            deltas_applied=extra["deltas_applied"],
            extra={
                "clients": args.clients if args.mode == "closed" else None,
                "rps_offered": args.rps if args.mode == "open" else None,
            },
        ))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
