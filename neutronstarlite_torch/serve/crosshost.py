"""Cross-host serve fabric: process-level replicas behind an HTTP router —
port of ``neutronstarlite_tpu/serve/crosshost.py``.

serve/fleet.py's ``ReplicaSet`` runs N replicas as threads of one process;
this module runs them as separate PROCESSES, each killable on its own, with
a router that treats a dying replica as routine. Both halves:

**The replica child** (``python -m neutronstarlite_torch.serve.crosshost
<cfg> <ckpt> [--device cpu] ...``) is a long-running serve process: one
:class:`~neutronstarlite_torch.serve.engine.InferenceEngine` restored from a
digest-verified checkpoint, its bucket ladder captured (one CUDA graph per
bucket on the card), behind an
:class:`~neutronstarlite_torch.serve.server.InferenceServer` whose exporter
port carries both planes: the scrape surfaces (/metrics /healthz /slo
/telemetry) and ``POST /predict`` (obs/exporter.bind_predict). It runs on
the CUDA card unless ``--device cpu`` asks for the CPU; without a card and
without that flag it exits 2 with a message. A CUDA graph cannot be
persisted, so every child, each respawn included, reads the graph, restores
the checkpoint and captures its buckets anew; it times each part (import,
CUDA init, graph build, model, restore, captures), logs the split and
publishes it with ``{"port", "pid", "replica", "ckpt_step"}`` in its
``--port-file`` (written atomically once serving). SIGTERM drains it and
writes its ``serve_summary``.

**The router** (:class:`CrossHostFleet`, CLI: tools/serve_router) discovers
replicas from ``NTS_FLEET_TARGETS`` (routing and telemetry only) or spawns
N children itself (full supervision, with each child's
:class:`LaunchRecipe`). It routes with serve/fleet's ``choose_replica``
over state scraped from one ``/telemetry`` fetch per replica per poll
(obs/httpc, the shared retrying client): liveness from the health payload,
queue depth from the gauges, drain and burn from the ``slo_status``
records, the fleet p99 from the native-bucket ``hist`` records merged by
the exact bucket-addition law. The poll engine is obs/hub's
``TelemetryHub``, so miss-K ``target_loss`` latching, frozen histograms,
``recovery action=target_rejoin`` and ``kind=fleet`` ledger rows come with
it. The fleet sheds (``fleet_breach``) only when every live replica
breaches; a refused or timed-out POST re-routes to the next live replica.

**Supervised process restart**: a spawned replica that misses ``miss_k``
consecutive polls (``target_loss``) is respawned from its recipe, its
telemetry target re-pointed at the new port, and a ``recovery
action=restart`` record written. Targets-mode fleets (no recipe) keep the
loss and serve on the survivors.

**Rolling model rollout**: ``rollout(ckpt_dir)``
1. preflights the candidate (tools/verify_checkpoint.preflight_checkpoint:
   manifest and sha256 digests of the newest step; a corrupt candidate is
   refused with no replica restarted),
2. canary-gates it: the router builds the candidate and the serving model
   side by side on the replicas' device (one rng seed, one call order, so
   both draw the same neighbourhoods; in the fused mode the draw key comes
   from that generator) and scores mirrored traffic; the relative-RMS
   disagreement must stay within ``NTS_CANARY_TOL`` (a ``model_drift``
   record with ``source="canary"`` carries it). Both engines are freed
   after the verdict,
3. then drains and restarts replicas one at a time (the fleet keeps
   answering): mark expected-down (the hub sees the frozen last-good
   snapshot, so an intentional restart burns no misses), wait out the
   in-flight requests, SIGTERM, respawn on the new checkpoint, wait for
   the port file, resume routing.
A failed canary refuses before any restart; a replica death mid-rollout or
``close()`` aborts and rolls updated replicas back. One ``rollout`` record
per call carries the verdict (promoted | preflight_reject | canary_reject |
aborted | refused).

The wire format is the reference's: a child of either package answers a
router of either package.

Knobs: ``NTS_FLEET_TARGETS`` (comma-separated host:port or URLs),
``NTS_CANARY_TOL`` (default 0.05), ``NTS_CANARY_SEEDS`` (mirror batches,
default 8), ``NTS_ROUTER_WORKERS`` (dispatch threads, default 8),
``NTS_HTTPC_*`` (the shared client), the hub's ``NTS_HUB_MISS_K`` and
serve/fleet's ``NTS_SERVE_ROUTE*``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import queue as queue_mod
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from neutronstarlite_torch.obs import httpc, registry as obs_registry
from neutronstarlite_torch.obs.hub import TelemetryHub
from neutronstarlite_torch.obs.trace import TraceContext, Tracer
from neutronstarlite_torch.serve.batcher import RequestShedError, ServeRequest
from neutronstarlite_torch.serve.fleet import (
    FleetOptions,
    choose_replica,
)
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")

DEFAULT_CANARY_TOL = 0.05
DEFAULT_CANARY_SEEDS = 8
DEFAULT_POLL_S = 0.5
DEFAULT_PREDICT_TIMEOUT_S = 60.0
# every start is cold (import, CUDA init, graph build, restore, one capture
# per bucket): a 0.1-scale Reddit child took 13.9-25.0 s on an H100, three
# at once or under load (PERF.md)
DEFAULT_SPAWN_TIMEOUT_S = 90.0
DEFAULT_DRAIN_TIMEOUT_S = 30.0


# ---- knobs ------------------------------------------------------------------


def fleet_targets() -> List[str]:
    """``NTS_FLEET_TARGETS``: comma-separated replica addresses, each
    ``host:port`` or a full base URL (one port per replica: it carries
    /predict and every scrape surface)."""
    raw = os.environ.get("NTS_FLEET_TARGETS", "")
    return [t.strip() for t in raw.split(",") if t.strip()]


def canary_tol() -> float:
    """``NTS_CANARY_TOL``: max relative-RMS logit disagreement between the
    candidate and the serving model on mirrored traffic."""
    raw = os.environ.get("NTS_CANARY_TOL", "")
    if not raw:
        return DEFAULT_CANARY_TOL
    try:
        return max(float(raw), 0.0)
    except ValueError:
        log.warning("bad NTS_CANARY_TOL=%r; using %g", raw, DEFAULT_CANARY_TOL)
        return DEFAULT_CANARY_TOL


def _env_int(name: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(int(raw), lo)
    except ValueError:
        log.warning("bad %s=%r; using %d", name, raw, default)
        return default


def normalize_base(target: str) -> str:
    """``host:port`` / URL -> base URL with no trailing slash or path."""
    t = target.strip().rstrip("/")
    if not t.startswith("http://") and not t.startswith("https://"):
        t = f"http://{t}"
    return t


def _metric_sheddable(metric: str) -> bool:
    """Whether an ``slo_status.metric`` name is a sheddable objective: the
    serve/queue-latency-quantile rule obs/slo applies when it parses
    NTS_SLO_SPEC, applied to the scraped verdict."""
    from neutronstarlite_torch.obs import slo as slo_mod

    m = slo_mod._QUANTILE_RE.fullmatch(metric)
    if not m:
        return False
    entry = slo_mod._QUANTILE_METRICS.get(m.group("base"))
    return bool(entry and entry[1])


# ---------------------------------------------------------------------------
# the replica child process
# ---------------------------------------------------------------------------


def _write_port_file(path: str, payload: Dict[str, Any]) -> None:
    """Atomic publish (tmp + rename): a reader never sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def predict_handler(server, replica: str,
                    predict_timeout_s: float = DEFAULT_PREDICT_TIMEOUT_S):
    """The ``POST /predict`` handler of a replica (obs/exporter.bind_predict):
    ``{"node_ids": [...]}`` is served through ``server`` (micro-batched,
    cache-fronted, ``ctx`` parenting its spans into the caller's trace);
    ``{"node_ids": [...], "replay_seed": s}`` is the deterministic replay
    probe. The answer is the reference's: ``values`` (float32 as JSON
    numbers, exact), ``dtype``, ``ckpt_step``, ``replica`` and ``req_id``
    or ``replay``; 400 for bad ids, 503 shed, 504 timeout, 500 error."""
    engine = server.engine
    reg = server.metrics

    def _predict(payload: Dict[str, Any],
                 ctx=None) -> Tuple[int, Dict[str, Any]]:
        ids = payload.get("node_ids")
        if not isinstance(ids, list) or not ids or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in ids
        ):
            return 400, {"error": "node_ids must be a non-empty list of "
                                  "ints"}
        node_ids = np.asarray(ids, dtype=np.int64)
        replay = payload.get("replay_seed")
        if replay is not None:
            # deterministic replay probe (the bitwise oracle): pin the
            # sampler's generator for exactly this prediction, then restore
            # it. Every draw of every mode comes from that generator (the
            # fused and device modes take their key from it), and the graph
            # gate keeps flushes from drawing meanwhile
            with server._graph_gate:
                gen = engine.sampler.rng
                saved = gen.bit_generator.state
                gen.bit_generator.state = np.random.default_rng(
                    int(replay)
                ).bit_generator.state
                try:
                    vals = engine.predict(node_ids)
                finally:
                    gen.bit_generator.state = saved
            return 200, {"status": "ok", "values": vals.tolist(),
                         "dtype": str(vals.dtype), "replay": True,
                         "ckpt_step": engine.ckpt_step,
                         "replica": replica}
        req = server.submit(node_ids, ctx=ctx)
        if reg is not None:
            reg.gauge_set("serve.queue_depth", server.batcher.depth)
        try:
            vals = req.result(timeout=predict_timeout_s)
        except RequestShedError as e:
            return 503, {"status": "shed", "error": str(e),
                         "replica": replica}
        except TimeoutError as e:
            return 504, {"status": "timeout", "error": str(e),
                         "replica": replica}
        except Exception as e:
            return 500, {"status": "error", "error": str(e),
                         "replica": replica}
        finally:
            if reg is not None:
                reg.gauge_set("serve.queue_depth", server.batcher.depth)
        return 200, {"status": "ok", "values": vals.tolist(),
                     "dtype": str(vals.dtype), "req_id": req.req_id,
                     "ckpt_step": engine.ckpt_step,
                     "replica": replica}

    return _predict


def child_main(argv=None) -> int:
    """The long-running replica process: serve until SIGTERM/SIGINT."""
    t_main = time.time()
    ap = argparse.ArgumentParser(
        description="cross-host serve replica: load a checkpoint, serve "
        "POST /predict + scrape surfaces on one exporter port until "
        "SIGTERM"
    )
    ap.add_argument("cfg")
    ap.add_argument("ckpt", nargs="?", default="")
    ap.add_argument("--replica", default="r0")
    ap.add_argument("--port-file", default="",
                    help="write {port,pid,replica,...} JSON here once serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--predict-timeout-s", type=float,
                    default=DEFAULT_PREDICT_TIMEOUT_S)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="serving device (default: the CUDA card; exits 2 "
                    "when there is none)")
    args = ap.parse_args(argv)

    # the startup split: spawn -> here is the interpreter and the module
    # imports (torch among them); the launch recipe stamps the spawn time
    startup: Dict[str, Any] = {}
    spawned = os.environ.get("NTS_SPAWN_WALL", "")
    if spawned:
        try:
            startup["import_s"] = max(t_main - float(spawned), 0.0)
        except ValueError:
            pass
    import torch

    t0 = time.perf_counter()
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print(f"serve replica {args.replica}: no CUDA device is visible; "
                  "pass --device cpu to serve on the CPU", file=sys.stderr)
            return 2
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    startup["cuda_init_s"] = time.perf_counter() - t0

    if not os.environ.get("NTS_METRICS_PORT", ""):
        # the exporter IS this process's front door; without it there is
        # nothing to serve on (0 = ephemeral, published via --port-file)
        os.environ["NTS_METRICS_PORT"] = "0"

    from neutronstarlite_torch.serve.engine import InferenceEngine, ServeSetupError
    from neutronstarlite_torch.serve.server import InferenceServer
    from neutronstarlite_torch.utils.config import InputInfo

    cfg = InputInfo.read_from_cfg_file(args.cfg)
    base_dir = os.path.dirname(os.path.abspath(args.cfg))
    try:
        engine = InferenceEngine.from_config(
            cfg, base_dir=base_dir, ckpt_dir=args.ckpt,
            rng=np.random.default_rng(args.seed), device=args.device,
            timings=startup,
        )
    except ServeSetupError as e:
        print(f"serve replica {args.replica}: {e}", file=sys.stderr)
        return 2
    # NTS_STREAM_LOG: follow a shared DeltaLog; the margin must be reserved
    # BEFORE warmup so in-margin appends never touch the ladder
    stream_root = os.environ.get("NTS_STREAM_LOG", "")
    ingestor = None
    if stream_root:
        from neutronstarlite_torch.stream.ingest import StreamIngestor

        ingestor = StreamIngestor([engine], log_root=stream_root)
        ingestor.arm()
    t0 = time.perf_counter()
    engine.warmup()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    startup["capture_s"] = time.perf_counter() - t0
    startup["buckets"] = len(engine.buckets)
    if engine.device.type == "cuda":
        startup["mem_reserved_mib"] = torch.cuda.memory_reserved(engine.device) / 2 ** 20
    server = InferenceServer(engine, replica=args.replica)
    reg = server.metrics
    if reg is not None:
        # the router derives depth/capacity from the scraped gauges:
        # publish the static bound once, the live depth per request
        reg.gauge_set("serve.max_queue", server.opts.max_queue)
        reg.gauge_set("serve.queue_depth", server.batcher.depth)
    exporter = server.exporter
    if exporter is None:
        print(f"serve replica {args.replica}: no exporter "
              "(NTS_METRICS_PORT unset/unbindable): nothing to serve on",
              file=sys.stderr)
        server.close()
        return 2

    predict_timeout = max(float(args.predict_timeout_s), 1.0)
    # freshness lineage for the request spans: which delta-log seq (the
    # stream ingestor's applied head; 0 for a static graph) answered
    if ingestor is not None:
        server.graph_seq_source = lambda: ingestor.applied_seq
    else:
        server.graph_seq_source = lambda: 0

    exporter.bind_predict(predict_handler(server, args.replica, predict_timeout))

    stop = threading.Event()

    def _on_signal(_sig, _frm):
        # only the event: the drain and serve_summary run on this thread
        # once stop.wait() returns, never inside a handler that may have
        # interrupted a replay
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    if ingestor is not None:
        # tail the shared log: every replica applies the same committed
        # total order, so the fleet converges on the same per-seq digests
        # without cross-replica coordination
        ingestor.servers = [server]
        poll_s = max(
            float(os.environ.get("NTS_STREAM_POLL_S", "0.5") or 0.5), 0.01
        )

        def _tail():
            while not stop.is_set():
                try:
                    applied = ingestor.consume()
                except Exception:
                    # divergence / corruption is permanent for this
                    # replica: stop applying (stale but consistent serving
                    # beats a silently wrong graph), keep serving
                    log.exception(
                        "replica %s: stream tail failed at seq %d; "
                        "serving freezes on the last applied graph",
                        args.replica, ingestor.applied_seq,
                    )
                    return
                if applied:
                    log.info(
                        "replica %s: applied %d stream entries, head "
                        "seq %d", args.replica, len(applied),
                        ingestor.applied_seq,
                    )
                stop.wait(poll_s)

        threading.Thread(
            target=_tail, name="stream-tail", daemon=True
        ).start()

    if spawned:
        startup["total_s"] = max(time.time() - float(spawned), 0.0)
    log.info(
        "replica %s startup on %s: %s", args.replica, engine.device,
        ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in startup.items()),
    )
    if args.port_file:
        _write_port_file(args.port_file, {
            "port": exporter.port, "pid": os.getpid(),
            "replica": args.replica, "ckpt_step": engine.ckpt_step,
            "device": str(engine.device), "startup": startup,
        })
    log.info("replica %s serving ckpt step %d on port %d (pid %d)",
             args.replica, engine.ckpt_step, exporter.port, os.getpid())
    stop.wait()
    exporter.bind_predict(None)
    server.close()
    return 0


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


# Env the fabric's observability depends on, pinned INTO each recipe at
# spawn: ``LaunchRecipe.env()`` re-reads ``os.environ`` at every respawn, so
# a router whose environment changed between spawn and a supervised restart
# (or a rollout respawn) would hand the new child another tracing config; a
# restarted replica must keep writing spans into its own stream
_TRACE_ENV_KEYS = ("NTS_TRACE", "NTS_METRICS_DIR", "NTS_TRACE_STEP")


def _pin_trace_env(extra_env: Dict[str, str]) -> Dict[str, str]:
    """Snapshot the spawn-time tracing env into ``extra_env`` (explicit
    caller-provided values win)."""
    for key in _TRACE_ENV_KEYS:
        if key not in extra_env and key in os.environ:
            extra_env[key] = os.environ[key]
    return extra_env


@dataclasses.dataclass
class LaunchRecipe:
    """Everything needed to (re)spawn one replica child: the cfg, the
    checkpoint, the replica identity, the device and the env the child
    inherits (``CUDA_VISIBLE_DEVICES``, NTS_METRICS_DIR, the SLO spec)."""

    cfg_path: str
    ckpt_dir: str
    replica: str
    seed: int
    port_file: str
    extra_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    device: Optional[str] = None  # None: the CUDA card

    def argv(self) -> List[str]:
        out = [
            sys.executable, "-m", "neutronstarlite_torch.serve.crosshost",
            self.cfg_path, self.ckpt_dir,
            "--replica", self.replica,
            "--port-file", self.port_file,
            "--seed", str(self.seed),
        ]
        if self.device is not None:
            out += ["--device", self.device]
        return out

    def env(self) -> Dict[str, str]:
        e = dict(os.environ)
        e.update(self.extra_env)
        e["NTS_METRICS_PORT"] = "0"  # ephemeral; published via port_file
        e["NTS_SPAWN_WALL"] = repr(time.time())  # the child's import split
        return e


class _RouterReplica:
    """One routed endpoint: address + (spawn mode) process and recipe."""

    def __init__(self, idx: int, base_url: str = "",
                 recipe: Optional[LaunchRecipe] = None,
                 proc: Optional[subprocess.Popen] = None):
        self.idx = idx
        self.rid = f"r{idx}"
        self.base_url = base_url
        self.recipe = recipe
        self.proc = proc
        self.ckpt_dir = recipe.ckpt_dir if recipe is not None else None
        self.restarts = 0
        self.respawn_failures = 0
        self.expected_down = False  # rollout maintenance window
        self.cached_body: Optional[str] = None  # last good /telemetry
        self.suspect_until = 0.0  # routing cooldown after a failed POST
        self.in_flight = 0
        self.startup: Optional[Dict[str, Any]] = None  # the child's split
        self.restart_s: Optional[float] = None  # the last respawn's seconds

    @property
    def telemetry_url(self) -> str:
        return f"{self.base_url}/telemetry"

    @property
    def predict_url(self) -> str:
        return f"{self.base_url}/predict"


class CrossHostFleet:
    """N replica processes behind one ``submit()``, routed over HTTP."""

    def __init__(self, replicas: List[_RouterReplica], *,
                 options: Optional[FleetOptions] = None,
                 registry=None,
                 ledger_dir: Optional[str] = None,
                 ledger_every: int = 1,
                 poll_s: float = DEFAULT_POLL_S,
                 miss_k: Optional[int] = None,
                 predict_timeout_s: float = DEFAULT_PREDICT_TIMEOUT_S,
                 spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
                 drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
                 fetch: Optional[Callable[[str], str]] = None,
                 start_polling: bool = True,
                 owned_spawn_dir: Optional[str] = None):
        if not replicas:
            raise ValueError("CrossHostFleet needs at least one replica "
                             "(NTS_FLEET_TARGETS or spawn())")
        self.replicas = replicas
        self.options = options or FleetOptions()
        self.registry = registry or obs_registry.open_run("router")
        self._owns_registry = registry is None
        self.tracer = Tracer(self.registry)
        self.predict_timeout_s = float(predict_timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._owned_spawn_dir = owned_spawn_dir  # removed at close()
        self._fetch_impl = fetch  # None -> the shared retrying client
        self._closed = False
        self._lock = threading.Lock()  # replica bookkeeping + sticky
        self._proc_lock = threading.Lock()  # spawn/kill serialization
        self._sticky: Optional[int] = None
        self._rollout_lock = threading.Lock()
        self._rollout_active = False
        # the mirror buffer: recent request seed-id batches, the canary's
        # shadow traffic (a seeded fallback fills in when traffic was thin)
        self._mirror: "collections.deque[List[int]]" = collections.deque(
            maxlen=32
        )
        self.hub = TelemetryHub(
            [r.telemetry_url for r in replicas],
            poll_s=poll_s, miss_k=miss_k, registry=self.registry,
            ledger_dir=ledger_dir, ledger_every=ledger_every,
            fetch=self._fetch,
        )
        self._url_to_idx: Dict[str, int] = {
            t.url: i for i, t in enumerate(self.hub.targets)
        }
        self.registry.gauge_set("fleet.replicas", len(replicas))
        # dispatcher pool: workers re-route owed requests across replicas
        self._dispatch_q: "queue_mod.Queue[Optional[ServeRequest]]" = \
            queue_mod.Queue()
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"router-dispatch-{i}", daemon=True)
            for i in range(_env_int("NTS_ROUTER_WORKERS", 8))
        ]
        for w in self._workers:
            w.start()
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        try:
            self.hub.poll_once()  # routing state before the first request
        except Exception as e:  # pragma: no cover - poll never raises
            log.warning("router: initial poll failed (%s)", e)
        if start_polling:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="router-poll", daemon=True
            )
            self._poll_thread.start()

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_targets(cls, targets: Optional[List[str]] = None,
                     **kw) -> "CrossHostFleet":
        """Discovery mode: route over already-running replicas
        (``NTS_FLEET_TARGETS`` when ``targets`` is None). No launch
        recipes: a dead replica stays a ``target_loss`` and the fleet
        serves on the survivors; rollout() is refused."""
        targets = fleet_targets() if targets is None else targets
        if not targets:
            raise ValueError(
                "no replica targets: set NTS_FLEET_TARGETS "
                "(host:port,host:port,...) or use spawn()"
            )
        reps = [_RouterReplica(i, normalize_base(t))
                for i, t in enumerate(targets)]
        return cls(reps, **kw)

    @classmethod
    def spawn(cls, cfg_path: str, ckpt_dir: str, replicas: int = 3, *,
              spawn_dir: Optional[str] = None, seed: int = 0,
              extra_env: Optional[Dict[str, str]] = None,
              spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
              device: Optional[str] = None,
              **kw) -> "CrossHostFleet":
        """Supervision mode: start N replica children at once (fork and
        exec: this process may already hold a CUDA context), record each
        child's :class:`LaunchRecipe` and wait for every port file.
        Children that fail to come up are killed and the error raised:
        spawn never leaks a process. ``device`` is the children's (None:
        the CUDA card)."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        cfg_path = os.path.abspath(cfg_path)
        ckpt_dir = os.path.abspath(ckpt_dir)
        owns = spawn_dir is None
        spawn_dir = spawn_dir or tempfile.mkdtemp(prefix="nts-crosshost-")
        os.makedirs(spawn_dir, exist_ok=True)
        reps: List[_RouterReplica] = []
        try:
            for i in range(replicas):
                recipe = LaunchRecipe(
                    cfg_path=cfg_path, ckpt_dir=ckpt_dir, replica=f"r{i}",
                    seed=seed + i,
                    port_file=os.path.join(spawn_dir, f"r{i}.port.json"),
                    # pin the spawn-time tracing env into the recipe so a
                    # supervised restart / rollout respawn (which re-reads
                    # os.environ) keeps the child's trace config stable
                    extra_env=_pin_trace_env(dict(extra_env or {})),
                    device=device,
                )
                r = _RouterReplica(i, recipe=recipe)
                r.proc = _spawn_child(recipe)
                reps.append(r)
            deadline = time.monotonic() + spawn_timeout_s
            for r in reps:
                info = _wait_port_file(r.recipe.port_file, r.proc, deadline)
                r.base_url = f"http://127.0.0.1:{info['port']}"
                r.startup = info.get("startup")
        except Exception:
            for r in reps:
                _reap(r.proc)
            if owns:
                shutil.rmtree(spawn_dir, ignore_errors=True)
            raise
        return cls(reps, spawn_timeout_s=spawn_timeout_s,
                   owned_spawn_dir=spawn_dir if owns else None, **kw)

    # ---- telemetry fetch (the hub's injected fetch) ----------------------

    def _fetch(self, url: str) -> str:
        with self._lock:
            idx = self._url_to_idx.get(url)
        if idx is None:  # a stale URL raced a restart: miss, self-heals
            raise httpc.HttpRefused(f"router: unknown target {url}")
        r = self.replicas[idx]
        if r.expected_down and r.cached_body is not None:
            # an INTENTIONAL (rollout) down: the hub keeps seeing the
            # frozen last-good snapshot: no misses, no target_loss, an
            # unbroken merged-histogram trajectory across the restart
            return r.cached_body
        if self._fetch_impl is not None:
            body = self._fetch_impl(url)
        else:
            body = httpc.fetch(url, target=idx,
                               deadline_s=httpc.http_timeout_s() * 2,
                               tracer=self.tracer,
                               span_name="telemetry_poll")
        r.cached_body = body
        return body

    # ---- routing state from scraped records ------------------------------

    def _derive_state(self, r: _RouterReplica, t) -> Dict[str, Any]:
        beating = False
        depth = 0
        max_queue = 64
        draining = False
        burn = 0.0
        tel = None
        records = t.records
        for rec in records:
            if rec.get("event") == "telemetry":
                tel = rec
        if tel is not None:
            health = tel.get("health") or {}
            beating = bool(health.get("ok"))
            serve = health.get("serve") or {}
            if serve.get("beating") is False:
                beating = False
            gauges = tel.get("gauges") or {}
            try:
                depth = int(gauges.get("serve.queue_depth") or 0)
                max_queue = int(gauges.get("serve.max_queue") or max_queue)
            except (TypeError, ValueError):
                pass
        latest: Dict[tuple, Dict[str, Any]] = {}
        for rec in records:
            if rec.get("event") == "slo_status":
                latest[(rec.get("run_id"), rec.get("objective"))] = rec
        for rec in latest.values():
            if not _metric_sheddable(str(rec.get("metric") or "")):
                continue
            try:
                burn = max(burn, float(rec.get("burn_rate") or 0.0))
            except (TypeError, ValueError):
                pass
            if rec.get("state") == "breach":
                draining = True
        if t.lost or r.expected_down or time.monotonic() < r.suspect_until:
            beating = False
        return {"idx": r.idx, "beating": beating, "draining": draining,
                "burn": burn, "depth": depth, "max_queue": max_queue}

    def route_states(self) -> List[Dict[str, Any]]:
        return [self._derive_state(r, t)
                for r, t in zip(self.replicas, self.hub.targets)]

    def _route(self, states) -> Tuple[Optional[int], Optional[str]]:
        with self._lock:
            idx, reason = choose_replica(
                states, self._sticky, self.options.hysteresis
            )
            self._sticky = idx
            return idx, reason

    # ---- the front door --------------------------------------------------

    def submit(self, node_ids) -> ServeRequest:
        """Enqueue one request; the dispatcher routes (and re-routes) it
        over HTTP. Overload/closure rejects with RequestShedError on the
        future; owed requests are otherwise never dropped."""
        req = ServeRequest(np.asarray(node_ids, dtype=np.int64).reshape(-1))
        if self._closed:
            self._shed(req, "fleet_closed")
            return req
        self._dispatch_q.put(req)
        return req

    def predict(self, node_ids,
                timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(node_ids).result(
            timeout if timeout is not None else self.predict_timeout_s + 5.0
        )

    def _shed(self, req: ServeRequest, reason: str, ctx=None) -> None:
        self.registry.counter_add("fleet.sheds", 1.0)
        try:
            if ctx is not None:
                self.tracer.complete("shed", dur_s=0.0, cat="router",
                                     ctx=ctx, req_id=req.req_id,
                                     reason=reason)
            self.registry.event("shed", reason=reason, req_id=req.req_id)
            self.registry.event(
                "serve_request", n_seeds=max(len(req.node_ids), 1),
                status="shed", total_ms=None, req_id=req.req_id,
            )
        except Exception as e:  # telemetry must not break the reply
            log.warning("router: shed record failed (%s)", e)
        req._complete(None, "shed", RequestShedError(reason))

    def _worker_loop(self) -> None:
        while True:
            req = self._dispatch_q.get()
            if req is None:
                return
            try:
                self._dispatch(req)
            except Exception as e:  # a reply must always land
                if not req.done():
                    req._complete(None, "error", e)

    def _dispatch(self, req: ServeRequest) -> None:
        deadline = time.monotonic() + self.predict_timeout_s
        tried: set = set()
        shed_seen = False
        # per-request trace: trace_id = run_id:req_id, so every span this
        # request produces (router-side, httpc's predict_post, and the
        # replica's handler/request/queue spans across the wire) joins on
        # one id in the fleet-merged timeline
        tracing = self.tracer.enabled
        root_id = None
        root_ctx = None
        if tracing:
            trace_id = f"{self.registry.run_id}:{req.req_id}"
            root_id = self.tracer.next_id()
            root_ctx = TraceContext(trace_id, root_id)

        def _root_done(status: str, **extra) -> None:
            if not tracing:
                return
            self.tracer.complete(
                "fleet_request",
                dur_s=time.perf_counter() - req.t_submit,
                t0=req.t_submit, cat="router", span_id=root_id,
                ctx=TraceContext(root_ctx.trace_id, None),
                req_id=req.req_id, status=status,
                n_seeds=len(req.node_ids), **extra,
            )

        while True:
            if self._closed:
                self._shed(req, "fleet_closed", ctx=root_ctx)
                _root_done("shed", reason="fleet_closed")
                return
            states = self.route_states()
            fresh = [s for s in states if s["idx"] not in tried]
            is_reroute = bool(tried)
            t_route = time.perf_counter()
            idx, reason = self._route(fresh if fresh else states)
            if tracing:
                self.tracer.complete(
                    "re_route" if is_reroute else "route_decision",
                    dur_s=time.perf_counter() - t_route, t0=t_route,
                    cat="router", ctx=root_ctx, req_id=req.req_id,
                    target=idx, reason=reason,
                )
            if idx is not None and idx in tried:
                # every replica has already failed this request once;
                # this is a fresh pass (bounded by the deadline)
                tried.clear()
            if idx is None:
                if tried:
                    # the untried subset looks unroutable, but a replica
                    # already tried may have recovered: re-evaluate over
                    # the whole fleet before any shed verdict
                    tried.clear()
                    continue
                if reason and reason.startswith("fleet_breach"):
                    # the SLO contract: all live replicas breaching is the
                    # ONLY load-based fleet-level shed
                    self._shed(req, reason, ctx=root_ctx)
                    _root_done("shed", reason=reason)
                    return
                if time.monotonic() >= deadline:
                    shed_reason = (
                        "replica_queues_full (every live replica shed)"
                        if shed_seen else (reason or "fleet_down")
                    )
                    self._shed(req, shed_reason, ctx=root_ctx)
                    _root_done("shed", reason=shed_reason)
                    return
                nap = min(self.hub.poll_s, 0.2) or 0.05
                time.sleep(nap)
                if tracing:
                    self.tracer.complete(
                        "backoff", dur_s=nap, cat="router", ctx=root_ctx,
                        req_id=req.req_id, reason=reason,
                    )
                tried.clear()
                continue
            r = self.replicas[idx]
            budget = deadline - time.monotonic()
            if budget <= 0:
                self._shed(req, "dispatch_deadline", ctx=root_ctx)
                _root_done("shed", reason="dispatch_deadline")
                return
            with self._lock:
                r.in_flight += 1
            try:
                body = httpc.fetch(
                    r.predict_url,
                    data=json.dumps({
                        "node_ids": [int(i) for i in req.node_ids],
                        "req_id": req.req_id,
                    }).encode("utf-8"),
                    retries=0,  # a POST is not idempotent on a live
                    # replica: re-dispatch is the router's, across replicas
                    timeout_s=min(self.predict_timeout_s, budget),
                    target=idx,
                    tracer=self.tracer, ctx=root_ctx,
                    span_name="predict_post",
                )
            except httpc.HttpStatusError as e:
                with self._lock:
                    r.in_flight -= 1
                if e.status in (503, 429):
                    shed_seen = True  # replica-level shed: route around
                else:
                    log.warning("router: replica %s POST failed (%s)",
                                r.rid, e)
                tried.add(idx)
                continue
            except httpc.HttpError as e:
                with self._lock:
                    r.in_flight -= 1
                # refused/timeout: the replica may be dead; cool it down
                # for a poll and RE-ROUTE the owed request
                cooldown = max(self.hub.poll_s, 0.2)
                r.suspect_until = time.monotonic() + cooldown
                if tracing:
                    self.tracer.complete(
                        "suspect", dur_s=0.0, cat="router", ctx=root_ctx,
                        req_id=req.req_id, target=idx,
                        error=httpc.error_class(e), cooldown_s=cooldown,
                    )
                log.warning("router: replica %s unreachable (%s); "
                            "re-routing %s", r.rid, e, req.req_id)
                tried.add(idx)
                continue
            with self._lock:
                r.in_flight -= 1
            r.suspect_until = 0.0
            try:
                out = json.loads(body)
                vals = np.asarray(out["values"],
                                  dtype=np.dtype(out.get("dtype",
                                                         "float32")))
            except (ValueError, KeyError, TypeError) as e:
                log.warning("router: replica %s returned a bad predict "
                            "payload (%s)", r.rid, e)
                tried.add(idx)
                continue
            self.registry.counter_add("fleet.requests", 1.0)
            self._mirror.append([int(i) for i in req.node_ids])
            req._complete(vals, "ok")
            _root_done("ok", target=idx,
                       replica_req_id=str(out.get("req_id") or ""))
            return

    # ---- polling + supervision -------------------------------------------

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.hub.poll_s):
            if self._closed:
                return
            try:
                self.hub.poll_once()
            except Exception as e:  # pragma: no cover - poll never raises
                log.warning("router: poll failed (%s)", e)
            try:
                self._supervise()
            except Exception as e:
                log.warning("router: supervision pass failed (%s)", e)

    def _supervise(self) -> None:
        """Escalate the hub's miss-K verdicts: a LOST spawned replica is
        respawned from its recipe (recovery action=restart); targets-mode
        losses stay target_loss-only."""
        if self._rollout_active or self._closed:
            return
        for r, t in zip(self.replicas, self.hub.targets):
            if not t.lost or r.expected_down or r.recipe is None:
                continue
            if r.respawn_failures >= 3:
                continue  # gave up on this one; the record trail says so
            self._restart_replica(r, reason="target_loss")

    def _restart_replica(self, r: _RouterReplica, reason: str) -> bool:
        """Supervised process restart from the recorded launch recipe."""
        t_restart = time.perf_counter()
        old_url = r.base_url
        with self._lock:
            owed = r.in_flight
        recipe = dataclasses.replace(
            r.recipe, ckpt_dir=r.ckpt_dir or r.recipe.ckpt_dir
        )
        try:
            with self._proc_lock:
                if self._closed:
                    return False
                _reap(r.proc)
                r.proc = None
                if os.path.exists(recipe.port_file):
                    os.remove(recipe.port_file)
                r.proc = _spawn_child(recipe)
            info = _wait_port_file(
                recipe.port_file, r.proc,
                time.monotonic() + self.spawn_timeout_s,
            )
        except Exception as e:
            r.respawn_failures += 1
            log.warning("router: respawn of %s failed (%s): attempt %d",
                        r.rid, e, r.respawn_failures)
            with self._proc_lock:
                _reap(r.proc)
                r.proc = None
            if self.tracer.enabled:
                self.tracer.complete(
                    "restart_replica",
                    dur_s=time.perf_counter() - t_restart, t0=t_restart,
                    cat="fleet", replica=r.rid, reason=reason,
                    error=str(e)[:200],
                )
            return False
        r.respawn_failures = 0
        r.restarts += 1
        r.recipe = recipe
        r.startup = info.get("startup")
        r.restart_s = time.perf_counter() - t_restart
        self._repoint(r, f"http://127.0.0.1:{info['port']}")
        if self.tracer.enabled:
            self.tracer.complete(
                "restart_replica",
                dur_s=time.perf_counter() - t_restart, t0=t_restart,
                cat="fleet", replica=r.rid, reason=reason,
                restarts=r.restarts,
            )
        self.registry.counter_add("fleet.restarts", 1.0)
        self.registry.event(
            "recovery", action="restart", replica=r.rid,
            target=old_url or None, reason=reason,
            attempt=r.restarts, owed_requests=int(owed),
            pid=int(info.get("pid") or 0), seconds=r.restart_s,
        )
        log.warning(
            "router: replica %s restarted supervised (%s; %d owed "
            "request(s) re-routing) in %.1f s", r.rid, reason, owed,
            r.restart_s,
        )
        return True

    def _repoint(self, r: _RouterReplica, base_url: str) -> None:
        """Re-point the replica (and its hub target) at a new port."""
        t = self.hub.targets[r.idx]
        with self._lock:
            self._url_to_idx.pop(t.url, None)
            r.base_url = base_url
            r.suspect_until = 0.0
            t.url = r.telemetry_url
            self._url_to_idx[t.url] = r.idx

    # ---- rolling model rollout -------------------------------------------

    def rollout(self, ckpt_dir: str) -> Dict[str, Any]:
        """Preflight -> canary gate -> one-at-a-time drain/restart.
        Returns (and emits, exactly once) the typed ``rollout`` record's
        fields; never raises: every failure mode is a verdict."""
        t0 = time.monotonic()
        ckpt_dir = os.path.abspath(ckpt_dir)
        with self._rollout_lock:
            if self._rollout_active:
                return self._emit_rollout(
                    ckpt_dir, "refused", t0=t0,
                    error="rollout already in progress",
                )
            self._rollout_active = True
        try:
            # the traced rollout chain: preflight / canary / roll_one spans
            # auto-parent under this root (same thread: the tracer's
            # thread-local span stack)
            with self.tracer.span("rollout", cat="rollout",
                                  ckpt_dir=ckpt_dir):
                return self._rollout_impl(ckpt_dir, t0)
        finally:
            self._rollout_active = False

    def _rollout_impl(self, ckpt_dir: str, t0: float) -> Dict[str, Any]:
        from neutronstarlite_torch.tools.verify_checkpoint import (
            PreflightError,
            preflight_checkpoint,
        )

        if self._closed:
            return self._emit_rollout(ckpt_dir, "refused", t0=t0,
                                      error="fleet closed")
        if any(r.recipe is None for r in self.replicas):
            return self._emit_rollout(
                ckpt_dir, "refused", t0=t0,
                error="no launch recipe (targets-mode fleet: the router "
                      "cannot restart replicas it did not spawn)",
            )
        # 1. preflight: the digest-verified gate; a corrupt candidate is
        # refused before any replica is touched
        t_pf = time.perf_counter()
        try:
            _step_dir, step = preflight_checkpoint(ckpt_dir)
        except PreflightError as e:
            detail = "; ".join(e.problems[:3])
            self.tracer.complete(
                "rollout_preflight", dur_s=time.perf_counter() - t_pf,
                t0=t_pf, cat="rollout", ok=False,
            )
            return self._emit_rollout(
                ckpt_dir, "preflight_reject", t0=t0,
                error=f"{e}" + (f" [{detail}]" if detail else ""),
            )
        self.tracer.complete(
            "rollout_preflight", dur_s=time.perf_counter() - t_pf,
            t0=t_pf, cat="rollout", ok=True, ckpt_step=step,
        )
        # 2. canary gate: shadow-eval mirrored traffic, promote only
        # inside NTS_CANARY_TOL
        t_cn = time.perf_counter()
        try:
            canary = self._canary(ckpt_dir)
        except Exception as e:
            self.tracer.complete(
                "rollout_canary", dur_s=time.perf_counter() - t_cn,
                t0=t_cn, cat="rollout", ok=False,
            )
            return self._emit_rollout(
                ckpt_dir, "canary_reject", t0=t0, ckpt_step=step,
                error=f"canary evaluation failed: {e}",
            )
        self.tracer.complete(
            "rollout_canary", dur_s=time.perf_counter() - t_cn, t0=t_cn,
            cat="rollout", ok=bool(canary.get("passed")),
        )
        if not canary.get("passed"):
            return self._emit_rollout(
                ckpt_dir, "canary_reject", t0=t0, ckpt_step=step,
                canary=canary,
                error=(f"canary disagreement {canary['disagreement']:g} "
                       f"exceeds NTS_CANARY_TOL={canary['tolerance']:g}"),
            )
        # 3. sequential drain/restart: the fleet keeps answering
        prev_ckpt = {r.idx: (r.ckpt_dir or r.recipe.ckpt_dir)
                     for r in self.replicas}
        updated: List[_RouterReplica] = []
        for r in self.replicas:
            abort = self._abort_reason(r)
            if abort is None and not self._roll_one(r, ckpt_dir):
                abort = f"replica {r.rid} failed to come back on the " \
                        f"candidate checkpoint"
            if abort is not None:
                rolled_back = self._rollback(updated, prev_ckpt)
                return self._emit_rollout(
                    ckpt_dir, "aborted", t0=t0, ckpt_step=step,
                    canary=canary, error=abort,
                    restarted=len(updated) - rolled_back,
                    rolled_back=rolled_back,
                )
            updated.append(r)
        return self._emit_rollout(
            ckpt_dir, "promoted", t0=t0, ckpt_step=step, canary=canary,
            restarted=len(updated),
        )

    def _abort_reason(self, current: _RouterReplica) -> Optional[str]:
        if self._closed:
            return "fleet closed mid-rollout"
        for other, t in zip(self.replicas, self.hub.targets):
            if other is current or other.expected_down:
                continue
            if t.lost:
                return (f"replica {other.rid} died mid-rollout "
                        "(target_loss)")
        return None

    def _roll_one(self, r: _RouterReplica, ckpt_dir: str) -> bool:
        """Drain one replica, restart it on the candidate checkpoint."""
        with self.tracer.span("roll_one", cat="rollout",
                              replica=r.rid) as h:
            ok = self._roll_one_impl(r, ckpt_dir)
            h.attrs["ok"] = ok
            return ok

    def _roll_one_impl(self, r: _RouterReplica, ckpt_dir: str) -> bool:
        r.expected_down = True  # no NEW routing; the hub sees the frozen
        # last-good snapshot (continuous merged view, zero misses)
        drain_deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < drain_deadline:
            with self._lock:
                if r.in_flight == 0:
                    break
            time.sleep(0.02)
        recipe = dataclasses.replace(r.recipe, ckpt_dir=ckpt_dir)
        try:
            with self._proc_lock:
                if self._closed:
                    r.expected_down = False
                    return False
                _terminate(r.proc)
                r.proc = None
                if os.path.exists(recipe.port_file):
                    os.remove(recipe.port_file)
                r.proc = _spawn_child(recipe)
            info = _wait_port_file(
                recipe.port_file, r.proc,
                time.monotonic() + self.spawn_timeout_s,
            )
        except Exception as e:
            log.warning("router: rollout respawn of %s failed (%s)",
                        r.rid, e)
            with self._proc_lock:
                _reap(r.proc)
                r.proc = None
            r.expected_down = False
            return False
        r.recipe = recipe
        r.ckpt_dir = ckpt_dir
        r.startup = info.get("startup")
        self._repoint(r, f"http://127.0.0.1:{info['port']}")
        self.registry.counter_add("fleet.rollout_restarts", 1.0)
        t = self.hub.targets[r.idx]
        t.missed = 0  # a maintenance window is not a liveness miss
        r.expected_down = False
        return True

    def _rollback(self, updated: List[_RouterReplica],
                  prev_ckpt: Dict[int, str]) -> int:
        """Return already-updated replicas to their pre-rollout checkpoint;
        counts successes. Skipped when the fleet is closing (close() reaps
        everything anyway)."""
        if self._closed:
            return 0
        rolled = 0
        for r in reversed(updated):
            old_ckpt = prev_ckpt.get(r.idx)
            if old_ckpt and self._roll_one(r, old_ckpt):
                rolled += 1
        return rolled

    def _canary(self, ckpt_dir: str) -> Dict[str, Any]:
        """Shadow-eval the candidate against the serving model on mirrored
        traffic, on the replicas' device. Both engines are built over one
        toolkit (one graph build) with the SAME rng seed and consume it in
        the SAME call order, so they sample identical neighbourhoods: the
        disagreement is the models' (relative Frobenius RMS; exactly 0.0
        for identical parameters). On the card their replays take the
        process-wide replay lock one at a time, and both engines (their
        graph and captures) are freed after the verdict, so the router
        keeps no model on the card."""
        from neutronstarlite_torch.resilience import events
        from neutronstarlite_torch.serve.engine import InferenceEngine
        from neutronstarlite_torch.utils.config import InputInfo

        recipe = self.replicas[0].recipe
        current = self.replicas[0].ckpt_dir or recipe.ckpt_dir
        cfg = InputInfo.read_from_cfg_file(recipe.cfg_path)
        base_dir = os.path.dirname(os.path.abspath(recipe.cfg_path))
        tol = canary_tol()
        n_batches = _env_int("NTS_CANARY_SEEDS", DEFAULT_CANARY_SEEDS)
        prev_sink = events.get_sink()  # engine construction installs its
        # registry as the process fault sink; the router's must survive
        engines: List[Any] = []
        try:
            try:
                engines.append(InferenceEngine.from_config(
                    cfg, base_dir=base_dir, ckpt_dir=current,
                    rng=np.random.default_rng(0xCA9A), device=recipe.device,
                ))
                # the candidate over the same toolkit (graph, features,
                # tables): an engine serves a copy of the weights it restored
                engines.append(InferenceEngine(
                    engines[0].toolkit, ckpt_dir, options=engines[0].opts,
                    rng=np.random.default_rng(0xCA9A),
                ))
            finally:
                events.set_sink(prev_sink)
            eng_old, eng_new = engines
            batches = [list(b) for b in self._mirror][-n_batches:]
            if len(batches) < n_batches:
                v_num = eng_old.toolkit.host_graph.v_num
                rng = np.random.default_rng(0xCA9A)
                batches += [
                    rng.integers(0, v_num, size=4).tolist()
                    for _ in range(n_batches - len(batches))
                ]
            worst = 0.0
            for ids in batches:
                a = eng_old.predict(np.asarray(ids, dtype=np.int64))
                b = eng_new.predict(np.asarray(ids, dtype=np.int64))
                denom = float(np.linalg.norm(a)) or 1.0
                worst = max(worst, float(np.linalg.norm(
                    b.astype(np.float64) - a.astype(np.float64)
                )) / denom)
        finally:
            events.set_sink(prev_sink)
            cuda = any(e.device.type == "cuda" for e in engines)
            for reg in {id(e.metrics): e.metrics for e in engines}.values():
                if reg is not None:
                    reg.close()
            engines.clear()
            eng_old = eng_new = None
            gc.collect()
            if cuda:
                import torch

                torch.cuda.empty_cache()
        canary = {
            "disagreement": worst,
            "tolerance": tol,
            "seeds": sum(len(b) for b in batches),
            "batches": len(batches),
            "mirrored": bool(self._mirror),
            "passed": worst <= tol,
        }
        # the drift auditor as promotion gate: the same record kind with a
        # canary source, rendered by the report natively
        try:
            self.registry.event(
                "model_drift", metric="canary_logit_rms",
                source="canary", predicted=0.0, observed=worst,
                drift=worst, threshold=tol,
                candidate=ckpt_dir, family="serve/rollout",
            )
        except Exception as e:
            log.warning("router: canary model_drift record failed (%s)", e)
        return canary

    def _emit_rollout(self, ckpt_dir: str, verdict: str, *,
                      t0: float, ckpt_step: Optional[int] = None,
                      canary: Optional[Dict[str, Any]] = None,
                      restarted: int = 0, rolled_back: int = 0,
                      error: Optional[str] = None) -> Dict[str, Any]:
        fields = {
            "ckpt_dir": ckpt_dir,
            "verdict": verdict,
            "ckpt_step": ckpt_step,
            "replicas": len(self.replicas),
            "restarted": int(max(restarted, 0)),
            "rolled_back": int(max(rolled_back, 0)),
            "canary": canary,
            "seconds": round(time.monotonic() - t0, 3),
            "error": error,
        }
        self.registry.counter_add("fleet.rollouts", 1.0)
        self.registry.gauge_set(
            "fleet.rollout_promoted", 1.0 if verdict == "promoted" else 0.0
        )
        try:
            self.registry.event("rollout", **fields)
        except Exception as e:
            log.warning("router: rollout record failed (%s)", e)
        (log.info if verdict == "promoted" else log.warning)(
            "rollout %s: %s (restarted %d/%d%s)", verdict, ckpt_dir,
            fields["restarted"], len(self.replicas),
            f"; {error}" if error else "",
        )
        return fields

    # ---- stats + lifecycle -----------------------------------------------

    def stats(self) -> Dict[str, Any]:
        snap = self.registry.snapshot(include_hists=False)
        merged = self.hub.merged_hists()
        lat = merged.get("serve.latency_ms")
        return {
            "replicas": len(self.replicas),
            "requests": int(snap["counters"].get("fleet.requests", 0)),
            "shed": int(snap["counters"].get("fleet.sheds", 0)),
            "restarts": int(snap["counters"].get("fleet.restarts", 0)),
            "rollouts": int(snap["counters"].get("fleet.rollouts", 0)),
            "latency_ms": (lat.quantiles() if lat is not None and lat.count
                           else {"p50": None, "p95": None, "p99": None}),
            "targets_lost": sum(1 for t in self.hub.targets if t.lost),
        }

    def close(self) -> Dict[str, Any]:
        """Stop dispatch, reap every child, close the merged stream:
        idempotent, never leaks a process or a port file, never drops an
        owed request silently (undispatched requests complete as
        fleet_closed sheds)."""
        with self._lock:
            if self._closed:
                return self.stats()
            self._closed = True
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10.0)
        for _ in self._workers:
            self._dispatch_q.put(None)
        for w in self._workers:
            w.join(timeout=10.0)
        while True:  # requests still queued behind the sentinels
            try:
                req = self._dispatch_q.get_nowait()
            except queue_mod.Empty:
                break
            if req is not None and not req.done():
                self._shed(req, "fleet_closed")
        with self._proc_lock:
            for r in self.replicas:
                _terminate(r.proc)
                r.proc = None
                if r.recipe is not None and os.path.exists(r.recipe.port_file):
                    os.remove(r.recipe.port_file)
            if self._owned_spawn_dir:
                shutil.rmtree(self._owned_spawn_dir, ignore_errors=True)
        s = self.stats()
        try:
            merged = self.hub.merged_hists()
            lat = s["latency_ms"]
            self.registry.emit_hists()
            snap = self.registry.snapshot(include_hists=False)
            self.registry.event(
                "serve_summary", requests=s["requests"], shed=s["shed"],
                latency_ms={"p50": lat.get("p50"), "p95": lat.get("p95"),
                            "p99": lat.get("p99")},
                throughput_rps=None, counters=snap["counters"],
                gauges=snap["gauges"], fleet=True, crosshost=True,
                hist_counts={n: h.count for n, h in merged.items()},
            )
        except Exception as e:
            log.warning("router: close-time serve_summary failed (%s)", e)
        if self._owns_registry:
            self.registry.close()
        return s


# ---- child process plumbing -------------------------------------------------


def _spawn_child(recipe: LaunchRecipe) -> subprocess.Popen:
    log.info("spawning replica %s (ckpt %s, device %s)", recipe.replica,
             recipe.ckpt_dir, recipe.device or "cuda")
    return subprocess.Popen(recipe.argv(), env=recipe.env())


def _wait_port_file(path: str, proc: subprocess.Popen,
                    deadline: float) -> Dict[str, Any]:
    """Poll for the child's atomic port-file publish; raises on child
    death or timeout (the caller reaps)."""
    while time.monotonic() < deadline:
        if os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    info = json.load(fh)
                if isinstance(info, dict) and info.get("port"):
                    return info
            except (OSError, ValueError):
                pass  # racing the atomic rename; retry
        rc = proc.poll()
        if rc is not None:
            raise RuntimeError(
                f"replica child exited rc={rc} before publishing "
                f"{path}"
            )
        time.sleep(0.05)
    raise TimeoutError(f"replica child did not publish {path} in time")


def _terminate(proc: Optional[subprocess.Popen],
               grace_s: float = 15.0) -> None:
    """SIGTERM with a grace window, then SIGKILL; always reaps."""
    if proc is None or proc.poll() is not None:
        if proc is not None:
            proc.wait()
        return
    try:
        proc.terminate()
    except OSError:
        pass
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        _reap(proc)


def _reap(proc: Optional[subprocess.Popen]) -> None:
    """SIGKILL + wait; safe on dead/None procs."""
    if proc is None:
        return
    if proc.poll() is None:
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=10.0)
    except subprocess.TimeoutExpired:  # pragma: no cover
        log.warning("router: child pid %s did not reap", proc.pid)


if __name__ == "__main__":
    raise SystemExit(child_main())
