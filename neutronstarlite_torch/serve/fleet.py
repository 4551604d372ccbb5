"""Serve fleet: SLO-routed replicas behind one submit() front door — port
of ``neutronstarlite_tpu/serve/fleet.py``.

One ``InferenceServer`` is a single engine over a frozen graph; the gap
to "heavy traffic from millions of users" is fleet shape. A
:class:`ReplicaSet` runs N replicas in one process — each an
``InferenceServer`` over an ``InferenceEngine.clone()`` that shares the
checkpoint-restored params, the feature slab, the device hop-sampler
table, and the bucket ladder (the captured CUDA graphs, each behind its
own lock), so replica N+1 starts with zero builds — behind a single
``submit()``.

**Routing** consumes each replica's live telemetry IN PROCESS — the same
state the exporter (obs/exporter.py) serves over HTTP (`/slo` burn verdicts,
`/healthz` liveness, queue depth), read without a scrape because the
router is co-located:

- ``least_burn`` (default): score = worst sheddable SLO burn +
  queue-depth fraction; the lowest-scored healthy replica wins, with
  HYSTERESIS — the previous choice is kept until a rival beats it by
  more than ``NTS_SERVE_ROUTE_HYST`` — so equal replicas don't flap the
  route every request.
- **Drain-on-breach**: a replica whose sheddable SLO objective is in
  breach receives no NEW requests (it drains and recovers) as long as
  any healthy replica remains.
- **Fleet-level shed only when ALL replicas breach**: the front door
  rejects (``fleet_breach`` shed record + RequestShedError) only when no
  replica can reasonably take the request — one breaching replica never
  costs a request, it just routes around.
- ``round_robin``: the policy-free baseline (still skips dead/draining).

**Supervision** reuses the heartbeat pattern of resilience/elastic.py
verbatim: a monitor thread feeds one ``LivenessMonitor`` beat per
replica per tick (typed ``heartbeat`` records, replica index =
partition); a replica whose flusher/executor thread died misses beats,
trips a typed ``rank_loss`` record at ``NTS_HEARTBEAT_MISS_K``, and is
restarted SUPERVISED: a fresh ``InferenceServer`` over the same warm
engine clone (zero builds), a typed ``recovery action=restart``
record, and every request the dead replica still owed — batcher-pending
and prepared-but-unexecuted — is re-routed to a live replica, not
dropped (latency honestly keeps the original ``t_submit``).

Live graph deltas (``apply_delta``): one plan, every replica's engine
swapped under its graph gate, per-replica cache invalidation and records
(serve/delta.py). The cross-host hub's per-replica telemetry targets come
with the cross-host serving slice.

Telemetry: each replica owns its own MetricsRegistry (stream file,
histograms, SLO engine) labeled ``r0..rN-1``; the exporter merges them
under one port with ``replica="rK"`` labels (obs/exporter.py), and the
fleet itself owns a registry for the front-door records (heartbeats,
rank_loss, restarts, fleet sheds) plus the consolidated close-time
``serve_summary`` whose latency quantiles MERGE the replicas' histograms
(obs/hist merge law — the fleet p99 is exact, not an average of
averages).

Knobs: SERVE_REPLICAS/NTS_SERVE_REPLICAS, SERVE_ROUTE/NTS_SERVE_ROUTE
(least_burn | round_robin), NTS_SERVE_ROUTE_HYST, NTS_SERVE_HEARTBEAT_S,
NTS_HEARTBEAT_MISS_K (shared with elastic), SERVE_CB/NTS_SERVE_CB
(continuous batching, serve/batcher.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from neutronstarlite_torch.serve.batcher import (
    RequestShedError,
    ServeOptions,
    ServeRequest,
)
from neutronstarlite_torch.serve.engine import InferenceEngine
from neutronstarlite_torch.serve.server import InferenceServer
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")

_ROUTES = ("least_burn", "round_robin")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %g", name, raw, default)
        return default


@dataclasses.dataclass
class FleetOptions:
    """Fleet-shape knobs (the ServeOptions pattern: cfg key + env)."""

    replicas: int = 1  # SERVE_REPLICAS / NTS_SERVE_REPLICAS
    route: str = "least_burn"  # SERVE_ROUTE / NTS_SERVE_ROUTE
    hysteresis: float = 0.25  # NTS_SERVE_ROUTE_HYST: score margin a rival
    # must beat the sticky choice by before the route moves
    heartbeat_s: float = 0.5  # NTS_SERVE_HEARTBEAT_S: monitor tick (0=off)

    @classmethod
    def from_cfg(cls, cfg: Any = None) -> "FleetOptions":
        o = cls()
        if cfg is not None:
            o.replicas = int(getattr(cfg, "serve_replicas", o.replicas))
            o.route = str(getattr(cfg, "serve_route", "") or o.route)
        raw = os.environ.get("NTS_SERVE_REPLICAS", "")
        if raw:
            try:
                o.replicas = int(raw)
            except ValueError:
                log.warning("NTS_SERVE_REPLICAS=%r is not an int; keeping %d",
                            raw, o.replicas)
        o.route = os.environ.get("NTS_SERVE_ROUTE", "") or o.route
        o.hysteresis = _env_float("NTS_SERVE_ROUTE_HYST", o.hysteresis)
        o.heartbeat_s = _env_float("NTS_SERVE_HEARTBEAT_S", o.heartbeat_s)
        if o.replicas < 1:
            raise ValueError(f"SERVE_REPLICAS must be >= 1, got {o.replicas}")
        if o.route not in _ROUTES:
            raise ValueError(
                f"SERVE_ROUTE must be one of {'|'.join(_ROUTES)}, "
                f"got {o.route!r}"
            )
        if o.hysteresis < 0:
            o.hysteresis = 0.0
        return o


def classify_states(
    states: Sequence[Dict[str, Any]]
) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """(healthy states, shed reason): the live/healthy split BOTH
    routing policies share — dead replicas never route, draining
    (SLO-breaching) ones drain, and the fleet-level shed reason exists
    ONLY when no healthy replica remains."""
    live = [s for s in states if s.get("beating")]
    if not live:
        return [], "fleet_down (no live replica)"
    healthy = [s for s in live if not s.get("draining")]
    if not healthy:
        # fleet-level shed ONLY here: every live replica is breaching
        return [], (
            f"fleet_breach (all {len(live)} live replica(s) breaching "
            "their SLO)"
        )
    return healthy, None


def choose_replica(states: Sequence[Dict[str, Any]],
                   sticky: Optional[int] = None,
                   hysteresis: float = 0.25) -> Tuple[Optional[int],
                                                      Optional[str]]:
    """The least-burn routing decision, pure (unit-testable).

    ``states``: per replica {idx, beating, draining, burn, depth,
    max_queue}. Returns (replica index, None) or (None, shed reason).
    Score = burn + depth/max_queue (both lower-is-better, burn dominates
    once an SLO is in trouble); the sticky previous choice is kept
    unless a rival's score beats it by more than ``hysteresis`` — equal
    replicas therefore do not flap the route."""
    healthy, reason = classify_states(states)
    if not healthy:
        return None, reason

    def score(s: Dict[str, Any]) -> float:
        return (s.get("burn") or 0.0) + (
            s.get("depth", 0) / max(s.get("max_queue", 1), 1)
        )

    best = min(healthy, key=score)
    if sticky is not None:
        st = next((s for s in healthy if s["idx"] == sticky), None)
        if st is not None and score(st) <= score(best) + hysteresis:
            return st["idx"], None
    return best["idx"], None


class Replica:
    """One fleet member: server + its labeled registry + identity."""

    def __init__(self, rid: str, idx: int, engine: InferenceEngine,
                 server: InferenceServer):
        self.rid = rid
        self.idx = idx
        self.engine = engine
        self.server = server
        self.restarts = 0
        # served/shed counts carried across supervised restarts: a fresh
        # InferenceServer starts at zero, but the replica's history —
        # and the fleet serve_summary, whose merged histogram spans the
        # whole registry — must not forget the dead incarnation's work
        self.carried_requests = 0
        self.carried_shed = 0
        # set by the chaos hook (ReplicaSet.inject_replica_death) in the
        # same critical section as the abort: no request routes to a
        # replica between its injected death and its flusher's exit
        self.killed = False

    def requests_total(self) -> int:
        return self.carried_requests + self.server.request_count

    def shed_total(self) -> int:
        return self.carried_shed + self.server.batcher.shed_count

    @property
    def registry(self):
        return self.server.metrics

    def beating(self) -> bool:
        return not self.killed and self.server.beating()

    def route_state(self) -> Dict[str, Any]:
        """The router's per-replica view — the same facts the exporter
        serves at /slo + /healthz, consumed in-process."""
        draining, burn = False, 0.0
        slo = self.server.slo
        if slo is not None:
            slo.tick()  # rate-limited internally
            draining, burn = slo.route_state()
        return {
            "idx": self.idx,
            "beating": self.beating(),
            "draining": draining,
            "burn": burn,
            "depth": self.server.batcher.depth,
            "max_queue": self.server.opts.max_queue,
        }


class ReplicaSet:
    """N replicas + router + heartbeat supervisor behind one submit()."""

    def __init__(self, engine: InferenceEngine,
                 options: Optional[ServeOptions] = None,
                 fleet: Optional[FleetOptions] = None,
                 cfg: Any = None, seed: int = 0):
        from neutronstarlite_torch import obs
        from neutronstarlite_torch.resilience import elastic, events

        self.engine = engine  # the warm template (never serves directly)
        self.opts = options or engine.opts
        self.fleet_opts = fleet or FleetOptions.from_cfg(
            cfg if cfg is not None else engine.cfg
        )
        self.cfg = cfg if cfg is not None else engine.cfg
        self._seed = seed
        # the fleet's own stream: front-door sheds, heartbeats,
        # rank_loss, restart recoveries, and the consolidated summary
        self.registry = obs.open_run("serve-fleet", cfg=self.cfg, seed=seed)
        self.registry.gauge_set("fleet.replicas", self.fleet_opts.replicas)
        self.registry.gauge_set("fleet.route", self.fleet_opts.route)
        # the fleet is the process's active run: LivenessMonitor beats and
        # restart recovery records flow through the resilience event sink
        events.set_sink(self.registry)
        self._events = events
        self.replicas: List[Replica] = [
            self._build_replica(i) for i in range(self.fleet_opts.replicas)
        ]
        self.shed_count = 0
        self._lock = threading.Lock()
        # a route and the hand-off to the chosen replica are one step
        # against the chaos hook (inject_replica_death)
        self._submit_lock = threading.Lock()
        self._sticky: Optional[int] = None
        self._rr = 0
        self._closed = False
        self._monitor = elastic.LivenessMonitor(
            partitions=self.fleet_opts.replicas
        )
        self._tick = 0
        self._monitor_thread: Optional[threading.Thread] = None
        if self.fleet_opts.heartbeat_s > 0:
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, name="serve-fleet-monitor",
                daemon=True,
            )
            self._monitor_thread.start()
        log.info(
            "serve fleet up: %d replica(s), route=%s (hysteresis %.2f), "
            "heartbeat %.2fs x miss_k %d",
            self.fleet_opts.replicas, self.fleet_opts.route,
            self.fleet_opts.hysteresis, self.fleet_opts.heartbeat_s,
            self._monitor.miss_k,
        )

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_engine(cls, engine: InferenceEngine, replicas: int,
                    options: Optional[ServeOptions] = None,
                    **kw) -> "ReplicaSet":
        fleet = FleetOptions.from_cfg(engine.cfg)
        fleet.replicas = int(replicas)
        return cls(engine, options=options, fleet=fleet, **kw)

    def _build_replica(self, idx: int) -> Replica:
        from neutronstarlite_torch import obs

        rid = f"r{idx}"
        reg = obs.open_run(f"serve-{rid}", cfg=self.cfg, seed=self._seed)
        eng = self.engine.clone(
            metrics=reg,
            rng=np.random.default_rng(self._seed + 1000 * (idx + 1)),
        )
        server = InferenceServer(eng, options=self.opts, replica=rid)
        return Replica(rid, idx, eng, server)

    # ---- routing ---------------------------------------------------------
    def _route(self) -> Tuple[Optional[Replica], Optional[str]]:
        states = [r.route_state() for r in self.replicas]
        with self._lock:
            if self.fleet_opts.route == "round_robin":
                healthy, reason = classify_states(states)
                if not healthy:
                    return None, reason
                idx = healthy[self._rr % len(healthy)]["idx"]
                self._rr += 1
                return self.replicas[idx], None
            idx, reason = choose_replica(
                states, sticky=self._sticky,
                hysteresis=self.fleet_opts.hysteresis,
            )
            if idx is None:
                return None, reason
            self._sticky = idx
            return self.replicas[idx], None

    def submit(self, node_ids) -> ServeRequest:
        """The fleet front door: route to the least-burn healthy replica;
        fleet-level shed only when NO replica can take the request."""
        with self._submit_lock:
            replica, reason = self._route()
            if replica is not None:
                return replica.server.submit(node_ids)
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        req = ServeRequest(ids)
        with self._lock:
            self.shed_count += 1
        self.registry.counter_add("fleet.shed")
        self.registry.event(
            "shed", reason=reason, req_id=req.req_id,
        )
        self.registry.event(
            "serve_request", n_seeds=max(len(ids), 1), status="shed",
            total_ms=None, req_id=req.req_id,
        )
        req._complete(None, "shed", RequestShedError(reason))
        return req

    def predict(self, node_ids, timeout: Optional[float] = 60.0):
        return self.submit(node_ids).result(timeout)

    # ---- supervision (the elastic heartbeat pattern) ---------------------
    def _monitor_loop(self) -> None:
        from neutronstarlite_torch.resilience.elastic import RankLossError

        while not self._closed:
            time.sleep(self.fleet_opts.heartbeat_s)
            if self._closed:
                return
            self._tick += 1
            alive = [
                i for i, r in enumerate(self.replicas) if r.beating()
            ]
            for i, r in enumerate(self.replicas):
                reg = r.registry
                if reg is not None:
                    reg.gauge_set("serve.beating", i in alive)
            try:
                self._monitor.epoch_end(self._tick, alive=alive)
            except RankLossError:
                pass  # detection below reads the miss counters directly
            for i in range(len(self.replicas)):
                if i in alive:
                    continue
                if self._monitor.missed(i) >= self._monitor.miss_k:
                    try:
                        self._restart(i)
                    except Exception as e:  # supervision must survive
                        log.warning("replica r%d restart failed (%s); "
                                    "retrying next tick", i, e)

    def _restart(self, idx: int) -> None:
        """Supervised replica restart: steal the dead replica's in-flight
        requests, bring up a fresh server over the same warm engine
        clone (zero builds — the shared bucket ladder), re-route the
        stolen work, and clear the liveness latch so a SECOND death
        re-detects."""
        if self._closed:
            return
        dead = self.replicas[idx]
        stolen = dead.server.steal_inflight()
        dead.server.inject_death()  # ensure the flusher really is gone
        if dead.server._prep_q is not None:
            dead.server._prep_q.put(None)  # release the old executor
        self._events.emit_recovery(
            "restart", replica=dead.rid, stolen_requests=len(stolen),
        )
        self.registry.counter_add("fleet.restarts")
        server = InferenceServer(
            dead.engine, options=self.opts, replica=dead.rid
        )
        fresh = Replica(dead.rid, idx, dead.engine, server)
        fresh.restarts = dead.restarts + 1
        fresh.carried_requests = dead.requests_total()
        fresh.carried_shed = dead.shed_total()
        with self._lock:
            if self._closed:
                # close() won the race while we were building: the fresh
                # server must not outlive the fleet (leaked threads + a
                # stream that never gets its serve_summary)
                server.close()
                return
            self.replicas[idx] = fresh
            if self._sticky == idx:
                self._sticky = None
        self._monitor.clear(idx)
        rerouted = 0
        for req in stolen:
            target, _reason = self._route()
            if target is None:
                target = fresh
            target.server.batcher.requeue(req)
            rerouted += 1
        log.warning(
            "replica %s restarted supervised (restart #%d); %d in-flight "
            "request(s) re-routed, none dropped",
            dead.rid, fresh.restarts, rerouted,
        )

    def inject_replica_death(self, idx: int) -> None:
        """Chaos hook (tests, chip_smoke.py): silence one replica the way a
        real thread death would — the heartbeat monitor must notice. A
        request routed before the death is pending there (the restart
        steals and re-routes it); none routes there after."""
        with self._submit_lock:
            self.replicas[idx].killed = True
            self.replicas[idx].server.inject_death()

    # ---- live graph deltas ----------------------------------------------
    def apply_delta(self, delta):
        """Fleet-wide delta: one plan, every replica's engine swapped
        under its graph gate, per-replica cache invalidation + records
        (serve/delta.py)."""
        from neutronstarlite_torch.serve import delta as delta_mod

        plan = delta_mod.apply_to_servers(
            [r.server for r in self.replicas], delta,
            extra_engines=[self.engine],
        )
        self.registry.counter_add("fleet.graph_deltas")
        self.registry.gauge_set("graph.digest", plan.digest)
        return plan

    # ---- stats / close ---------------------------------------------------
    def _merged_latency(self):
        from neutronstarlite_torch.obs.hist import LogHistogram

        merged: Optional[LogHistogram] = None
        for r in self.replicas:
            reg = r.registry
            if reg is None:
                continue
            h = reg.hists().get("serve.latency_ms")
            if h is None:
                continue
            merged = h if merged is None else merged.merge(h)
        return merged

    def stats(self) -> Dict[str, Any]:
        per = {}
        for r in self.replicas:
            s = r.server.stats()
            # across-restart totals: the fresh server's counters alone
            # would forget the dead incarnation's served/shed work
            s["requests"] = r.requests_total()
            s["shed"] = r.shed_total()
            per[r.rid] = s
        h = self._merged_latency()
        requests = sum(s["requests"] for s in per.values())
        shed = self.shed_count + sum(s["shed"] for s in per.values())
        spans = [
            (r.server._t_first, r.server._t_last) for r in self.replicas
            if r.server._t_first is not None and r.server._t_last is not None
        ]
        span = (
            max(b for _a, b in spans) - min(a for a, _b in spans)
            if spans else None
        )
        return {
            "replicas": len(self.replicas),
            "requests": requests,
            "shed": shed,
            "fleet_shed": self.shed_count,
            "restarts": sum(r.restarts for r in self.replicas),
            "latency_ms": (
                h.quantiles() if h is not None and h.count
                else {"p50": None, "p95": None, "p99": None}
            ),
            "throughput_rps": (
                requests / span if span and span > 0 else None
            ),
            "per_replica": per,
        }

    def stream_paths(self) -> List[str]:
        """Every JSONL stream this fleet writes (replicas + front door) —
        what serve_bench merges its percentiles from."""
        out = []
        for r in self.replicas:
            if r.registry is not None and r.registry.path:
                out.append(r.registry.path)
        if self.registry.path:
            out.append(self.registry.path)
        return out

    def close(self) -> Dict[str, Any]:
        """Drain every replica, emit the fleet serve_summary (merged
        latency histogram — the fleet p99 is exact), release the event
        sink."""
        if self._closed:
            return self.stats()
        self._closed = True
        if self._monitor_thread is not None:
            self._monitor_thread.join(
                timeout=self.fleet_opts.heartbeat_s * 4 + 1.0
            )
        for r in self.replicas:
            r.server.close()
        s = self.stats()
        snap = self.registry.snapshot()
        self.registry.event(
            "serve_summary",
            requests=s["requests"],
            shed=s["shed"],
            latency_ms=s["latency_ms"],
            throughput_rps=s["throughput_rps"],
            counters=snap["counters"],
            gauges=snap["gauges"],
            replicas=s["replicas"],
            restarts=s["restarts"],
            fleet=True,
        )
        self.registry.close()
        if self._events.get_sink() is self.registry:
            self._events.set_sink(None)
        return s
