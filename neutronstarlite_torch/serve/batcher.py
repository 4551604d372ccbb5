"""Micro-batching request queue with deadline/size coalescing + shedding.

Port of ``neutronstarlite_tpu/serve/batcher.py``, copied: only the import paths
differ (the lazy import of ``sample.pipeline`` names the port's module).

The serving analog of the training-side work queue (``Sampler``'s batch
walk, ntsSampler.hpp:125-137): individual per-node prediction requests are
coalesced into padded micro-batches so the device executes the same
fixed-shape AOT executables steady-state training uses. A flush fires when
``max_batch`` seeds have accumulated OR ``max_wait_ms`` has elapsed since
the oldest pending request — whichever comes first — so a lone request
never waits longer than the deadline and a burst fills whole buckets.

Overload policy is explicit: the queue depth is bounded (``max_queue``
pending requests) and a request arriving beyond it is REJECTED with a
reason (a ``shed`` obs record + ``RequestShedError`` on its future) instead
of being enqueued into unbounded latency collapse — the load generator
(tools/serve_bench.py) measures exactly this knee.

All knobs live on :class:`ServeOptions`; each has a cfg key (SERVE_*) and an
``NTS_SERVE_*`` env override (launcher parity with NTS_PARTITIONS_OVERRIDE).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")


def latency_percentiles(samples_ms) -> dict:
    """{p50, p95, p99} (ms, linear-interpolated np.percentile) over RAW
    samples — since the live telemetry plane (obs/hist) this is only the
    FALLBACK definition for pre-histogram streams: the live serve
    surfaces (stats(), serve_summary, serve_bench, metrics_report's
    synthesized summary) all report quantiles from the mergeable
    LogHistogram, which survives rotation and bounds memory. Lives here
    (not server.py) so the report CLI can import it without pulling
    jax."""
    if not samples_ms:
        return {"p50": None, "p95": None, "p99": None}
    arr = np.asarray(list(samples_ms), dtype=np.float64)
    p50, p95, p99 = np.percentile(arr, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}


class RequestShedError(RuntimeError):
    """The server rejected this request under overload (reason attached)."""

    def __init__(self, reason: str):
        super().__init__(f"request shed: {reason}")
        self.reason = reason


def _env_override(name: str, cast, current):
    raw = os.environ.get(name, "")
    if not raw:
        return current
    try:
        return cast(raw)
    except ValueError:
        log.warning("%s=%r is not a valid %s; keeping %r",
                    name, raw, cast.__name__, current)
        return current


@dataclasses.dataclass
class ServeOptions:
    """Every serving knob in one place (docs/SERVING.md has the semantics)."""

    max_batch: int = 16  # flush size == largest AOT shape bucket
    max_wait_ms: float = 5.0  # deadline coalescing window
    max_queue: int = 256  # pending-request bound; beyond it: shed
    buckets: Tuple[int, ...] = ()  # explicit AOT ladder; () = geometric x4
    cache_cap: int = 0  # inference embedding cache entries (0 = disabled)
    cache_max_age_s: float = 60.0  # staleness bound for cached embeddings
    hot_threshold: int = 0  # out-degree >= threshold => cacheable vertex
    sample_pipeline: str = "sync"  # SAMPLE_PIPELINE / NTS_SAMPLE_PIPELINE:
    # sync (sample inside the flush, the parity oracle), pipelined (the
    # flusher samples + stages H2D while a separate executor thread runs
    # the previous flush on the device — serve/server.py two-stage flush),
    # device (pipelined + the on-device uniform hop sampler), fused (a
    # cache miss's sample+execute is ONE dispatch per bucket through the
    # engine's fused ladder — serve/engine.py _fused_forward_fn)
    continuous_batching: bool = False  # SERVE_CB / NTS_SERVE_CB: run the
    # two-stage flush even with sync sampling — the batcher admits and
    # PRODUCES the next bucket (cache pass + sample + H2D staging) while
    # the executor runs the current one, so sustained open-loop load never
    # serializes on flush-wait (p99 under load is what this buys; the
    # sample draws and results are identical to sync — same thread order)

    @classmethod
    def from_cfg(cls, cfg: Any = None) -> "ServeOptions":
        """cfg SERVE_* fields, then NTS_SERVE_* env overrides on top."""
        o = cls()
        if cfg is not None:
            o.max_batch = int(getattr(cfg, "serve_max_batch", o.max_batch))
            o.max_wait_ms = float(
                getattr(cfg, "serve_max_wait_ms", o.max_wait_ms)
            )
            o.max_queue = int(getattr(cfg, "serve_max_queue", o.max_queue))
            if getattr(cfg, "serve_buckets", ""):
                o.buckets = tuple(cfg.serve_bucket_list())
            o.cache_cap = int(getattr(cfg, "serve_cache_cap", o.cache_cap))
            o.cache_max_age_s = float(
                getattr(cfg, "serve_cache_max_age_s", o.cache_max_age_s)
            )
            o.hot_threshold = int(
                getattr(cfg, "serve_hot_threshold", o.hot_threshold)
            )
            o.continuous_batching = bool(
                int(getattr(cfg, "serve_cb", o.continuous_batching))
            )
        o.max_batch = _env_override("NTS_SERVE_MAX_BATCH", int, o.max_batch)
        o.max_wait_ms = _env_override(
            "NTS_SERVE_MAX_WAIT_MS", float, o.max_wait_ms
        )
        o.max_queue = _env_override("NTS_SERVE_MAX_QUEUE", int, o.max_queue)
        raw = os.environ.get("NTS_SERVE_BUCKETS", "")
        if raw:
            try:
                o.buckets = tuple(
                    int(tok) for tok in raw.split("-") if tok
                )
            except ValueError:
                log.warning("NTS_SERVE_BUCKETS=%r unparseable; ignoring", raw)
        o.cache_cap = _env_override("NTS_SERVE_CACHE_CAP", int, o.cache_cap)
        o.cache_max_age_s = _env_override(
            "NTS_SERVE_CACHE_MAX_AGE_S", float, o.cache_max_age_s
        )
        o.hot_threshold = _env_override(
            "NTS_SERVE_HOT_THRESHOLD", int, o.hot_threshold
        )
        raw_cb = os.environ.get("NTS_SERVE_CB", "")
        if raw_cb:
            if raw_cb not in ("0", "1"):
                log.warning("NTS_SERVE_CB=%r is not 0|1; keeping %r",
                            raw_cb, o.continuous_batching)
            else:
                o.continuous_batching = raw_cb == "1"
        # ONE grammar for the selector (env-wins, alias map, validation):
        # sample.pipeline.resolve_sample_pipeline — imported lazily so
        # this module stays importable without jax (metrics_report pulls
        # latency_percentiles at module level)
        from neutronstarlite_torch.sample.pipeline import (
            resolve_sample_pipeline,
        )

        o.sample_pipeline = resolve_sample_pipeline(cfg)
        if o.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {o.max_batch}")
        if o.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {o.max_queue}")
        return o

    def ladder(self) -> List[int]:
        """The AOT shape-bucket ladder, ascending, always topped by
        ``max_batch``. Default: geometric x4 (1, 4, 16, ...) — a small
        number of executables covering every flush size with <= 4x padding
        waste, the compile-once discipline of Accel-GCN-style fixed-shape
        execution."""
        if self.buckets:
            out = sorted({int(b) for b in self.buckets if int(b) >= 1})
            if not out:
                raise ValueError(f"no usable buckets in {self.buckets!r}")
            if out[-1] < self.max_batch:
                out.append(self.max_batch)
            return [b for b in out if b <= self.max_batch] or [self.max_batch]
        out = []
        b = 1
        while b < self.max_batch:
            out.append(b)
            b *= 4
        out.append(self.max_batch)
        return out


# process-wide request id sequence: the join key between a request's
# ``serve_request`` record and its lifecycle spans (obs/trace) — unique
# within one stream (ids are per-process, streams are per-process files)
_REQ_IDS = itertools.count()


class ServeRequest:
    """One in-flight request: seed ids + a completion future.

    ``ctx`` (obs/trace.TraceContext or None) is the remote caller's trace
    hop when the request arrived over the wire — the server's lifecycle
    spans parent into it so the replica-side timeline joins the router's
    trace."""

    __slots__ = ("node_ids", "req_id", "t_submit", "t_flush", "t_done",
                 "status", "logits", "error", "ctx", "_done")

    def __init__(self, node_ids: np.ndarray, ctx: Any = None):
        self.node_ids = node_ids
        self.req_id = f"q{next(_REQ_IDS):x}"
        self.t_submit = time.perf_counter()
        self.t_flush: Optional[float] = None
        self.t_done: Optional[float] = None
        self.status = "pending"
        self.logits: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.ctx = ctx
        self._done = threading.Event()

    # -- completion (batcher/server side) ---------------------------------
    def _complete(self, logits: Optional[np.ndarray], status: str,
                  error: Optional[BaseException] = None) -> None:
        self.logits = logits
        self.status = status
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()

    # -- consumption (client side) ----------------------------------------
    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until served; raises the per-request error (e.g.
        :class:`RequestShedError`) instead of returning garbage."""
        if not self._done.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self.error is not None:
            raise self.error
        return self.logits

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def total_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1000.0

    @property
    def queue_ms(self) -> Optional[float]:
        if self.t_flush is None:
            return None
        return (self.t_flush - self.t_submit) * 1000.0


class MicroBatcher:
    """Bounded request queue + background flusher thread.

    ``flush_fn(requests, reason)`` runs on the flusher thread and must
    complete every request it is handed (the server's `_flush`); an
    exception from it fails that batch's requests, never the thread.
    """

    def __init__(
        self,
        flush_fn: Callable[[List[ServeRequest], str], None],
        options: ServeOptions,
        metrics: Any = None,
        slo: Any = None,
    ):
        self.flush_fn = flush_fn
        self.opts = options
        self.metrics = metrics
        # the SLO burn-rate engine (obs/slo.SloEngine, NTS_SLO_SPEC):
        # when armed, burn-rate shedding is the FIRST admission gate —
        # under sustained overload it fires long before the static
        # max_queue bound below does (the start of SLO-driven routing)
        self.slo = slo
        self._pending: List[ServeRequest] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._aborted = False
        self.shed_count = 0
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._thread.start()

    # ---- client side -----------------------------------------------------
    def submit(self, node_ids: Sequence[int],
               ctx: Any = None) -> ServeRequest:
        """Enqueue one request; never blocks. Overload and malformed input
        reject-with-reason on the returned future. ``ctx`` carries the
        remote caller's TraceContext through to the lifecycle spans."""
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        req = ServeRequest(ids, ctx=ctx)
        reason = None
        if len(ids) == 0:
            reason = "empty_request"
        elif len(ids) > self.opts.max_batch:
            reason = (
                f"request_too_large ({len(ids)} seeds > max_batch "
                f"{self.opts.max_batch})"
            )
        if reason is None and self.slo is not None:
            # burn-rate gate before the hard bound: while a latency
            # objective is breaching, the effective queue bound shrinks
            # to max_queue / burn (the depth read is advisory — shedding
            # is a heuristic, the hard bound below stays exact)
            reason = self.slo.shed_advice(
                len(self._pending), self.opts.max_queue
            )
        if reason is None:
            with self._cond:
                if self._closed or self._aborted:
                    reason = "server_closed"
                elif len(self._pending) >= self.opts.max_queue:
                    reason = f"queue_full (depth {len(self._pending)})"
                else:
                    self._pending.append(req)
                    self._cond.notify()
        if reason is not None:
            self._shed(req, reason)
        return req

    def _shed(self, req: ServeRequest, reason: str) -> None:
        with self._lock:  # sheds arrive from arbitrary client threads
            self.shed_count += 1
        req._complete(None, "shed", RequestShedError(reason))
        if self.metrics is not None:
            self.metrics.counter_add("serve.shed")
            self.metrics.event(
                "shed", reason=reason, queue_depth=len(self._pending),
                req_id=req.req_id,
            )
            self.metrics.event(
                "serve_request", n_seeds=max(len(req.node_ids), 1),
                status="shed", total_ms=req.total_ms, req_id=req.req_id,
            )

    # ---- fleet-side surface (serve/fleet.py) -----------------------------
    @property
    def depth(self) -> int:
        """Current pending-request count (advisory read — the router's
        queue-depth signal)."""
        return len(self._pending)

    def alive(self) -> bool:
        """Is the flusher thread still running? False after close() drains
        or after an injected death (``abort``)."""
        return self._thread.is_alive()

    def requeue(self, req: ServeRequest) -> None:
        """Re-enqueue a request stolen from a dead replica (fleet
        re-route): size validation already passed at the original submit,
        so only the bound and liveness gates apply; ``t_submit`` is kept,
        so the recorded latency honestly includes the dead time."""
        with self._cond:
            if self._closed or self._aborted:
                reason = "server_closed"
            elif len(self._pending) >= self.opts.max_queue:
                reason = f"queue_full (depth {len(self._pending)}, requeue)"
            else:
                self._pending.append(req)
                self._cond.notify()
                return
        self._shed(req, reason)

    def steal_pending(self) -> List[ServeRequest]:
        """Take every pending request (the fleet re-routes them after a
        replica death — in-flight work is re-routed, never dropped)."""
        with self._cond:
            out = self._pending
            self._pending = []
        return out

    def abort(self) -> None:
        """Chaos hook: kill the flusher thread WITHOUT draining — the
        simulated dead replica. Pending requests stay queued for
        ``steal_pending``; new submits shed with server_closed."""
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    # ---- flusher thread --------------------------------------------------
    def _take_batch(self) -> Tuple[List[ServeRequest], str]:
        """Block until a flush condition holds; pop one batch under lock."""
        with self._cond:
            while True:
                if self._aborted:
                    return [], "abort"
                if self._pending:
                    n_seeds = sum(len(r.node_ids) for r in self._pending)
                    deadline = (
                        self._pending[0].t_submit
                        + self.opts.max_wait_ms / 1000.0
                    )
                    now = time.perf_counter()
                    if n_seeds >= self.opts.max_batch:
                        return self._pop_upto(), "size"
                    if self._closed:
                        return self._pop_upto(), "drain"
                    if now >= deadline:
                        return self._pop_upto(), "deadline"
                    self._cond.wait(timeout=deadline - now)
                elif self._closed:
                    return [], "stop"
                else:
                    self._cond.wait()

    def _pop_upto(self) -> List[ServeRequest]:
        """Pop requests FIFO until the next one would overflow max_batch
        seeds (each request fits alone — submit() rejected larger ones)."""
        out: List[ServeRequest] = []
        seeds = 0
        while self._pending:
            n = len(self._pending[0].node_ids)
            if out and seeds + n > self.opts.max_batch:
                break
            req = self._pending.pop(0)
            seeds += n
            out.append(req)
        return out

    def _loop(self) -> None:
        while True:
            batch, reason = self._take_batch()
            if not batch:
                return  # "stop": closed and drained
            t_flush = time.perf_counter()
            for r in batch:
                r.t_flush = t_flush
            try:
                self.flush_fn(batch, reason)
            except BaseException as e:  # a bad batch must not kill serving
                log.warning("flush failed (%s): %s", type(e).__name__, e)
                for r in batch:
                    if not r.done():
                        r._complete(None, "error", e)

    def close(self, timeout: float = 30.0) -> None:
        """Drain pending requests (flushed with reason "drain") and stop."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
