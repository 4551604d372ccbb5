"""Hierarchical span tracing over the MetricsRegistry JSONL stream — port of
``neutronstarlite_tpu/obs/trace.py``, copied, with ``torch.profiler`` in
place of ``jax.profiler``.

Flat counters and records can say *how much* (bytes shipped, epochs
timed) but not *when relative to what*: did the ring's hop wait hide under
the blocked-kernel compute, where inside a serve request's p99 did the
time go, what did a resilience retry cost end-to-end. This module adds the
missing causal dimension: every interesting interval becomes one typed
``span`` record (``trace_id`` / ``span_id`` / ``parent_id``, monotonic
begin + duration) written through the SAME per-rank JSONL sink the rest of
obs/ uses — no second telemetry pipe, no new file format, and the existing
``NTS_METRICS_MAX_MB`` / multi-host rank-file conventions apply unchanged.

Clock model (documented in docs/OBSERVABILITY.md):

- ``t0`` is ``time.perf_counter()`` seconds — monotonic, process-local,
  immune to NTP steps mid-run;
- the envelope ``ts`` (wall clock) is stamped when the record is WRITTEN,
  which for spans is immediately after the span ends — so per process the
  mono->wall offset is recoverable as ``median(ts - (t0 + dur_s))`` over
  its spans (tools/trace_timeline does exactly this);
- cross-rank skew is corrected AFTER that mapping by matching per-epoch
  spans (every rank ends epoch e at the same collective barrier), again
  in tools/trace_timeline — the tracer itself never talks to other ranks.

While an ``NTS_PROFILE_DIR`` trace records (``utils/profiling.maybe_trace``),
LIVE spans (context-manager or ``begin()``/``end()``) additionally open a
``torch.profiler.record_function`` scope so the same names appear inside
the device trace — host causality and device ops land in one Perfetto
view. Spans emitted retroactively via ``complete()`` (epoch/stage/request/
queue) already happened and cannot annotate; the run loops wrap the
intervals they will report that way in ``annotate(name)``, which opens the
same scope while a trace records and emits nothing (the record comes from
``complete()``). Outside a recording trace no profiler scope is opened.

Usage::

    tracer = Tracer(registry)
    with tracer.span("graph_load", cat="phase"):
        ...                        # parent = innermost open span (thread-local)
    h = tracer.begin("run", cat="lifecycle")   # long-lived root
    ...
    tracer.end(h, outcome="ok")
    tracer.complete("epoch", dur_s=dt, epoch=3)  # retroactive: ended just now

Tracing is on whenever the registry exists (spans are ordinary events; a
sink-less registry keeps them in memory only); ``NTS_TRACE=0`` disables
emission entirely for overhead-sensitive sweeps.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Optional

from neutronstarlite_torch.utils import profiling
from neutronstarlite_torch.utils.logging import get_logger, process_index

log = get_logger("obs")


def _now() -> float:
    return time.perf_counter()


# One process-wide id source: several tracers can share one registry (the
# trainer funnel's tracer + the serve server's on a train-then-serve run
# write the SAME per-rank stream), and schema.py documents span_id as
# unique within the stream — per-tracer counters would collide at "s0".
_SPAN_IDS = itertools.count()


class TraceContext:
    """A serializable hop in a distributed trace.

    Three facts cross the process boundary (as HTTP headers, injected by
    obs/httpc and extracted by the exporter's /predict + /telemetry
    handlers):

    - ``trace_id``   — which trace the remote spans should join;
    - ``span_id``    — the CALLER's span the remote spans parent into
      (``parent_id`` on the receiving side);
    - ``send_ts``    — the caller's wall clock at send time.

    The receiver stamps ``recv_ts`` (its own wall clock) at extraction.
    A span emitted with a context therefore carries one (send_ts,
    recv_ts) pair of the two processes' wall clocks taken ~one network
    hop apart — tools/trace_timeline turns the pairs into per-process
    clock offsets (NTP-style, error bounded by RTT/2; see
    docs/OBSERVABILITY.md)."""

    __slots__ = ("trace_id", "span_id", "send_ts", "recv_ts")

    H_TRACE = "X-NTS-Trace-Id"
    H_PARENT = "X-NTS-Parent-Span"
    H_SEND_TS = "X-NTS-Send-Ts"

    def __init__(self, trace_id: str, span_id: Optional[str],
                 send_ts: Optional[float] = None,
                 recv_ts: Optional[float] = None):
        self.trace_id = str(trace_id)
        self.span_id = span_id
        self.send_ts = send_ts
        self.recv_ts = recv_ts

    def to_headers(self, send_ts: Optional[float] = None) -> dict:
        """Header dict for one outbound request. ``send_ts`` defaults to
        now — pass it explicitly to re-stamp per retry attempt."""
        ts = send_ts if send_ts is not None else (
            self.send_ts if self.send_ts is not None else time.time()
        )
        h = {self.H_TRACE: self.trace_id, self.H_SEND_TS: f"{ts:.6f}"}
        if self.span_id:
            h[self.H_PARENT] = self.span_id
        return h

    @classmethod
    def from_headers(cls, headers) -> Optional["TraceContext"]:
        """Parse a received header mapping (anything with ``.get``);
        ``None`` when the request carries no trace. Stamps ``recv_ts``
        with the receiver's wall clock at extraction."""
        trace_id = headers.get(cls.H_TRACE)
        if not trace_id:
            return None
        send_ts: Optional[float] = None
        raw = headers.get(cls.H_SEND_TS)
        if raw:
            try:
                send_ts = float(raw)
            except (TypeError, ValueError):
                send_ts = None
        return cls(trace_id, headers.get(cls.H_PARENT) or None,
                   send_ts=send_ts, recv_ts=time.time())

    def child(self, span_id: Optional[str]) -> "TraceContext":
        """Same trace, re-parented under ``span_id`` (send/recv stamps
        carried along so downstream spans keep the clock pair)."""
        return TraceContext(self.trace_id, span_id,
                            send_ts=self.send_ts, recv_ts=self.recv_ts)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"send_ts={self.send_ts}, recv_ts={self.recv_ts})")


class SpanHandle:
    """One open (or retroactively completed) span."""

    __slots__ = ("name", "cat", "span_id", "parent_id", "t0", "attrs",
                 "trace_id", "_ann", "_ann_tid")

    def __init__(self, name: str, cat: str, span_id: str,
                 parent_id: Optional[str], t0: float, attrs: dict,
                 trace_id: Optional[str] = None):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs
        self.trace_id = trace_id  # per-span override (remote parenting)
        self._ann = None  # the open profiler scope, if any
        self._ann_tid = None  # thread that opened it (scopes are TLS)


class Tracer:
    """Span emitter bound to one MetricsRegistry (one trace per run).

    Thread-safe: each thread keeps its own open-span stack, so the serve
    batcher's flusher thread and shedding client threads nest their spans
    independently. Parenting across threads is explicit (``parent=``)."""

    def __init__(self, registry, trace_id: Optional[str] = None):
        self.registry = registry
        self.trace_id = trace_id or (
            registry.run_id if registry is not None else "trace"
        )
        self._tls = threading.local()
        self._rank = process_index()
        self.enabled = (
            registry is not None
            and os.environ.get("NTS_TRACE", "1") != "0"
        )

    # ---- internals -------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> str:
        return f"s{next(_SPAN_IDS):x}"

    def _resolve_parent(self, parent) -> tuple:
        """(parent_id, inherited trace override). A child belongs to its
        parent's trace: when the parent (explicit handle or innermost
        open span) carries a remote trace override, spans nested under
        it join that trace too — the propagation that keeps a replica's
        whole request subtree in the router's trace."""
        if parent is not None:
            if isinstance(parent, SpanHandle):
                return parent.span_id, parent.trace_id
            return str(parent), None
        st = self._stack()
        if st:
            return st[-1].span_id, st[-1].trace_id
        return None, None

    def _apply_ctx(self, ctx: Optional[TraceContext], parent,
                   attrs: dict) -> tuple:
        """(parent_id, trace_override) under a remote ``ctx``: the remote
        caller's span becomes the parent (unless an explicit local parent
        was given), the span joins the caller's trace, and the clock-pair
        stamps ride along as attributes."""
        if ctx is None:
            return self._resolve_parent(parent)
        if parent is None:
            parent_id = ctx.span_id
        else:
            parent_id, _ = self._resolve_parent(parent)
        if ctx.send_ts is not None:
            attrs.setdefault("send_ts", float(ctx.send_ts))
        if ctx.recv_ts is not None:
            attrs.setdefault("recv_ts", float(ctx.recv_ts))
        return parent_id, ctx.trace_id

    # ---- distributed-context helpers -------------------------------------
    def next_id(self) -> str:
        """Pre-allocate a span id (for callers that must hand a child its
        parent id before the parent span itself is emitted — the router's
        per-request root, httpc's in-flight fetch span)."""
        return self._next_id()

    def make_ctx(self, parent=None,
                 trace_id: Optional[str] = None) -> Optional[TraceContext]:
        """Context for an outbound hop: this tracer's trace (or the given
        override) parented under ``parent`` (or the innermost open span).
        ``None`` when tracing is off — callers pass it straight through,
        keeping the disabled path allocation-free."""
        if not self.enabled:
            return None
        parent_id, inherited = self._resolve_parent(parent)
        return TraceContext(trace_id or inherited or self.trace_id,
                            parent_id)

    def _emit(self, h: SpanHandle, dur_s: float, extra: dict) -> None:
        if not self.enabled:
            return
        attrs = dict(h.attrs)
        attrs.update(extra)
        try:
            self.registry.event(
                "span",
                name=h.name,
                cat=h.cat,
                span_id=h.span_id,
                trace_id=h.trace_id or self.trace_id,
                parent_id=h.parent_id,
                t0=float(h.t0),
                dur_s=max(float(dur_s), 0.0),
                rank=self._rank,
                thread=threading.current_thread().name,
                **attrs,
            )
        except Exception as e:  # telemetry must never kill the run
            log.warning("span emit failed (%s); continuing", e)

    # ---- explicit begin/end (long-lived roots) ---------------------------
    def begin(self, name: str, cat: str = "host", parent=None,
              ctx: Optional[TraceContext] = None, **attrs: Any) -> SpanHandle:
        """Open a span and push it on this thread's stack (it becomes the
        default parent for spans opened on the same thread until ended).
        With ``ctx`` the span joins a remote caller's trace (see
        :class:`TraceContext`)."""
        parent_id, trace_override = self._apply_ctx(ctx, parent, attrs)
        h = SpanHandle(
            name, cat, self._next_id(), parent_id,
            _now(), attrs, trace_id=trace_override,
        )
        if self.enabled:
            self._stack().append(h)
            if profiling.recording():
                # live spans also open a record_function scope so the
                # same name lands inside the device trace (spans emitted
                # retroactively via complete() cannot — they already
                # happened)
                h._ann = profiling.annotate(name)
                h._ann.__enter__()
                h._ann_tid = threading.get_ident()
        return h

    def end(self, h: SpanHandle, **attrs: Any) -> None:
        """Close ``h`` (idempotence is the caller's job) and emit it. Pops
        the handle from this thread's stack if it is there — ends from a
        different thread than the begin simply skip the pop."""
        if h._ann is not None:
            # profiler scopes are thread-local: only the opening
            # thread may close one (cross-thread ends just drop it)
            if h._ann_tid == threading.get_ident():
                try:
                    h._ann.__exit__(None, None, None)
                except Exception:
                    pass
            h._ann = None
        st = self._stack()
        if h in st:
            # close any dangling children too (crash paths)
            while st and st[-1] is not h:
                st.pop()
            if st:
                st.pop()
        self._emit(h, _now() - h.t0, attrs)

    # ---- context-manager form -------------------------------------------
    def span(self, name: str, cat: str = "host", parent=None,
             ctx: Optional[TraceContext] = None, **attrs: Any):
        """``with tracer.span("sample", cat="serve") as h:`` — nests via the
        thread-local stack, annotates the device trace when profiling."""
        return _SpanCtx(self, name, cat, parent, ctx, attrs)

    def annotate(self, name: str):
        """A profiler scope named ``name`` around an interval the caller
        reports later with ``complete()``: open only while a trace
        records, and never a record of its own."""
        if not self.enabled:
            return contextlib.nullcontext()
        return profiling.annotate(name)

    # ---- retroactive completion -----------------------------------------
    def complete(self, name: str, dur_s: float, end: Optional[float] = None,
                 t0: Optional[float] = None, cat: str = "host", parent=None,
                 ctx: Optional[TraceContext] = None,
                 span_id: Optional[str] = None, **attrs: Any) -> SpanHandle:
        """Emit a span that ALREADY happened: callers that timed an interval
        themselves (the epoch loop's ``get_time()`` bracketing) hand over
        the duration; ``end`` defaults to now, ``t0`` to ``end - dur_s``.
        ``ctx`` joins the span into a remote caller's trace; ``span_id``
        uses a pre-allocated id (``next_id()``) so children emitted earlier
        can already reference this span as their parent."""
        if t0 is None:
            t0 = (end if end is not None else _now()) - max(dur_s, 0.0)
        parent_id, trace_override = self._apply_ctx(ctx, parent, attrs)
        h = SpanHandle(
            name, cat, span_id or self._next_id(), parent_id,
            float(t0), attrs, trace_id=trace_override,
        )
        self._emit(h, dur_s, {})
        return h


class _SpanCtx:
    __slots__ = ("tracer", "name", "cat", "parent", "ctx", "attrs", "handle")

    def __init__(self, tracer: Tracer, name: str, cat: str, parent, ctx,
                 attrs):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.parent = parent
        self.ctx = ctx
        self.attrs = attrs
        self.handle: Optional[SpanHandle] = None

    def __enter__(self) -> SpanHandle:
        self.handle = self.tracer.begin(
            self.name, cat=self.cat, parent=self.parent, ctx=self.ctx,
            **self.attrs
        )
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.handle is None:
            return
        self.tracer.end(
            self.handle,
            **({"error": type(exc).__name__} if exc_type is not None else {}),
        )
