"""In-process inference server + CLI entrypoint — port of
``neutronstarlite_tpu/serve/server.py``.

``InferenceServer`` composes the three serving pieces: requests enter the
micro-batching queue (serve/batcher.py), flushes look up the inference
embedding cache then sample + execute the remainder on the smallest
covering bucket (serve/sampling.py + serve/engine.py), and every event
lands in the obs stream as a typed record (serve_request / batch_flush /
shed / serve_summary), with the reference's spans, histograms and SLO
burn-rate shedding.

The request API is deliberately transport-free: ``submit()`` returns a
future, ``predict()`` blocks — an HTTP/RPC front end is a thin loop over
it, and the load generator (tools/serve_bench.py) drives it directly.

CLI: ``python -m neutronstarlite_torch.serve.server <cfg> [<ckpt_dir>]
[--requests N] [--device cpu]`` loads the checkpoint, builds the bucket
ladder, serves a batch of random requests, and prints the latency summary.
It runs on the CUDA card unless ``--device cpu`` asks for the CPU.

Live graph deltas (``apply_delta``, serve/delta.py) land between flushes:
the graph gate serializes them against the flush produce stage, and a
delta waits until every flush already prepared has executed
(``drain_prepared``) before it writes into the tensors the buckets read,
so such a flush answers from the pre-delta view; the graph version keeps
its logits out of the cache once a delta has passed.
"""

from __future__ import annotations

import argparse
import itertools
import os
import queue as queue_mod
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from neutronstarlite_torch.obs.trace import TraceContext, Tracer
from neutronstarlite_torch.serve.batcher import MicroBatcher, ServeOptions, ServeRequest
from neutronstarlite_torch.serve.engine import InferenceEngine, ServeSetupError
from neutronstarlite_torch.serve.sampling import EmbeddingCache
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")

# process-wide like batcher._REQ_IDS: two servers (or a restarted one)
# sharing one registry stream must not collide flush ids — trace_timeline
# joins stage spans to serve_request records by (run_id, flush_id)
_FLUSH_IDS = itertools.count()


class InferenceServer:
    """Micro-batched, cache-fronted serving over one InferenceEngine."""

    def __init__(self, engine: InferenceEngine,
                 options: Optional[ServeOptions] = None,
                 replica: Optional[str] = None):
        self.engine = engine
        self.opts = options or engine.opts
        self.metrics = engine.metrics
        # fleet identity (serve/fleet.py): stamps the exporter surface
        # label, the flight-dump filename prefix, and the graph_delta
        # records; None for a standalone server
        self.replica = replica
        if self.metrics is not None and replica:
            self.metrics.gauge_set("serve.replica", replica)
            if self.metrics.flight is not None:
                self.metrics.flight.tag = replica
        self.cache = EmbeddingCache.for_graph(
            engine.toolkit.host_graph,
            self.opts.cache_cap,
            self.opts.cache_max_age_s,
            self.opts.hot_threshold,
        )
        # span tracing over the same obs stream: each flush becomes one
        # batch_flush span with cache/sample/execute/reply stage children,
        # each request one request/queue span pair — joined to the typed
        # serve_request records by req_id (tools/trace_timeline computes
        # the per-request critical-path breakdown from exactly this)
        self.tracer = Tracer(self.metrics)
        # the live telemetry plane (obs/): latency distributions become
        # mergeable histograms on the registry, the SLO burn-rate engine
        # (NTS_SLO_SPEC) evaluates them and drives burn-rate shedding in
        # the batcher below, and the HTTP exporter (NTS_METRICS_PORT)
        # serves /metrics, /healthz and /slo off the same registry
        from neutronstarlite_torch.obs import exporter as obs_exporter
        from neutronstarlite_torch.obs.slo import SloEngine

        self.slo = (
            SloEngine.from_env(self.metrics, scope="serve")
            if self.metrics is not None else None
        )
        self.exporter = obs_exporter.maybe_start(
            self.metrics, slo=self.slo, replica=replica
        )
        # SAMPLE_PIPELINE:pipelined/device — two-stage flush: the batcher's
        # flusher thread becomes the PRODUCER (cache pass + per-request
        # fan-out sampling + async H2D staging) and a dedicated executor
        # thread runs the bucket executable + replies, so sampling flush i+1
        # overlaps device execution of flush i and the `sample` span leaves
        # the batch_flush critical path. The queue is bounded: a stalled
        # executor backpressures the producer, which backs up the batcher,
        # which sheds — overload policy unchanged.
        # continuous batching (SERVE_CB / NTS_SERVE_CB) rides the same
        # two-stage machinery with synchronous sampling: the produce
        # stage of bucket i+1 overlaps the execute of bucket i.
        # SAMPLE_PIPELINE:fused deliberately does NOT force the two-stage
        # path: its flush has no host sampling to overlap (sample+execute
        # is one replay), so fused alone uses the simple sync flush and
        # only rides the producer/executor split when CB asks for it
        self.pipelined = (
            self.opts.continuous_batching
            or self.opts.sample_pipeline in ("pipelined", "device")
        )
        # serializes the flush PRODUCE stage against live graph-delta
        # application (serve/delta.py): a delta lands between flushes,
        # never inside one; the version keeps logits computed before a
        # delta out of the cache after it
        self._graph_gate = threading.RLock()
        self._graph_version = 0
        # flushes produced and not yet answered: a delta waits for 0
        # (drain_prepared) before it writes into the tensors they read
        self._prepared = 0
        self._prepared_cv = threading.Condition()
        self._prep_q: Optional[queue_mod.Queue] = None
        self._exec_thread: Optional[threading.Thread] = None
        self._producing = False
        self._prep_peak = 0
        if self.pipelined:
            self._prep_q = queue_mod.Queue(maxsize=2)
            self._exec_thread = threading.Thread(
                target=self._exec_loop, name="serve-executor", daemon=True
            )
            self._exec_thread.start()
        self.batcher = MicroBatcher(
            self._flush, self.opts, self.metrics, slo=self.slo
        )
        # the registry histogram is cumulative across every server bound
        # to it (a restarted server shares the run's registry); this
        # server's quantiles subtract the at-construction snapshot so
        # stats()/serve_summary describe THIS server's requests only
        self._lat_baseline = (
            self.metrics.hists().get("serve.latency_ms")
            if self.metrics is not None else None
        )
        self._stats_lock = threading.Lock()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self.request_count = 0
        self._closed = False
        # freshness lineage: every request span carries the graph version
        # (delta-log seq) and the model version (checkpoint step) that
        # answered it. The cross-host replica child wires its stream
        # ingestor's applied seq here (0 for a static graph); None leaves
        # graph_seq None, as for a standalone server
        self.graph_seq_source = None  # () -> int | None

    # ---- request API -----------------------------------------------------
    def submit(self, node_ids, ctx=None) -> ServeRequest:
        """Enqueue one request (any 1..max_batch vertex ids); returns the
        future. Overload rejects with RequestShedError on the future.
        ``ctx`` (obs/trace.TraceContext) parents this request's lifecycle
        spans into a remote caller's trace."""
        return self.batcher.submit(node_ids, ctx=ctx)

    def predict(self, node_ids, timeout: Optional[float] = 60.0) -> np.ndarray:
        """Blocking convenience wrapper: logits [n, n_classes]."""
        return self.submit(node_ids).result(timeout)

    # ---- live graph deltas (serve/delta.py) ------------------------------
    def apply_delta(self, delta):
        """Apply a GraphDelta between flushes: post-delta graph swapped
        in under the graph gate once the prepared flushes have executed,
        only the touched embedding-cache entries invalidated, device
        neighbour-table rows patched, digest bumped, one typed
        ``graph_delta`` record emitted. Returns the DeltaPlan."""
        from neutronstarlite_torch.serve import delta as delta_mod

        return delta_mod.apply_to_servers([self], delta)

    def drain_prepared(self, timeout: float = 120.0) -> None:
        """Wait until every flush produced so far has been answered (call
        with the graph gate held, so that none is produced meanwhile)."""
        with self._prepared_cv:
            if not self._prepared_cv.wait_for(lambda: self._prepared == 0, timeout):
                raise RuntimeError(
                    f"{self._prepared} prepared flush(es) did not execute within "
                    f"{timeout:.0f} s; a graph delta cannot land under them"
                )

    def _answered(self) -> None:
        with self._prepared_cv:
            self._prepared -= 1
            self._prepared_cv.notify_all()

    # ---- fleet-side surface (serve/fleet.py) -----------------------------
    def beating(self) -> bool:
        """Replica liveness: the flusher (and, pipelined, the executor)
        thread still running and the server not closed — what the fleet
        heartbeat monitor consumes each tick."""
        if self._closed:
            return False
        alive = self.batcher.alive()
        if self._exec_thread is not None:
            alive = alive and self._exec_thread.is_alive()
        return alive

    def inject_death(self) -> None:
        """Chaos hook: kill the flusher thread without draining — the
        fleet's heartbeat monitor must detect the silence, restart the
        replica supervised, and re-route the stolen pending requests."""
        self.batcher.abort()

    def steal_inflight(self) -> List[ServeRequest]:
        """Every request this (dead) server still owes an answer:
        batcher-pending plus any prepared-but-unexecuted flushes. The
        fleet re-routes them — in-flight requests are re-routed, never
        dropped."""
        out = self.batcher.steal_pending()
        if self._prep_q is not None:
            while True:
                try:
                    item = self._prep_q.get_nowait()
                except queue_mod.Empty:
                    break
                if item is None:
                    continue
                self._answered()
                out.extend(item[0])
        return [r for r in out if not r.done()]

    # ---- the flush path (batcher thread) ---------------------------------
    def _flush(self, requests: List[ServeRequest], reason: str) -> None:
        if self.pipelined:
            self._flush_pipelined(requests, reason)
            return
        t0 = time.perf_counter()
        flush_id = next(_FLUSH_IDS)
        batch_span = self.tracer.begin(
            "batch_flush", cat="serve", flush_id=flush_id, reason=reason,
            n_requests=len(requests),
        )
        try:
            bucket, n_seeds, exec_ms = self._flush_body(
                requests, t0, flush_id, batch_span
            )
        except BaseException as e:
            # the batcher deliberately survives a bad flush (_loop catches
            # everything); the span must still land — and pop off the
            # flusher thread's stack — or every later flush parents under
            # a handle that never reaches the stream
            self.tracer.end(batch_span, error=type(e).__name__)
            raise
        self.tracer.end(batch_span, bucket=bucket, n_seeds=n_seeds)
        self._record(requests, reason, bucket, n_seeds, exec_ms, flush_id)

    def _flush_body(self, requests: List[ServeRequest], t0: float,
                    flush_id: int, batch_span):
        with self._graph_gate:  # a graph delta lands between flushes
            return self._flush_body_locked(requests, t0, flush_id,
                                           batch_span)

    def _flush_body_locked(self, requests: List[ServeRequest], t0: float,
                           flush_id: int, batch_span):
        # cache pass: per requested id, a fresh cached row or a compute slot
        all_ids, cached_rows = self._cache_pass(requests)
        t_cache = time.perf_counter()
        bucket = None
        rows: Dict[int, np.ndarray] = dict(cached_rows)
        t_sample = t_cache
        if all_ids:
            uniq = np.asarray(all_ids, dtype=np.int64)
            bucket = self.engine.sampler.bucket_for(len(uniq))
            if getattr(self.engine, "fused", False):
                # SAMPLE_PIPELINE:fused — the miss set's fan-out draw,
                # remap, gather and forward are ONE replay of the engine's
                # fused bucket graph; there is no host sampling stage (its
                # span is structurally zero)
                t_sample = time.perf_counter()
                logits = self.engine.fused_predict_rows(uniq, bucket)
            else:
                batch = self.engine.sampler.sample(bucket, uniq)
                t_sample = time.perf_counter()
                logits = self.engine.forward_batch(batch, bucket)
            for i, vid in enumerate(uniq.tolist()):
                rows[vid] = logits[i]
            self.cache.insert(uniq, logits[: len(uniq)])
        t_exec = time.perf_counter()
        exec_ms = (t_exec - t0) * 1000.0

        for r in requests:
            out = np.stack([rows[v] for v in r.node_ids.tolist()])
            status = "cached" if all(
                v in cached_rows for v in r.node_ids.tolist()
            ) else "ok"
            r._complete(out, status)
        t_reply = time.perf_counter()
        # stage children, back-to-back over the flush body — the sum of a
        # request's queue span + these four IS its end-to-end latency (the
        # critical-path contract tests pin within tolerance)
        for name, a, b in (
            ("cache_lookup", t0, t_cache),
            ("sample", t_cache, t_sample),
            ("execute", t_sample, t_exec),
            ("reply", t_exec, t_reply),
        ):
            self.tracer.complete(
                name, dur_s=b - a, t0=a, cat="serve", parent=batch_span,
                flush_id=flush_id,
            )
        return bucket, len(all_ids), exec_ms

    # ---- the two-stage pipelined flush path ------------------------------
    def _cache_pass(self, requests: List[ServeRequest]):
        """Per requested id: a fresh cached row or a compute slot (shared
        by both flush paths)."""
        all_ids: List[int] = []
        seen = set()
        cached_rows: Dict[int, np.ndarray] = {}
        for r in requests:
            for vid in r.node_ids.tolist():
                if vid in seen:
                    continue
                seen.add(vid)
                row = self.cache.lookup(vid)
                if row is not None:
                    cached_rows[vid] = row
                else:
                    all_ids.append(vid)
        return all_ids, cached_rows

    def _flush_pipelined(self, requests: List[ServeRequest],
                         reason: str) -> None:
        """Producer stage (batcher thread): cache pass + fan-out sampling +
        H2D staging, then hand off to the executor. All spans here are
        retroactive completes keyed by flush_id (the critical-path join
        key) — the batch_flush span itself is emitted by the executor once
        the flush really finishes, so no cross-thread span stack is held
        open across the queue."""
        t0 = time.perf_counter()
        flush_id = next(_FLUSH_IDS)
        self._producing = True
        try:
            with self._graph_gate:  # a delta lands between produce stages
                version = self._graph_version
                all_ids, cached_rows = self._cache_pass(requests)
                t_cache = time.perf_counter()
                bucket = None
                prepared = None
                uniq = None
                t_sample = t_cache
                t_h2d = t_cache
                if all_ids:
                    uniq = np.asarray(all_ids, dtype=np.int64)
                    bucket = self.engine.sampler.bucket_for(len(uniq))
                    if getattr(self.engine, "fused", False):
                        # fused produce stage: no host sampling, no
                        # subgraph H2D — only the padded seeds, the live
                        # count and the draw key stage to the device;
                        # sample+execute run as ONE replay in the executor
                        t_sample = time.perf_counter()
                        self.engine._ensure_fused(bucket)
                        prepared = self.engine.prepare_fused(uniq, bucket)
                    else:
                        batch = self.engine.sampler.sample(bucket, uniq)
                        t_sample = time.perf_counter()
                        # a cold bucket builds here, out of the executor's
                        # steady-state path
                        self.engine._ensure_compiled(bucket)
                        prepared = self.engine.prepare_batch(batch)
                    t_h2d = time.perf_counter()
                with self._prepared_cv:
                    self._prepared += 1
            for name, a, b in (
                ("cache_lookup", t0, t_cache),
                ("sample", t_cache, t_sample),
                ("h2d_copy", t_sample, t_h2d),
            ):
                self.tracer.complete(
                    name, dur_s=b - a, t0=a, cat="serve",
                    flush_id=flush_id,
                )
        except BaseException:
            self._producing = False
            raise
        self._producing = False
        # bounded handoff: blocks when the executor is behind (backpressure
        # flows to the batcher queue, whose bound sheds — policy unchanged)
        self._prep_q.put(
            (requests, reason, flush_id, t0, t_h2d, bucket, uniq,
             cached_rows, prepared, version)
        )
        depth = self._prep_q.qsize()
        if self.metrics is not None:
            # depth as a distribution, not just a peak: stall diagnosis
            # needs to see whether the queue sat empty (producer-bound)
            # or full (executor-bound), not one high-water number
            self.metrics.hist_observe("sample.queue_depth", depth, unit="")
        if depth > self._prep_peak:
            self._prep_peak = depth
            if self.metrics is not None:
                self.metrics.gauge_set("sample.queue_depth", depth)

    def _exec_loop(self) -> None:
        while True:
            t_idle = time.perf_counter()
            producing = self._producing
            item = self._prep_q.get()
            if item is None:
                return
            wait = time.perf_counter() - t_idle
            if producing and self.metrics is not None:
                # the executor was waiting ON the producer (a flush was
                # mid-production when we went idle) — the residual,
                # un-overlapped sampling time
                self.metrics.counter_add("sample.stall_ms", wait * 1000.0)
                self.tracer.complete(
                    "sample_wait", dur_s=wait, t0=t_idle, cat="sample",
                )
            (requests, reason, flush_id, t0, t_h2d, bucket, uniq,
             cached_rows, prepared, version) = item
            try:
                self._execute_prepared(
                    requests, reason, flush_id, t0, t_h2d, bucket, uniq,
                    cached_rows, prepared, version,
                )
            except BaseException as e:  # mirror MicroBatcher._loop
                log.warning(
                    "pipelined flush failed (%s): %s", type(e).__name__, e
                )
                self.tracer.complete(
                    "batch_flush", dur_s=time.perf_counter() - t0, t0=t0,
                    cat="serve", flush_id=flush_id, reason=reason,
                    n_requests=len(requests), error=type(e).__name__,
                )
                for r in requests:
                    if not r.done():
                        r._complete(None, "error", e)
            finally:
                self._answered()

    def _execute_prepared(self, requests, reason, flush_id, t0, t_h2d,
                          bucket, uniq, cached_rows, prepared,
                          version: int = 0) -> None:
        t_exec0 = time.perf_counter()
        # the producer->executor queue wait: without this stage the serve
        # critical path's stage sum would silently undershoot the recorded
        # latency by exactly the handoff time in pipelined mode
        self.tracer.complete(
            "handoff", dur_s=t_exec0 - t_h2d, t0=t_h2d, cat="serve",
            flush_id=flush_id,
        )
        rows: Dict[int, np.ndarray] = dict(cached_rows)
        if prepared is not None:
            if getattr(self.engine, "fused", False):
                # one replay: sample+execute inside the fused bucket graph
                logits = self.engine.execute_fused_prepared(prepared, bucket)
            else:
                logits = self.engine.execute_prepared(prepared, bucket)
            for i, vid in enumerate(uniq.tolist()):
                rows[vid] = logits[i]
            # a delta waits for this flush before it lands (drain_prepared),
            # so the version still matches; the check keeps pre-delta logits
            # out of the cache should one ever pass
            if version == self._graph_version:
                self.cache.insert(uniq, logits[: len(uniq)])
        t_exec = time.perf_counter()
        exec_ms = (t_exec - t0) * 1000.0
        for r in requests:
            out = np.stack([rows[v] for v in r.node_ids.tolist()])
            status = "cached" if all(
                v in cached_rows for v in r.node_ids.tolist()
            ) else "ok"
            r._complete(out, status)
        t_reply = time.perf_counter()
        for name, a, b in (
            ("execute", t_exec0, t_exec),
            ("reply", t_exec, t_reply),
        ):
            self.tracer.complete(
                name, dur_s=b - a, t0=a, cat="serve", flush_id=flush_id,
            )
        n_seeds = len(uniq) if uniq is not None else 0
        self.tracer.complete(
            "batch_flush", dur_s=t_reply - t0, t0=t0, cat="serve",
            flush_id=flush_id, reason=reason, n_requests=len(requests),
            bucket=bucket, n_seeds=n_seeds,
        )
        self._record(requests, reason, bucket, n_seeds, exec_ms, flush_id)

    def _lineage(self):
        """(graph_seq, model_seq) for the freshness-lineage span fields:
        which delta-log seq and which checkpoint step answered. Never
        raises: lineage is best-effort telemetry."""
        graph_seq = None
        if self.graph_seq_source is not None:
            try:
                v = self.graph_seq_source()
                graph_seq = int(v) if v is not None else None
            except Exception:
                graph_seq = None
        return graph_seq, int(self.engine.ckpt_step)

    def _record(self, requests: List[ServeRequest], reason: str,
                bucket: Optional[int], n_seeds: int, exec_ms: float,
                flush_id: Optional[int] = None) -> None:
        now = time.perf_counter()
        with self._stats_lock:
            if self._t_first is None:
                self._t_first = requests[0].t_submit
            self._t_last = now
            self.request_count += len(requests)
        if self.metrics is None:
            return
        self.metrics.counter_add("serve.batches")
        self.metrics.counter_add("serve.requests", len(requests))
        if bucket is not None:
            self.metrics.counter_add("serve.computed_seeds", n_seeds)
            self.metrics.counter_add(
                "serve.padded_seeds", max(bucket - n_seeds, 0)
            )
        self.metrics.observe("serve.exec", exec_ms / 1000.0)
        # flush-stage + per-bucket latency distributions (obs/hist): the
        # registry histograms are what stats()/serve_summary report, what
        # the SLO engine windows over, and what the stream's `hist`
        # records persist — no raw-record full-sorts anywhere downstream
        self.metrics.hist_observe("serve.exec_ms", exec_ms)
        if bucket is not None:
            self.metrics.hist_observe(
                f"serve.exec_ms.bucket_{bucket}", exec_ms
            )
        self.metrics.event(
            "batch_flush", n_requests=len(requests), n_seeds=n_seeds,
            reason=reason, bucket=bucket, exec_ms=exec_ms,
            flush_id=flush_id,
        )
        graph_seq, model_seq = self._lineage()
        for r in requests:
            if r.status == "cached":
                self.metrics.counter_add("serve.cached_requests")
            if r.total_ms is not None:
                self.metrics.hist_observe("serve.latency_ms", r.total_ms)
            if r.queue_ms is not None:
                self.metrics.hist_observe("serve.queue_ms", r.queue_ms)
            self.metrics.event(
                "serve_request", n_seeds=len(r.node_ids), status=r.status,
                total_ms=r.total_ms, queue_ms=r.queue_ms,
                req_id=r.req_id, flush_id=flush_id,
            )
            if r.t_done is None or r.t_flush is None:
                continue
            # request lifecycle spans, retroactive from the recorded
            # perf_counter marks (same clock domain as the tracer). When
            # the request arrived over the wire (r.ctx), the span joins
            # the caller's trace — parented under the exporter's handler
            # span, carrying the (send_ts, recv_ts) clock pair and the
            # graph_seq/model_seq freshness lineage.
            span = self.tracer.complete(
                "request", dur_s=r.t_done - r.t_submit, t0=r.t_submit,
                cat="serve", ctx=r.ctx, req_id=r.req_id, status=r.status,
                n_seeds=len(r.node_ids), flush_id=flush_id,
                graph_seq=graph_seq, model_seq=model_seq,
            )
            queue_ctx = (
                TraceContext(r.ctx.trace_id, span.span_id)
                if r.ctx is not None else None
            )
            self.tracer.complete(
                "queue", dur_s=r.t_flush - r.t_submit, t0=r.t_submit,
                cat="serve", parent=span, ctx=queue_ctx, req_id=r.req_id,
            )
        if self.slo is not None:
            # completions are the SLO engine's observation stream; a tick
            # here keeps burn rates fresh even when no new arrivals are
            # calling the batcher's admission gate
            self.slo.tick()

    # ---- SLO telemetry ---------------------------------------------------
    def _latency_quantiles(self) -> Dict[str, Optional[float]]:
        """{p50, p95, p99} off the live latency histogram — fixed memory
        no matter how many requests were served (the raw-list full-sort
        this replaces grew without bound). hists() copies under the
        registry lock (stats() is called from monitoring threads while
        the flusher mutates the live buckets), and the at-construction
        baseline is subtracted so the numbers are THIS server's."""
        h = (
            self.metrics.hists().get("serve.latency_ms")
            if self.metrics is not None else None
        )
        if h is not None:
            h = h.delta(self._lat_baseline)
        if h is None or h.count == 0:
            return {"p50": None, "p95": None, "p99": None}
        return h.quantiles()

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            span = (
                self._t_last - self._t_first
                if self._t_first is not None and self._t_last is not None
                else None
            )
            served = self.request_count
        lat = self._latency_quantiles()
        rps = served / span if span and span > 0 else None
        return {
            "requests": served,
            "shed": self.batcher.shed_count,
            "latency_ms": lat,
            "throughput_rps": rps,
            "cache": self.cache.stats(),
            "compile_counts": dict(self.engine.compile_counts),
        }

    def close(self) -> Dict[str, Any]:
        """Drain the queue, emit the consolidated serve_summary record, and
        return the stats dict (idempotent)."""
        if self._closed:
            return self.stats()
        self._closed = True
        self.batcher.close()
        if self._exec_thread is not None:
            # the batcher has drained: everything is enqueued; the sentinel
            # lands behind the last prepared flush (FIFO), so the executor
            # finishes real work first
            self._prep_q.put(None)
            self._exec_thread.join(timeout=60.0)
        if self.slo is not None:
            self.slo.close()  # final forced evaluation -> last slo_status
        s = self.stats()
        if self.metrics is not None:
            # final cumulative hist snapshots BEFORE the summary: the
            # stream's quantiles survive rotation, and downstream
            # consumers (serve_bench, metrics_report) read these instead
            # of full-sorting raw serve_request records
            self.metrics.emit_hists()
            snap = self.metrics.snapshot()
            self.metrics.event(
                "serve_summary",
                requests=s["requests"],
                shed=s["shed"],
                latency_ms=s["latency_ms"],
                throughput_rps=s["throughput_rps"],
                counters=snap["counters"],
                gauges=snap["gauges"],
                hists=snap["hists"],
                cache=s["cache"],
                compile_counts={
                    str(k): v for k, v in s["compile_counts"].items()
                },
                ckpt_step=self.engine.ckpt_step,
            )
            self.metrics.close()
        return s


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    from neutronstarlite_torch.utils.config import InputInfo

    ap = argparse.ArgumentParser(
        prog="python -m neutronstarlite_torch.serve.server",
        description="serve a trained checkpoint: load, build the bucket "
        "ladder, answer --requests random per-node predictions, print SLOs"
    )
    ap.add_argument("cfg", help="training .cfg (LAYERS/FANOUT/paths)")
    ap.add_argument("ckpt", nargs="?", default="",
                    help="checkpoint dir (default: the cfg's CHECKPOINT_DIR)")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--seeds-per-request", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", choices=("cpu", "cuda"), default=None,
        help="serving device (default: the CUDA card; raises when there is none)",
    )
    args = ap.parse_args(argv)

    cfg = InputInfo.read_from_cfg_file(args.cfg)
    base_dir = os.path.dirname(os.path.abspath(args.cfg))
    try:
        engine = InferenceEngine.from_config(
            cfg, base_dir=base_dir, ckpt_dir=args.ckpt,
            rng=np.random.default_rng(args.seed), device=args.device,
        )
    except ServeSetupError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    engine.warmup()
    server = InferenceServer(engine)
    rng = np.random.default_rng(args.seed + 1)
    v_num = engine.toolkit.host_graph.v_num
    pending = [
        server.submit(rng.integers(0, v_num, size=args.seeds_per_request))
        for _ in range(args.requests)
    ]
    errors = 0
    for req in pending:
        try:
            req.result(timeout=120.0)
        except Exception:
            errors += 1
    s = server.close()
    lat = s["latency_ms"]

    def _fmt(v):
        return f"{v:.2f}ms" if v is not None else "n/a"

    print(
        f"served {s['requests']} requests (shed {s['shed']}, errors {errors})"
        f" | p50 {_fmt(lat['p50'])} p95 {_fmt(lat['p95'])} "
        f"p99 {_fmt(lat['p99'])}"
        + (f" | {s['throughput_rps']:.1f} req/s"
           if s["throughput_rps"] else "")
    )
    if engine.metrics is not None and engine.metrics.path:
        print(f"metrics stream: {engine.metrics.path}")
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
