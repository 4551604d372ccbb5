"""Merge per-rank span streams into one causal timeline.

Port of ``neutronstarlite_tpu/tools/trace_timeline.py``, copied: only the
import paths differ. It reads the obs streams of either package; the
``--fleet`` join merges a router's and its replicas' streams.

The span records (obs/trace.py) land in per-rank JSONL files with
process-local monotonic clocks. This CLI reconstructs one coherent view:

1. **mono->wall recovery** per stream: a span record is written
   immediately after its span ends, so the envelope wall-clock ``ts``
   sits just past ``t0 + dur_s`` — ``median(ts - (t0 + dur_s))`` over a
   stream's spans is that process's monotonic->wall offset (robust to a
   few delayed writes; see docs/OBSERVABILITY.md for the caveats).
2. **epoch-marker rank alignment**: every rank ends epoch *e* at the same
   collective barrier, so per-epoch spans are cross-rank fence posts —
   each rank is shifted by the median difference of its epoch-end times
   against the reference (lowest) rank. Wall clocks that agree within the
   epoch time are left essentially untouched; skewed hosts snap into
   place.
3. **Chrome trace-event export** (``--chrome out.json``): complete ("X")
   events per span (pid = rank, tid = host thread), instant events for
   fault / recovery / shed / rank_loss / replan / tune_trial /
   tune_decision records — loadable in
   Perfetto or chrome://tracing. When the run also wrote a ``jax.profiler`` trace
   (``NTS_PROFILE_DIR``), the host spans were emitted as
   ``TraceAnnotation``s inside it too, so the device-op view carries the
   same names — open both in one Perfetto window to line host causality
   up with kernel truth.
4. **Derived metrics** printed as the timeline report (and rendered by
   tools/metrics_report as its "span timeline" block):
   - ring overlap efficiency — the NTS_OVERLAP_PROBE verdict (hop time
     hidden under blocked-kernel compute / total hop time);
   - serve critical path — per-request stage breakdown
     (queue -> cache_lookup -> sample -> execute -> reply), joined to the
     ``serve_request`` records by ``req_id``; the stage sum must match
     the recorded end-to-end latency (the tests pin the tolerance);
   - retry cost — per fault episode, time from the fault record to the
     first epoch completed after recovery, plus replayed-epoch counts;
   - elastic time-to-recover — per survivor replan, the time from the
     rank_loss detection record to the first post-replan epoch end.

5. **Cross-PROCESS fleet merge** (``--fleet``): the serve fabric's
   streams (router + N replica processes) share no epoch barriers, so
   step 2 cannot align them. They DO share distributed-trace clock
   pairs: every traced HTTP hop stamps the client's wall clock into the
   ``X-NTS-Send-Ts`` header and the server's at extraction, so each
   server-side handler span carries ``(send_ts, recv_ts)`` — two wall
   clocks taken one network hop apart — and its ``parent_id`` names the
   client-side span (in a DIFFERENT stream) whose envelope ``ts`` closes
   the exchange. NTP-style per pair, with t0=send_ts (client),
   t1=recv_ts (server), t2=server envelope ts (~reply write),
   t3=client envelope ts (~response received)::

       offset(server-client) = ((t1-t0) + (t2-t3)) / 2
       rtt                   = (t3-t0) - (t2-t1)

   The estimate's error is bounded by rtt/2 (the classic NTP bound: the
   true offset lies within ±rtt/2 of the estimate, reached only when the
   hop is fully asymmetric). Per connected stream the shift applied is
   the MEDIAN offset over its pairs, chained transitively (bounds add)
   when a stream only reaches the reference through another process.
   Streams with no pairs keep their own wall clock and a warning names
   why (the same warn-not-crash taxonomy as step 2). The fleet-merged
   Chrome export gives each PROCESS its own pid, and the per-request
   report joins spans by ``trace_id`` into client->router->replica->
   engine chains: complete-chain fraction, ``router_overhead_ms =
   client_latency - replica_stage_sum``, retry/re-route/suspect counts,
   and the prediction freshness lineage (``graph_seq``/``model_seq``).

Usage:
  python -m neutronstarlite_torch.tools.trace_timeline <file-or-dir> [...]
      [--chrome OUT.json] [--json] [--fleet]
Exit 0 when at least one stream yielded a timeline; 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neutronstarlite_torch.tools.metrics_report import (  # noqa: E402
    expand_paths,
    load_events,
)


def _median(vals: List[float]) -> Optional[float]:
    return statistics.median(vals) if vals else None


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolation quantile over an ALREADY-SORTED list."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def spans_of(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [e for e in events if e["event"] == "span"]


def stream_rank(events: List[Dict[str, Any]], path: str) -> int:
    """Rank of one stream: run_start.process_index, span.rank, or the
    ``-pN.jsonl`` filename convention; 0 when nothing says otherwise."""
    for e in events:
        if e["event"] == "run_start" and isinstance(
            e.get("process_index"), int
        ):
            return e["process_index"]
    for e in events:
        if e["event"] == "span" and isinstance(e.get("rank"), int):
            return e["rank"]
    stem = os.path.basename(path)
    if "-p" in stem:
        tail = stem.rsplit("-p", 1)[1].split(".", 1)[0]
        if tail.isdigit():
            return int(tail)
    return 0


def mono_wall_offset(events: List[Dict[str, Any]]) -> Optional[float]:
    """Monotonic->wall offset for one stream (docstring step 1)."""
    return _median([
        e["ts"] - (e["t0"] + e["dur_s"]) for e in spans_of(events)
    ])


class Stream:
    """One per-rank JSONL file with its clock corrections resolved."""

    def __init__(self, path: str, events: List[Dict[str, Any]]):
        self.path = path
        self.events = events
        self.rank = stream_rank(events, path)
        self.pid = self.rank  # Chrome pid; fleet mode re-keys per PROCESS
        self.offset = mono_wall_offset(events)  # mono -> wall (step 1)
        self.align = 0.0  # cross-rank/process shift (step 2 or 5)
        self.skew_bound: Optional[float] = None  # fleet_align's rtt/2 bound
        self.align_warning: Optional[str] = None  # set by align_streams
        self.run_id = next(
            (e["run_id"] for e in events if e.get("run_id")), "?"
        )

    def span_wall(self, span: Dict[str, Any]) -> Optional[float]:
        """Aligned wall-clock start of ``span`` (None without an offset —
        a stream with no spans has nothing to place on the timeline)."""
        if self.offset is None:
            return None
        return span["t0"] + self.offset + self.align

    def epoch_ends(self) -> Dict[int, float]:
        """{epoch: aligned wall end} from this stream's epoch spans."""
        out: Dict[int, float] = {}
        if self.offset is None:
            return out
        for s in spans_of(self.events):
            if s["name"] == "epoch" and isinstance(s.get("epoch"), int):
                out[s["epoch"]] = (
                    s["t0"] + s["dur_s"] + self.offset + self.align
                )
        return out


def align_streams(streams: List["Stream"]) -> None:
    """Epoch-marker alignment (docstring step 2), in place: the lowest
    rank with epoch spans anchors; every other stream shifts by the median
    epoch-end difference over shared epochs. Streams sharing no epochs
    (e.g. a serve-only stream next to a training stream) keep wall time.

    Failure mode is WARN, not crash: a span-bearing stream with no epoch
    markers (or none shared with the anchor) cannot be cross-rank
    corrected — it keeps its own wall clock (``align=0``), which may sit
    skewed against the other ranks by each host's clock error. The
    stream's ``align_warning`` names the reason and a stderr line
    surfaces it, so a skewed-looking timeline says WHY instead of
    silently interleaving misaligned ranks."""
    anchored = sorted(
        (s for s in streams if s.epoch_ends()), key=lambda s: s.rank
    )
    if not anchored:
        for s in streams:
            if any(True for _ in spans_of(s.events)):
                s.align_warning = (
                    "no stream carries epoch spans: cross-rank alignment "
                    "skipped (each stream keeps its own wall clock)"
                )
                print(f"{s.path}: {s.align_warning}", file=sys.stderr)
        return
    ref = anchored[0].epoch_ends()
    aligned_ids = {id(a) for a in anchored}
    for s in anchored[1:]:
        own = s.epoch_ends()
        deltas = [ref[e] - own[e] for e in ref.keys() & own.keys()]
        d = _median(deltas)
        if d is not None:
            s.align = d
        else:
            s.align_warning = (
                f"shares no epochs with the anchor (rank "
                f"{anchored[0].rank}): cross-rank alignment skipped for "
                "this stream (kept on its own wall clock)"
            )
            print(f"{s.path}: warning: {s.align_warning}", file=sys.stderr)
    for s in streams:
        if id(s) in aligned_ids or s.offset is None:
            continue
        # spans but no epoch markers at all (a serve/probe stream, or a
        # trainer that died before epoch 0 closed)
        s.align_warning = (
            "stream has spans but no epoch markers: cross-rank alignment "
            "skipped for this stream (kept on its own wall clock)"
        )
        print(f"{s.path}: warning: {s.align_warning}", file=sys.stderr)


def load_streams(paths: List[str], fleet: bool = False) -> List[Stream]:
    """Load + align. ``fleet=True`` switches step-2 epoch alignment for
    the step-5 clock-pair alignment (serve-fabric processes share no
    epoch barriers, so epoch alignment is meaningless across them)."""
    streams = []
    for p in paths:
        try:
            events = load_events(p)
        except OSError as e:
            print(f"{p}: {e}", file=sys.stderr)
            continue
        if events:
            streams.append(Stream(p, events))
    if fleet:
        fleet_align(streams)
    else:
        align_streams(streams)
    return streams


# ---------------------------------------------------------------------------
# Cross-process fleet merge (docstring step 5)
# ---------------------------------------------------------------------------


def clock_pairs(streams: List[Stream]) -> Dict[tuple, List[tuple]]:
    """Collect the distributed-trace clock pairs between streams.

    A pair comes from one traced HTTP hop: the SERVER-side span carries
    ``send_ts`` (client wall, from the X-NTS-Send-Ts header) and
    ``recv_ts`` (server wall at extraction) as attributes, and its
    ``parent_id`` names the CLIENT-side span — which must live in a
    DIFFERENT stream. (Replica-internal spans inherit the stamps via the
    handler's context but parent within their own stream, so the
    different-stream rule keeps them out of the clock estimate.)

    Returns ``{(client_idx, server_idx): [(offset_s, rtt_s), ...]}``
    with ``offset = server_wall - client_wall``.
    """
    # client-span index: (trace_id, span_id) -> stream idx + envelope ts
    client_idx: Dict[tuple, tuple] = {}
    for i, st in enumerate(streams):
        for s in spans_of(st.events):
            client_idx[(s.get("trace_id"), s["span_id"])] = (i, s["ts"])
    edges: Dict[tuple, List[tuple]] = {}
    for j, st in enumerate(streams):
        for s in spans_of(st.events):
            send_ts = s.get("send_ts")
            recv_ts = s.get("recv_ts")
            if send_ts is None or recv_ts is None or not s.get("parent_id"):
                continue
            hit = client_idx.get((s.get("trace_id"), s["parent_id"]))
            if hit is None or hit[0] == j:
                continue
            i, t3 = hit
            t0, t1, t2 = float(send_ts), float(recv_ts), float(s["ts"])
            offset = ((t1 - t0) + (t2 - t3)) / 2.0
            rtt = (t3 - t0) - (t2 - t1)
            edges.setdefault((i, j), []).append((offset, max(rtt, 0.0)))
    return edges


def fleet_align(streams: List[Stream]) -> Dict[str, Any]:
    """Clock-pair alignment across PROCESSES, in place.

    The reference is the stream with the most client-side hops (the
    router — it talks to everyone). Every stream reachable through clock
    pairs is shifted by the median pair offset onto the reference's wall
    clock, chaining transitively (BFS; error bounds add per hop, each
    hop's bound = min rtt/2 over its pairs — the NTP bound). Streams
    with spans but no pairs keep their own wall clock and get an
    ``align_warning`` (warn, not crash). Also re-keys ``Stream.pid`` per
    process so the Chrome export separates processes that share rank 0.
    """
    for i, st in enumerate(streams):
        st.pid = i
    info: Dict[str, Any] = {"reference": None, "streams": []}
    edges = clock_pairs(streams)
    delta: Dict[int, tuple] = {}
    if edges:
        # undirected adjacency with a signed median offset per edge
        adj: Dict[int, Dict[int, tuple]] = {}
        client_hops = [0] * len(streams)
        for (i, j), pairs in edges.items():
            client_hops[i] += len(pairs)
            med = statistics.median(p[0] for p in pairs)
            bound = min(p[1] for p in pairs) / 2.0
            # offset(j - i) = med; store both directions
            adj.setdefault(i, {})[j] = (med, bound, len(pairs))
            adj.setdefault(j, {})[i] = (-med, bound, len(pairs))
        ref = max(range(len(streams)), key=lambda k: client_hops[k])
        info["reference"] = streams[ref].path
        # BFS: delta[k] = wall(k) - wall(ref); mapping k onto the
        # reference timeline subtracts it (align = -delta)
        delta[ref] = (0.0, 0.0)
        frontier = [ref]
        while frontier:
            nxt = []
            for u in frontier:
                du, bu = delta[u]
                for v, (off, bound, _n) in adj.get(u, {}).items():
                    if v in delta:
                        continue
                    delta[v] = (du + off, bu + bound)
                    nxt.append(v)
            frontier = nxt
        for k, (d, b) in delta.items():
            st = streams[k]
            if k != ref:
                st.align = -d
            st.skew_bound = b
            info["streams"].append({
                "path": st.path, "pid": st.pid,
                "offset_vs_ref_s": d, "skew_bound_s": b,
            })
    for i, st in enumerate(streams):
        if i in delta:
            continue
        if spans_of(st.events):
            st.align_warning = (
                "no distributed-trace clock pairs reach this stream: "
                "fleet alignment skipped (kept on its own wall clock)"
            )
            print(f"{st.path}: warning: {st.align_warning}",
                  file=sys.stderr)
    return info


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

_INSTANT_KINDS = ("fault", "recovery", "shed", "rank_loss", "replan",
                  "tune_trial", "tune_decision", "slo_status",
                  "backend_probe", "delta_commit", "finetune_round")
_ENVELOPE_OR_SPAN = (
    "event", "run_id", "schema", "ts", "seq", "name", "cat", "span_id",
    "trace_id", "parent_id", "t0", "dur_s", "rank", "thread",
)


def chrome_trace(streams: List[Stream]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` container form).

    pid = rank (or one pid per PROCESS after ``fleet_align`` — serve
    fabrics share rank 0 across processes), tid = one int per
    (pid, host thread); metadata records name both. Spans become
    complete ("X") events; fault/recovery/shed records become
    process-scoped instants ("i")."""
    events: List[Dict[str, Any]] = []
    starts: List[float] = []
    for st in streams:
        for s in spans_of(st.events):
            w = st.span_wall(s)
            if w is not None:
                starts.append(w)
        if st.offset is not None:
            for e in st.events:
                if e["event"] in _INSTANT_KINDS:
                    starts.append(e["ts"] + st.align)
    t0 = min(starts) if starts else 0.0

    tids: Dict[tuple, int] = {}
    for st in streams:
        events.append({
            "ph": "M", "name": "process_name", "pid": st.pid, "tid": 0,
            "ts": 0,
            "args": {"name": f"rank {st.rank} · {st.run_id}"},
        })
        for s in spans_of(st.events):
            w = st.span_wall(s)
            if w is None:
                continue
            key = (st.pid, s.get("thread") or "main")
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids) + 1
                events.append({
                    "ph": "M", "name": "thread_name", "pid": st.pid,
                    "tid": tid, "ts": 0, "args": {"name": key[1]},
                })
            args = {
                k: v for k, v in s.items()
                if k not in _ENVELOPE_OR_SPAN and v is not None
            }
            args["span_id"] = s["span_id"]
            if s.get("parent_id"):
                args["parent_id"] = s["parent_id"]
            events.append({
                "ph": "X",
                "name": s["name"],
                "cat": s.get("cat") or "host",
                "pid": st.pid,
                "tid": tid,
                "ts": (w - t0) * 1e6,
                "dur": s["dur_s"] * 1e6,
                "args": args,
            })
        if st.offset is None:
            continue
        for e in st.events:
            if e["event"] not in _INSTANT_KINDS:
                continue
            label = (
                e.get("kind") or e.get("action") or e.get("reason") or ""
            )
            if e["event"] in ("tune_trial", "tune_decision"):
                # the candidate tuple (and decision source), readable off
                # the marker name in Perfetto
                label = str(e.get("candidate") or "?")
                if e["event"] == "tune_decision":
                    label = f"{label} [{e.get('source')}]"
            if e["event"] == "replan":
                # the elastic degradation, readable off the marker name
                label = (
                    f"{e.get('from_partitions')}->{e.get('to_partitions')}"
                )
            if e["event"] == "slo_status":
                # the burn-rate verdict, readable off the marker name
                label = f"{e.get('metric')}={e.get('state')}"
            if e["event"] == "backend_probe":
                label = f"attempt{e.get('attempt')}:{e.get('outcome')}"
            events.append({
                "ph": "i",
                "name": f"{e['event']}:{label}",
                "cat": "marker",
                "pid": st.pid,
                "tid": 0,
                "ts": (e["ts"] + st.align - t0) * 1e6,
                "s": "p",
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Any) -> int:
    """Structural check of a Chrome trace-event JSON object; returns the
    event count, raises ValueError on the first violation. This is the
    schema the tests (and any CI consumer) pin."""
    def fail(msg):
        raise ValueError(f"chrome trace: {msg}")

    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        fail("top level must be an object with a traceEvents array")
    for i, e in enumerate(trace["traceEvents"]):
        if not isinstance(e, dict):
            fail(f"traceEvents[{i}] is not an object")
        if e.get("ph") not in ("X", "i", "M"):
            fail(f"traceEvents[{i}].ph {e.get('ph')!r} not in X/i/M")
        if not isinstance(e.get("name"), str) or not e["name"]:
            fail(f"traceEvents[{i}].name must be a non-empty string")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                fail(f"traceEvents[{i}].{key} must be an int")
        if not isinstance(e.get("ts"), (int, float)):
            fail(f"traceEvents[{i}].ts must be a number")
        if e["ph"] == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                fail(f"traceEvents[{i}].dur must be a number >= 0")
            if e["ts"] < 0:
                fail(f"traceEvents[{i}].ts must be >= 0")
    return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# Derived metrics
# ---------------------------------------------------------------------------


def ring_overlap_report(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The NTS_OVERLAP_PROBE verdict: prefers the run_summary gauges, falls
    back to the probe span's attributes (killed run)."""
    for e in reversed(events):
        if e["event"] == "run_summary":
            g = e.get("gauges") or {}
            if "ring.probe_overlap_s" in g:
                return {
                    "efficiency": g.get("ring.overlap_efficiency"),
                    "overlap_s": g.get("ring.probe_overlap_s"),
                    "compute_s": g.get("ring.probe_compute_s"),
                    "exchange_s": g.get("ring.probe_exchange_s"),
                    "simulated": bool(g.get("ring.probe_simulated")),
                }
    for e in reversed(events):
        if e["event"] == "span" and e["name"] == "ring_overlap_probe":
            return {
                "efficiency": e.get("efficiency"),
                "overlap_s": e.get("overlap_s"),
                "compute_s": e.get("compute_s"),
                "exchange_s": e.get("exchange_s"),
                "simulated": bool(e.get("simulated")),
            }
    return None


def sample_pipeline_report(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The async-sampling overlap verdict (sample/pipeline.py): total time
    the producer spent sampling + staging H2D vs the residual time the
    consumer actually waited on the queue. hidden_frac is the share of
    sampling time the pipeline moved off the critical path — 1.0 means the
    consumer never stalled, 0.0 means no overlap (the synchronous bound)."""
    per_run: Dict[Any, Dict[str, float]] = {}
    for s in spans_of(events):
        # cat=sample only: the trainer ALSO rolls the per-epoch stall up
        # into a "sample_wait" stage span (cat=stage) under each epoch —
        # summing both would double-count every wait
        if s.get("cat") != "sample":
            continue
        b = per_run.setdefault(
            s.get("run_id"), {"produce": 0.0, "wait": 0.0, "h2d": 0.0,
                              "n": 0}
        )
        if s["name"] == "sample_produce":
            b["produce"] += s["dur_s"]
            b["n"] += 1
        elif s["name"] == "sample_wait":
            b["wait"] += s["dur_s"]
        elif s["name"] == "h2d_copy":
            b["h2d"] += s["dur_s"]
    # aggregate ONLY runs that actually produced batches: a merged dir can
    # also hold a serve run whose executor emits sample_wait spans with no
    # matching sample_produce — blending those in would deflate the
    # training pipeline's verdict (the same cross-run rule the serve
    # critical path applies via its (run_id, id) join keys)
    rows = [b for b in per_run.values() if b["n"] > 0]
    if not rows:
        return None
    produce_s = sum(b["produce"] for b in rows)
    wait_s = sum(b["wait"] for b in rows)
    h2d_s = sum(b["h2d"] for b in rows)
    n = sum(b["n"] for b in rows)
    busy = produce_s + h2d_s
    return {
        "batches": n,
        "produce_s": produce_s,
        "h2d_s": h2d_s,
        "wait_s": wait_s,
        "hidden_frac": (busy - min(wait_s, busy)) / busy if busy > 0 else None,
    }


# h2d_copy and handoff exist only on the pipelined flush (serve/server.py
# two-stage path); sync flushes simply contribute 0.0 for them, keeping
# the stage-sum ≡ latency contract valid in BOTH modes
SERVE_STAGES = ("queue", "cache_lookup", "sample", "h2d_copy", "handoff",
                "execute", "reply")


def serve_critical_path(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-request stage breakdown from the serve lifecycle spans, joined
    to the ``serve_request`` records by ``req_id``. For each answered
    request: queue (its own span) + the four flush stages of the batch
    that served it (``flush_id`` join). The stage sum reproduces the
    recorded end-to-end latency — ``max_abs_mismatch_ms`` quantifies how
    tightly (tests pin it)."""
    spans = spans_of(events)
    # join keys carry run_id: req_id/flush_id counters restart at 0 in
    # every serving process, and a merged multi-run dir must not cross-join
    # run A's requests to run B's queue/stage spans
    queue_by_req = {
        (s.get("run_id"), s["req_id"]): s for s in spans
        if s["name"] == "queue" and s.get("req_id")
    }
    stages_by_flush: Dict[Any, Dict[str, float]] = {}
    for s in spans:
        if s["name"] in SERVE_STAGES[1:] and s.get("flush_id") is not None:
            stages_by_flush.setdefault(
                (s.get("run_id"), s["flush_id"]), {}
            )[s["name"]] = s["dur_s"] * 1000.0
    recs = [
        e for e in events
        if e["event"] == "serve_request" and e.get("status") != "shed"
        and e.get("req_id") and e.get("total_ms") is not None
    ]
    requests = []
    for r in recs:
        q = queue_by_req.get((r.get("run_id"), r["req_id"]))
        flush = stages_by_flush.get((r.get("run_id"), r.get("flush_id")))
        if q is None or not flush:
            continue
        stages = {"queue": q["dur_s"] * 1000.0}
        stages.update(
            {name: flush.get(name, 0.0) for name in SERVE_STAGES[1:]}
        )
        total = float(r["total_ms"])
        s_sum = sum(stages.values())
        requests.append({
            "req_id": r["req_id"],
            "flush_id": r.get("flush_id"),
            "status": r["status"],
            "total_ms": total,
            "stage_sum_ms": s_sum,
            "mismatch_ms": s_sum - total,
            "stages_ms": stages,
        })
    if not requests:
        return None
    p50 = {
        name: _median([r["stages_ms"][name] for r in requests])
        for name in SERVE_STAGES
    }
    return {
        "requests": requests,
        "n": len(requests),
        "stage_p50_ms": p50,
        "critical_stage": max(p50, key=lambda k: p50[k] or 0.0),
        "max_abs_mismatch_ms": max(
            abs(r["mismatch_ms"]) for r in requests
        ),
    }


def request_chains(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Join the fleet's spans into per-request distributed chains.

    The router stamps every request with trace_id ``run_id:req_id``, so
    one trace groups: the ``fleet_request`` root, its route/re-route/
    backoff/suspect/shed decisions, the ``predict_post`` client span
    (+ ``http_retry`` children), the replica's ``predict_handler`` and
    ``request``/``queue`` spans — and through the request span's
    ``(replica run_id, flush_id)`` the engine-side flush stage spans,
    which carry the replica's OWN trace_id (they serve a whole batch,
    not one request). A chain is COMPLETE when the client->router->
    replica->engine legs are all present:
    root + predict_post + predict_handler + request + an execute stage.

    ``router_overhead_ms = total_ms - replica_stage_sum_ms`` — what the
    fabric (routing, HTTP, queueing gaps between recorded stages) added
    on top of the replica's own stage time.
    """
    spans = spans_of(events)
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        if s.get("trace_id"):
            by_trace.setdefault(s["trace_id"], []).append(s)
    stages_by_flush: Dict[Any, Dict[str, float]] = {}
    for s in spans:
        if s["name"] in SERVE_STAGES[1:] and s.get("flush_id") is not None:
            stages_by_flush.setdefault(
                (s.get("run_id"), s["flush_id"]), {}
            )[s["name"]] = s["dur_s"] * 1000.0
    chains: List[Dict[str, Any]] = []
    for tid, group in sorted(by_trace.items()):
        root = next(
            (s for s in group if s["name"] == "fleet_request"), None
        )
        if root is None:
            continue
        request = next((s for s in group if s["name"] == "request"), None)
        queue = next((s for s in group if s["name"] == "queue"), None)
        posts = [s for s in group if s["name"] == "predict_post"]
        handlers = [s for s in group if s["name"] == "predict_handler"]
        stage_ms: Dict[str, float] = {}
        if request is not None and request.get("flush_id") is not None:
            stage_ms.update(stages_by_flush.get(
                (request.get("run_id"), request["flush_id"])
            ) or {})
        if queue is not None:
            stage_ms["queue"] = queue["dur_s"] * 1000.0
        total_ms = root["dur_s"] * 1000.0
        complete = bool(
            posts and handlers and request is not None
            and "execute" in stage_ms
        )
        replica_sum = sum(stage_ms.values()) if stage_ms else None
        chains.append({
            "trace_id": tid,
            "req_id": root.get("req_id"),
            "status": root.get("status"),
            "complete": complete,
            "total_ms": total_ms,
            "replica_stage_sum_ms": replica_sum,
            "router_overhead_ms": (
                total_ms - replica_sum if complete else None
            ),
            "stages_ms": stage_ms,
            "n_posts": len(posts),
            "n_retries": sum(
                1 for s in group if s["name"] == "http_retry"
            ),
            "n_reroutes": sum(
                1 for s in group if s["name"] == "re_route"
            ),
            "n_suspects": sum(
                1 for s in group if s["name"] == "suspect"
            ),
            "n_sheds": sum(1 for s in group if s["name"] == "shed"),
            "graph_seq": request.get("graph_seq") if request else None,
            "model_seq": request.get("model_seq") if request else None,
            "replica_run_id": (
                request.get("run_id") if request else None
            ),
            "target": root.get("target"),
        })
    return chains


def request_tracing_report(
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The fleet-merged per-request verdict: complete-chain fraction
    (over requests answered ok), router-overhead quantiles over complete
    chains, fabric-event totals, and the freshness lineage summary
    (which graph/model versions answered)."""
    chains = request_chains(events)
    if not chains:
        return None
    ok = [c for c in chains if c["status"] == "ok"]
    complete = [c for c in ok if c["complete"]]
    overhead = sorted(
        c["router_overhead_ms"] for c in complete
        if c["router_overhead_ms"] is not None
    )
    return {
        "n_traces": len(chains),
        "n_ok": len(ok),
        "n_complete": len(complete),
        "complete_frac": (
            len(complete) / len(ok) if ok else 0.0
        ),
        "router_overhead_p50_ms": _quantile(overhead, 0.50),
        "router_overhead_p95_ms": _quantile(overhead, 0.95),
        "router_overhead_p99_ms": _quantile(overhead, 0.99),
        "retries": sum(c["n_retries"] for c in chains),
        "reroutes": sum(c["n_reroutes"] for c in chains),
        "suspects": sum(c["n_suspects"] for c in chains),
        "sheds": sum(c["n_sheds"] for c in chains),
        "graph_seqs": sorted({
            c["graph_seq"] for c in chains
            if c["graph_seq"] is not None
        }),
        "model_seqs": sorted({
            c["model_seq"] for c in chains
            if c["model_seq"] is not None
        }),
        "chains": chains,
    }


def request_tracing_block(events: List[Dict[str, Any]]) -> List[str]:
    """The "request tracing:" lines tools/metrics_report embeds (and the
    fleet CLI prints): complete-chain fraction, router-overhead
    quantiles, fabric-event totals, freshness lineage."""
    rep = request_tracing_report(events)
    if rep is None:
        return []

    def ms(v):
        return f"{v:.3f}" if v is not None else "n/a"

    lines = ["request tracing:"]
    lines.append(
        f"#traces={rep['n_traces']} ok={rep['n_ok']} "
        f"complete={rep['n_complete']} "
        f"(complete_chain_frac={rep['complete_frac']:.3f})"
    )
    lines.append(
        f"#router_overhead_ms=p50:{ms(rep['router_overhead_p50_ms'])} "
        f"p95:{ms(rep['router_overhead_p95_ms'])} "
        f"p99:{ms(rep['router_overhead_p99_ms'])}"
    )
    lines.append(
        f"#fabric_events=retries:{rep['retries']} "
        f"reroutes:{rep['reroutes']} suspects:{rep['suspects']} "
        f"sheds:{rep['sheds']}"
    )
    if rep["graph_seqs"] or rep["model_seqs"]:
        gs = rep["graph_seqs"]
        lines.append(
            "#lineage=graph_seq["
            + (f"{gs[0]}..{gs[-1]}" if len(gs) > 1
               else (str(gs[0]) if gs else "n/a"))
            + "] model_seq["
            + (",".join(str(m) for m in rep["model_seqs"])
               if rep["model_seqs"] else "n/a")
            + "]"
        )
    return lines


def retry_report(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per fault episode: the recovery action taken and the time from the
    fault record to the first epoch completed afterwards (end-to-end
    retry cost, backoff + restore + replay included)."""
    faults = [e for e in events if e["event"] == "fault"]
    if not faults:
        return None
    recoveries = [e for e in events if e["event"] == "recovery"]
    epochs = [e for e in events if e["event"] == "epoch"]
    episodes = []
    for f in faults:
        # same-run pairing only: a merged multi-run dir must not heal one
        # run's fault with the first epoch another run happens to finish
        rid = f.get("run_id")
        action = next(
            (r for r in recoveries
             if r.get("run_id") == rid and r["ts"] >= f["ts"]), None
        )
        healed = next(
            (e for e in epochs
             if e.get("run_id") == rid and e["ts"] > f["ts"]), None
        )
        episodes.append({
            "kind": f.get("kind"),
            "epoch": f.get("epoch"),
            "attempt": f.get("attempt"),
            "action": action.get("action") if action else None,
            "recover_s": (healed["ts"] - f["ts"]) if healed else None,
        })
    replayed = 0
    for e in reversed(events):
        if e["event"] == "run_summary":
            replayed = int(
                (e.get("counters") or {}).get(
                    "resilience.replayed_epochs", 0
                )
            )
            break
    recovered = [p["recover_s"] for p in episodes if p["recover_s"]]
    return {
        "episodes": episodes,
        "n": len(episodes),
        "replayed_epochs": replayed,
        "mean_recover_s": (
            sum(recovered) / len(recovered) if recovered else None
        ),
    }


def elastic_report(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The elastic degraded-mode verdict: per ``replan`` episode, the
    time from the triggering ``rank_loss`` detection record to the first
    post-replan epoch end — end-to-end time-to-recover, plan rebuild +
    checkpoint restore + recompile included."""
    replans = [e for e in events if e["event"] == "replan"]
    if not replans:
        return None
    losses = [e for e in events if e["event"] == "rank_loss"]
    epochs = [e for e in events if e["event"] == "epoch"]
    episodes = []
    for r in replans:
        # same-run pairing only (the retry_report rule): a merged dir
        # must not heal one run's rank loss with another run's epochs
        rid = r.get("run_id")
        trigger = next(
            (x for x in reversed(losses)
             if x.get("run_id") == rid and x["ts"] <= r["ts"]), None
        )
        healed = next(
            (x for x in epochs
             if x.get("run_id") == rid and x["ts"] > r["ts"]), None
        )
        episodes.append({
            "from_partitions": r.get("from_partitions"),
            "to_partitions": r.get("to_partitions"),
            "lost": r.get("lost"),
            "recover_s": (
                healed["ts"] - trigger["ts"]
                if healed is not None and trigger is not None else None
            ),
        })
    recovered = [e["recover_s"] for e in episodes
                 if e["recover_s"] is not None]
    return {
        "episodes": episodes,
        "n": len(episodes),
        "mean_recover_s": (
            sum(recovered) / len(recovered) if recovered else None
        ),
    }


def span_inventory(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    by_name: Dict[str, Dict[str, float]] = {}
    for s in spans_of(events):
        b = by_name.setdefault(s["name"], {"count": 0, "total_s": 0.0})
        b["count"] += 1
        b["total_s"] += s["dur_s"]
    return by_name


def timeline_block(events: List[Dict[str, Any]]) -> List[str]:
    """The "span timeline" lines tools/metrics_report embeds under each
    run's #key=value block (one stream's events; empty without spans)."""
    inv = span_inventory(events)
    if not inv:
        return []
    lines = ["span timeline:"]
    lines.append(
        "#spans="
        + " ".join(
            f"{name}:{int(b['count'])}({b['total_s'] * 1000:.1f}ms)"
            for name, b in sorted(inv.items())
        )
    )
    ring = ring_overlap_report(events)
    if ring is not None and ring.get("overlap_s") is not None:
        eff = ring.get("efficiency")
        lines.append(
            f"#ring_overlap_efficiency="
            f"{f'{eff:.2f}' if eff is not None else 'n/a'} "
            f"(overlapped={ring['overlap_s'] * 1000:.3f}ms "
            f"compute_only={ring['compute_s'] * 1000:.3f}ms "
            f"exchange_only={ring['exchange_s'] * 1000:.3f}ms"
            f"{', sim rig' if ring.get('simulated') else ''})"
        )
    samp = sample_pipeline_report(events)
    if samp is not None:
        hidden = samp["hidden_frac"]
        lines.append(
            f"#sample_pipeline={samp['batches']} batch(es), "
            f"produce={samp['produce_s'] * 1000:.3f}ms "
            f"h2d={samp['h2d_s'] * 1000:.3f}ms "
            f"consumer_wait={samp['wait_s'] * 1000:.3f}ms "
            f"(hidden_frac="
            f"{f'{hidden:.2f}' if hidden is not None else 'n/a'})"
        )
    serve = serve_critical_path(events)
    if serve is not None:
        p50 = serve["stage_p50_ms"]
        lines.append(
            "#serve_critical_path_p50="
            + " ".join(
                f"{name}:{p50[name]:.3f}ms" for name in SERVE_STAGES
                if p50.get(name) is not None
            )
            + f" (critical={serve['critical_stage']}, n={serve['n']}, "
            f"max|stage_sum-latency|={serve['max_abs_mismatch_ms']:.3f}ms)"
        )
    ela = elastic_report(events)
    if ela is not None:
        last = ela["episodes"][-1]
        mean = ela["mean_recover_s"]
        lines.append(
            f"#elastic={ela['n']} replan(s), last P "
            f"{last['from_partitions']}->{last['to_partitions']} "
            f"(lost partition {last['lost']}), time_to_recover="
            f"{f'{mean:.2f}s' if mean is not None else 'n/a'}"
        )
    retry = retry_report(events)
    if retry is not None:
        mean = retry["mean_recover_s"]
        lines.append(
            f"#retry_cost={retry['n']} episode(s), "
            f"mean_time_to_recover="
            f"{f'{mean:.2f}s' if mean is not None else 'n/a'}, "
            f"replayed_epochs={retry['replayed_epochs']}"
        )
    return lines


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-rank obs span streams into one causal "
        "timeline: Chrome trace export + overlap/critical-path/retry "
        "derived metrics"
    )
    ap.add_argument("paths", nargs="+",
                    help="JSONL file(s) or NTS_METRICS_DIR directories")
    ap.add_argument("--chrome", metavar="OUT.json", default="",
                    help="write Chrome trace-event JSON here "
                    "(Perfetto / chrome://tracing)")
    ap.add_argument("--json", action="store_true",
                    help="emit the derived metrics as one JSON object")
    ap.add_argument("--fleet", action="store_true",
                    help="cross-PROCESS merge: align the router's and "
                    "each replica's streams via distributed-trace clock "
                    "pairs (instead of epoch markers), give each "
                    "process its own Chrome pid, and derive the "
                    "per-request chain report")
    args = ap.parse_args(argv)

    streams = load_streams(expand_paths(args.paths), fleet=args.fleet)
    streams = [s for s in streams if spans_of(s.events)]
    if not streams:
        print("no span records found in the given streams",
              file=sys.stderr)
        return 1

    merged: List[Dict[str, Any]] = []
    for s in streams:
        merged.extend(s.events)
    merged.sort(key=lambda e: e["ts"])

    out: Dict[str, Any] = {
        "streams": [
            {
                "path": s.path,
                "rank": s.rank,
                "pid": s.pid,
                "run_id": s.run_id,
                "spans": len(spans_of(s.events)),
                "mono_wall_offset_s": s.offset,
                "align_shift_s": s.align,
                "skew_bound_s": s.skew_bound,
                "align_warning": s.align_warning,
            }
            for s in streams
        ],
        "ring_overlap": ring_overlap_report(merged),
        "serve_critical_path": serve_critical_path(merged),
        "retries": retry_report(merged),
        "elastic": elastic_report(merged),
        "span_inventory": span_inventory(merged),
    }
    if args.fleet:
        out["request_tracing"] = request_tracing_report(merged)
    if args.chrome:
        trace = chrome_trace(streams)
        validate_chrome_trace(trace)
        with open(args.chrome, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        out["chrome"] = {
            "path": args.chrome, "events": len(trace["traceEvents"]),
        }

    if args.json:
        print(json.dumps(out, default=str))
        return 0

    for s in out["streams"]:
        off = s["mono_wall_offset_s"]
        bound = s["skew_bound_s"]
        print(
            f"== stream rank {s['rank']} · {s['run_id']} — {s['path']}\n"
            f"   {s['spans']} spans, mono->wall offset "
            f"{off:.3f}s, align shift {s['align_shift_s'] * 1000:+.3f}ms"
            + (f", skew bound ±{bound * 1000:.3f}ms"
               if bound is not None else "")
        )
    for line in timeline_block(merged):
        print(line)
    if args.fleet:
        for line in request_tracing_block(merged):
            print(line)
    serve = out["serve_critical_path"]
    if serve is not None:
        worst = max(serve["requests"], key=lambda r: r["total_ms"])
        print(
            f"slowest request {worst['req_id']}: "
            f"{worst['total_ms']:.3f}ms total = "
            + " + ".join(
                f"{worst['stages_ms'][n]:.3f} {n}" for n in SERVE_STAGES
            )
        )
    if "chrome" in out:
        print(
            f"chrome trace: {out['chrome']['events']} events -> "
            f"{out['chrome']['path']} (open in Perfetto; with "
            f"NTS_PROFILE_DIR the same span names appear inside the "
            f"jax.profiler device trace)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
