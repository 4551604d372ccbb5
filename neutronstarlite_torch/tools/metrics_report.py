"""Render obs JSONL metric streams into the reference-shaped report.

Port of ``neutronstarlite_tpu/tools/metrics_report.py``, copied: only the
import paths differ. It reads the obs streams of either package.

The reference prints its epoch attribution as ``#key=value(ms)`` lines from
DEBUGINFO() (toolkits/GCN.hpp:308-353). This CLI reads one or more JSONL
files written under ``NTS_METRICS_DIR`` (or directories of them), validates
each record against the obs schema, and renders:

- per run: the ``#key=value(ms)`` block — epoch timing attribution
  (first/warm/compile-overhead), the PhaseTimers buckets, then non-time
  counters (wire bytes, batches) and memory as ``#key=value`` lines;
- per run: the recovery timeline — every ``fault`` / ``recovery`` (and
  elastic ``rank_loss`` / ``replan``) record (resilience/) with its
  offset from the stream's first event, so a run's
  failure-and-recovery history reads at a glance;
- per run: the elastic-timeline block (``NTS_ELASTIC=1`` runs) —
  heartbeat volume, rank-loss detections, survivor replans with their
  time-to-recover, and the final ``dist.active_partitions``;
- per run: the span timeline block (tools/trace_timeline derived
  metrics) — span inventory, measured ring overlap efficiency, serve
  critical-path breakdown, retry cost — when the stream carries ``span``
  records;
- per run: the latency-histogram block (merged ``hist`` records with
  their bounded-error quantiles), the slo timeline (``slo_status`` +
  ``shed`` records interleaved), and the backend-probe block
  (``backend_probe`` records; probe-only streams — a bench whose backend
  never answered — render as their own small block);
- per run: the program-cost block (``program_cost`` records, obs/cost —
  XLA's own FLOPs/bytes/memory per labeled executable) and the
  prediction-drift block (``model_drift`` records, tools/drift_audit —
  analytic models caught disagreeing with measured telemetry);
- across runs: a comparison table keyed by run_id/algorithm/fingerprint.

A metrics dir whose only contents are ``flight/`` dumps renders the
dumps with a loud note instead of an empty report; a dir carrying both
streams and dumps renders only the streams (dump records duplicate
stream records — including both would double-count) and says the dumps
exist.

Serving percentiles are read from the stream's merged ``hist`` records
(cumulative snapshots that survive NTS_METRICS_MAX_MB rotation) with the
raw ``serve_request`` full-sort as the pre-histogram fallback; ``--diff``
treats the histogram quantile error bound as an implicit tolerance floor
for serve_p99_ms. Flight-recorder dumps (``flight_*.jsonl``, obs/flight)
are ordinary record streams and render natively.

A file with epoch events but no run_summary (killed run) still renders:
the summary is synthesized from the epoch events, marked ``(synthesized)``.

``--diff A B`` compares two runs' summaries metric by metric (warm epoch
time, wire bytes, shed rate, serve p99) with a per-metric % delta and
exits 2 when any metric regressed beyond ``--tol`` — the BENCH trajectory
check as a gate instead of an eyeball.

Usage:
  python -m neutronstarlite_torch.tools.metrics_report <file-or-dir> [...]
      [--json]
  python -m neutronstarlite_torch.tools.metrics_report --diff A B
      [--tol 0.05]
Exit code 0 when every input yielded a report; 1 when nothing usable was
found (or any input was unreadable); 2 when --diff found a regression.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neutronstarlite_torch.obs import schema  # noqa: E402
from neutronstarlite_torch.obs.collectors import steady_state_stats  # noqa: E402
from neutronstarlite_torch.obs.hist import latest_hists  # noqa: E402


def expand_paths(args: List[str]) -> List[str]:
    out: List[str] = []
    for a in args:
        if os.path.isdir(a):
            out.extend(sorted(glob.glob(os.path.join(a, "*.jsonl"))))
        else:
            out.append(a)
    return out


def expand_report_paths(args: List[str]) -> List[str]:
    """expand_paths with the flight-recorder subdirectory handled
    explicitly: a metrics dir whose only contents are ``flight/`` dumps
    (the run crashed before its stream opened, or only the recorder
    fired) renders the DUMPS with a loud note instead of an empty
    report; a dir carrying both keeps rendering only the streams — dump
    records duplicate stream records, so including both would
    double-count — and says the dumps exist."""
    out: List[str] = []
    for a in args:
        if not os.path.isdir(a):
            out.append(a)
            continue
        top = sorted(glob.glob(os.path.join(a, "*.jsonl")))
        dumps = sorted(glob.glob(os.path.join(a, "flight", "*.jsonl")))
        if top:
            out.extend(top)
            if dumps:
                print(
                    f"{a}: note: {len(dumps)} flight-recorder dump(s) "
                    f"under {os.path.join(a, 'flight')} are NOT included "
                    "(dump records duplicate the stream; pass the "
                    "flight/ directory explicitly to render them)",
                    file=sys.stderr,
                )
        elif dumps:
            print(
                f"{a}: no metrics streams, but {len(dumps)} "
                f"flight-recorder dump(s) under "
                f"{os.path.join(a, 'flight')} — rendering the dumps "
                "(each is the last-records ring a trigger snapshotted, "
                "not a full run)",
                file=sys.stderr,
            )
            out.extend(dumps)
    return out


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse + validate one JSONL stream; bad lines are reported to stderr
    and skipped (a crashed writer may leave a torn final line). A rotated
    ``<path>.1`` chunk (NTS_METRICS_MAX_MB) holds the stream's OLDEST
    records — it is read first, so run_start/run_summary survive a
    rotation that fired right after they were written."""
    rotated = path + ".1"
    chunks = [rotated, path] if os.path.exists(rotated) else [path]
    events: List[Dict[str, Any]] = []
    for chunk in chunks:
        with open(chunk, "r", encoding="utf-8") as fh:
            for ln, raw in enumerate(fh, 1):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    obj = json.loads(raw)
                    schema.validate_event(obj)
                except (json.JSONDecodeError, ValueError) as e:
                    print(f"{chunk}:{ln}: skipping bad record: {e}",
                          file=sys.stderr)
                    continue
                events.append(obj)
    return events


def summarize(path: str, events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The run_summary record for one stream (last one wins), synthesized
    from epoch events when the run died before finalizing."""
    summaries = [e for e in events if e["event"] == "run_summary"]
    if summaries:
        rec = dict(summaries[-1])
        rec["synthesized"] = False
        return rec
    epochs = [e for e in events if e["event"] == "epoch"]
    if not epochs:
        return None
    start = next((e for e in events if e["event"] == "run_start"), {})
    times = [e["seconds"] for e in epochs]
    losses = [e["loss"] for e in epochs if e.get("loss") is not None]
    # same definition as ToolkitBase.avg_epoch_time: exclude the compile
    # (first) epoch when more than one ran, so a synthesized summary is
    # comparable to a finalized one under the same report key
    warm = times[1:] if len(times) > 1 else times
    return {
        "event": "run_summary",
        "run_id": epochs[-1]["run_id"],
        "algorithm": start.get("algorithm", ""),
        "fingerprint": start.get("fingerprint", ""),
        "epochs": len(epochs),
        "epoch_time": steady_state_stats(times),
        "avg_epoch_s": sum(warm) / len(warm),
        "epoch_times_s": times,
        "loss_history": losses,
        "phases": {},
        "counters": {},
        "gauges": {},
        "timings": {},
        "memory": {"available": False, "bytes_in_use": None,
                   "peak_bytes_in_use": None, "devices": []},
        "synthesized": True,
    }


def _ms(v: Optional[float]) -> str:
    return f"{v * 1000:.3f}" if v is not None else "n/a"


# ---- serving streams (serve/) ----------------------------------------------


def summarize_serve(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The serve_summary record for a stream that served requests (last one
    wins), synthesized from serve_request records when the server died
    before close() — mirroring summarize()'s contract for training runs."""
    serves = [e for e in events if e["event"] == "serve_summary"]
    if serves:
        rec = dict(serves[-1])
        rec["synthesized"] = False
        return rec
    reqs = [e for e in events if e["event"] == "serve_request"]
    if not reqs:
        return None
    served = [e for e in reqs if e["status"] != "shed"]
    # quantiles come from the merged `hist` records when the stream
    # carries any (cumulative snapshots survive NTS_METRICS_MAX_MB
    # rotation — the raw serve_request sort below loses every rotated-away
    # request, which used to lose p99 entirely); raw full-sort is the
    # fallback for pre-histogram streams only
    hist = latest_hists(events).get("serve.latency_ms")
    if hist is not None and hist.count:
        latency = hist.quantiles()
        source = "hist"
    else:
        from neutronstarlite_torch.serve.batcher import latency_percentiles

        lat = [
            e["total_ms"] for e in served if e.get("total_ms") is not None
        ]
        latency = latency_percentiles(lat)
        source = "raw"
    ts = [e["ts"] for e in served]
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    # after rotation the surviving raw records undercount; the histogram's
    # cumulative count covers every answered request — use the larger
    # (sheds and throughput stay raw-derived: the hist holds no timestamps
    # and sheds record no latency)
    n_answered = len(served)
    if source == "hist":
        n_answered = max(n_answered, hist.count)
    return {
        "event": "serve_summary",
        "run_id": reqs[-1]["run_id"],
        # "requests" counts ANSWERED requests, matching the live record
        # (InferenceServer.request_count only counts flushed requests;
        # sheds are separate there too)
        "requests": n_answered,
        "shed": sum(1 for e in reqs if e["status"] == "shed"),
        "latency_ms": latency,
        "latency_source": source,
        "throughput_rps": (len(ts) / span) if span > 0 else None,
        "counters": {},
        "synthesized": True,
    }


def _lat_ms(v: Optional[float]) -> str:
    return f"{v:.3f}" if v is not None else "n/a"


def render_serve(path: str, rec: Dict[str, Any],
                 events: List[Dict[str, Any]]) -> str:
    """The #key=value(ms) block for one serving stream."""
    lat = rec.get("latency_ms") or {}
    rps = rec.get("throughput_rps")
    lines = [
        f"== serve {rec.get('run_id', '?')}"
        f"{' (synthesized)' if rec.get('synthesized') else ''} — {path}",
        "--------------------finish serving !",
        f"#requests={rec.get('requests', 0)}",
        f"#shed={rec.get('shed', 0)}",
        f"#p50_latency={_lat_ms(lat.get('p50'))}(ms)",
        f"#p95_latency={_lat_ms(lat.get('p95'))}(ms)",
        f"#p99_latency={_lat_ms(lat.get('p99'))}(ms)",
        f"#throughput={f'{rps:.2f}' if rps is not None else 'n/a'}(req/s)",
    ]
    flushes = [e for e in events if e["event"] == "batch_flush"]
    if flushes:
        reasons: Dict[str, int] = {}
        for e in flushes:
            reasons[e["reason"]] = reasons.get(e["reason"], 0) + 1
        lines.append(
            f"#batches={len(flushes)} ("
            + " ".join(f"{k}={v}" for k, v in sorted(reasons.items())) + ")"
        )
    for name, v in sorted((rec.get("counters") or {}).items()):
        v = int(v) if float(v).is_integer() else v
        lines.append(f"#{name}={v}")
    cache = rec.get("cache")
    if isinstance(cache, dict):
        lines.append(
            "#cache_hits={hits} misses={misses} entries={entries} "
            "expired={expired}".format(**cache)
        )
    lines.extend(render_sample(rec))
    lines.extend(rec.get("_scan") or [])
    lines.extend(rec.get("_deltas") or [])
    lines.extend(rec.get("_stream") or [])
    lines.extend(rec.get("_cost") or [])
    lines.extend(rec.get("_drift") or [])
    lines.extend(rec.get("_numerics") or [])
    lines.extend(rec.get("_fleet") or [])
    lines.extend(rec.get("_hists") or [])
    lines.extend(rec.get("_slo") or [])
    lines.extend(rec.get("_trace") or [])
    return "\n".join(lines)


def render_ring(events: List[Dict[str, Any]],
                rec: Dict[str, Any]) -> List[str]:
    """The ring-pipelined exchange block: overlap/memory facts from the
    per-hop ``ring_step`` records (parallel/dist_ring_blocked.py) plus the
    residency gauges the trainer pins. Empty when the stream has none."""
    hops = [e for e in events if e["event"] == "ring_step"]
    if not hops:
        return []
    gauges = rec.get("gauges") or {}
    total = sum(e["bytes"] for e in hops)
    by_step: Dict[int, int] = {}
    for e in hops:
        by_step[e["step"]] = by_step.get(e["step"], 0) + e["bytes"]
    epochs = len({e.get("epoch") for e in hops})
    # skip count from the trainer's trace-time gauge when present — a
    # trimmed SUFFIX ships no hops at all, so its skipped steps never
    # appear in the per-hop records; fall back to the records otherwise
    skipped = gauges.get("ring.skipped_steps")
    if skipped is None:
        skipped = sum(1 for e in hops if e.get("skipped")) // max(epochs, 1)
    lines = [
        "ring-pipelined exchange:",
        f"#ring_hops_per_epoch={len(by_step)} "
        f"(skipped_compute_steps={int(skipped)})",
        f"#ring_wire_bytes={total} ({total / 2**20:.2f} MiB over "
        f"{epochs} epoch(s))",
    ]
    peak = gauges.get("wire.peak_resident_rows")
    if peak is not None:
        lines.append(
            f"#ring_peak_resident_rows={int(peak)} (double buffer: "
            "resident shard + one in flight; the all_gather family holds "
            "P*vp)"
        )
    timed = [e["seconds"] for e in hops if e.get("seconds") is not None]
    if timed:
        lines.append(
            f"#ring_hop_time_total={sum(timed) * 1000:.3f}(ms) over "
            f"{len(timed)} measured hops"
        )
    # 2D (vertex x feature) mesh gauges (parallel/partitioner.py): the
    # resolved shape and the feature-slab width each hop carried
    shape = gauges.get("mesh.shape")
    if shape is not None:
        lines.append(
            f"#mesh_shape={shape} (Pv={gauges.get('mesh.pv')}, "
            f"Pf={gauges.get('mesh.pf')}, slab_cols="
            f"{gauges.get('mesh.slab_cols')})"
        )
        feat_bytes = gauges.get("wire.peak_resident_feature_bytes")
        if feat_bytes is not None:
            lines.append(
                f"#mesh_peak_resident_feature_bytes={int(feat_bytes)} "
                "(O(vp*f/Pf): the slab-resident double buffer)"
            )
    return lines


def render_sample(rec: Dict[str, Any]) -> List[str]:
    """The async-sampling-pipeline block (sample/pipeline.py gauges +
    counters the sampled trainer / serve stack pin). Empty for runs that
    never pipelined sampling."""
    gauges = rec.get("gauges") or {}
    counters = rec.get("counters") or {}
    if (
        "sample.queue_depth" not in gauges
        and "sample.stall_ms" not in counters
        and "sample.h2d_bytes" not in counters
    ):
        return []
    lines = ["sampling pipeline:"]
    depth = gauges.get("sample.queue_depth")
    if depth is not None:
        lines.append(
            f"#sample_queue_depth_peak={int(depth)} (bounded prefetch; "
            "NTS_SAMPLE_PREFETCH)"
        )
    stall = counters.get("sample.stall_ms")
    produced = counters.get("sample.produced")
    if stall is not None:
        per = ""
        if produced:
            per = f" ({stall / produced:.3f} ms/batch over {int(produced)})"
        lines.append(f"#sample_stall={stall:.3f}(ms){per}")
    h2d = counters.get("sample.h2d_ms")
    if h2d is not None:
        lines.append(f"#sample_h2d={h2d:.3f}(ms)")
    hb = counters.get("sample.h2d_bytes")
    if hb is not None:
        # the per-batch H2D payload total (sample/pipeline.py producers
        # measure it; the sync path prices the wire_accounting formula;
        # SAMPLE_PIPELINE:fused pins it to exactly 0)
        lines.append(f"#sample_h2d_bytes={int(hb)}")
    return lines


def render_epoch_scan(events: List[Dict[str, Any]]) -> List[str]:
    """The fused one-dispatch epoch block (``epoch_scan`` records,
    SAMPLE_PIPELINE:fused): per-epoch scan receipts aggregated per
    bucket — batches, dispatches (pinned to 1/epoch by the trainer), and
    the H2D byte count (pinned to 0). Empty for non-fused runs."""
    recs = [e for e in events if e["event"] == "epoch_scan"]
    if not recs:
        return []
    by_bucket: Dict[int, Dict[str, Any]] = {}
    for e in recs:
        agg = by_bucket.setdefault(
            int(e["bucket"]),
            {"epochs": 0, "batches": 0, "dispatches": 0, "h2d_bytes": 0,
             "seconds": 0.0},
        )
        agg["epochs"] += 1
        agg["batches"] += int(e["batches"])
        agg["dispatches"] += int(e["dispatches"])
        agg["h2d_bytes"] += int(e["h2d_bytes"])
        if isinstance(e.get("seconds"), (int, float)):
            agg["seconds"] += float(e["seconds"])
    lines = ["fused epoch scan:"]
    for bucket, agg in sorted(by_bucket.items()):
        lines.append(
            f"#epoch_scan=bucket {bucket} epochs={agg['epochs']} "
            f"batches={agg['batches']} dispatches={agg['dispatches']} "
            f"h2d_bytes={agg['h2d_bytes']} "
            f"total={_ms(agg['seconds'])}(ms)"
        )
    return lines


def render_tuning(events: List[Dict[str, Any]],
                  rec: Dict[str, Any]) -> List[str]:
    """The autotuner block (tune/; DIST_PATH:auto / KERNEL:auto /
    WIRE_DTYPE:auto under NTS_TUNE): every decision with its source
    (measured | cached | prior) and score, plus the trial inventory.
    Empty for runs that never consulted the tuner."""
    trials = [e for e in events if e["event"] == "tune_trial"]
    decisions = [e for e in events if e["event"] == "tune_decision"]
    gauges = rec.get("gauges") or {}
    if not (trials or decisions):
        # records may have rotated away (NTS_METRICS_MAX_MB); the gauge
        # snapshot in run_summary still pins the decision
        if "tune.decision" not in gauges:
            return []
        return [
            "tuning:",
            f"#tune_decision={gauges['tune.decision']} "
            f"(source={gauges.get('tune.decision_source')}, "
            f"P={gauges.get('tune.partitions')})",
        ]
    lines = ["tuning:"]
    for d in decisions:
        secs = d.get("seconds")
        pred = d.get("predicted_bytes")
        lines.append(
            f"#tune_decision={d['candidate']} (source={d['source']}, "
            f"P={d.get('partitions')}"
            + (f", score={secs * 1000:.3f}ms" if secs is not None else "")
            + (f", predicted={pred}B" if pred is not None else "")
            + ")"
        )
    if trials:
        by_source: Dict[str, int] = {}
        for t in trials:
            by_source[t["source"]] = by_source.get(t["source"], 0) + 1
        lines.append(
            f"#tune_trials={len(trials)} ("
            + " ".join(f"{k}={v}" for k, v in sorted(by_source.items()))
            + ")"
        )
    return lines


def render_hists(events: List[Dict[str, Any]]) -> List[str]:
    """The latency-histogram block: every merged ``hist`` record with its
    count and bounded-error quantiles. Empty for pre-histogram streams."""
    hists = latest_hists(events)
    if not hists:
        return []

    def _q(v):
        return f"{v:.3f}" if v is not None else "n/a"

    lines = ["latency histograms:"]
    for name, h in sorted(hists.items()):
        q = h.quantiles()
        lines.append(
            f"#hist_{name}=count={h.count} p50={_q(q['p50'])} "
            f"p95={_q(q['p95'])} p99={_q(q['p99'])} "
            f"max={_q(h.max)} (quantile err <= {h.rel_error * 100:.1f}%)"
        )
    return lines


_MAX_SHED_LINES = 40


def slo_timeline(events: List[Dict[str, Any]]) -> List[str]:
    """``slo_status`` verdicts and ``shed`` rejections as ONE
    offset-stamped timeline — burn-rate breaches next to the sheds they
    caused. Empty when the stream carries no slo_status records (plain
    queue-bound sheds stay in the serve block's #shed counter)."""
    slos = [e for e in events if e["event"] == "slo_status"]
    if not slos:
        return []
    sheds = [e for e in events if e["event"] == "shed"]
    t0 = events[0]["ts"] if events else 0.0
    lines = ["slo timeline:"]
    shown_sheds = 0
    for e in sorted(slos + sheds, key=lambda e: (e["ts"], e["seq"])):
        off = e["ts"] - t0
        if e["event"] == "slo_status":
            burn = e.get("burn_rate")
            val = e.get("value")
            lines.append(
                f"  +{off:8.2f}s slo      {e['metric']} state={e['state']}"
                f" burn={f'{burn:.2f}' if burn is not None else 'n/a'}"
                f" value={f'{val:.3f}' if val is not None else 'n/a'}"
                f" (objective {e['objective']})"
            )
        else:
            shown_sheds += 1
            if shown_sheds > _MAX_SHED_LINES:
                continue
            lines.append(
                f"  +{off:8.2f}s shed     reason={e.get('reason')}"
                + (f" depth={e['queue_depth']}"
                   if e.get("queue_depth") is not None else "")
            )
    if shown_sheds > _MAX_SHED_LINES:
        lines.append(
            f"  ... and {shown_sheds - _MAX_SHED_LINES} more shed(s) "
            "(full detail in the stream)"
        )
    return lines


def render_program_costs(events: List[Dict[str, Any]],
                         rec: Optional[Dict[str, Any]] = None) -> List[str]:
    """The compiled-program cost block (obs/cost): XLA's own FLOPs /
    bytes / memory per labeled executable — from the run_summary's
    consolidated list when present, the raw ``program_cost`` records
    otherwise (latest per label wins). Empty for uninstrumented runs."""
    costs = list((rec or {}).get("program_costs") or [])
    if not costs:
        costs = [e for e in events if e["event"] == "program_cost"]
    if not costs:
        return []
    by_label: Dict[str, Dict[str, Any]] = {}
    for c in costs:
        if c.get("label"):
            by_label[c["label"]] = c

    def _n(v):
        return f"{v:g}" if v is not None else "n/a"

    lines = ["program costs:"]
    for label, c in sorted(by_label.items()):
        if not c.get("available"):
            lines.append(
                f"#program_cost={label} unavailable "
                f"({c.get('error') or 'backend exposes no analysis'})"
            )
            continue
        mem = c.get("memory") or {}
        tail = ""
        if mem.get("peak_bytes") is not None:
            tail = (
                f" peak={mem['peak_bytes']}B (args={_n(mem.get('argument_bytes'))}"
                f" out={_n(mem.get('output_bytes'))}"
                f" temp={_n(mem.get('temp_bytes'))})"
            )
        lines.append(
            f"#program_cost={label} flops={_n(c.get('flops'))} "
            f"bytes_accessed={_n(c.get('bytes_accessed'))}"
            f"{tail} (source={c.get('source')})"
        )
    return lines


def render_drift(events: List[Dict[str, Any]]) -> List[str]:
    """The prediction-drift block (tools/drift_audit): every
    ``model_drift`` record — an analytic model (wire pricing, tuner
    prior) caught disagreeing with what actually ran. Empty for
    drift-free streams."""
    drifts = [e for e in events if e["event"] == "model_drift"]
    if not drifts:
        return []

    def _n(v):
        return f"{v:g}" if v is not None else "n/a"

    lines = ["prediction drift:"]
    for d in drifts:
        extra = ""
        if d.get("candidate"):
            extra += (
                f" prior_pick={d['candidate']}"
                + (f" measured_best={d['measured_best']}"
                   if d.get("measured_best") else "")
            )
        if d.get("flagged_entry"):
            extra += f" flagged={d['flagged_entry']}"
            more = len(d.get("flagged_entries") or []) - 1
            if more > 0:
                extra += f" (+{more} more)"
        lines.append(
            f"#model_drift={d['metric']} predicted={_n(d.get('predicted'))} "
            f"observed={_n(d.get('observed'))} "
            f"({d['drift'] * 100:+.1f}% > {d['threshold'] * 100:.0f}%, "
            f"source={d.get('source')}){extra}"
        )
    return lines


_MAX_DELTA_LINES = 20


def render_deltas(events: List[Dict[str, Any]]) -> List[str]:
    """The live graph-delta block (serve/delta.py): every ``graph_delta``
    application with its incremental-invalidation receipt and the digest
    the tuner/ledger keying now sees. Empty for frozen-graph streams."""
    deltas = [e for e in events if e["event"] == "graph_delta"]
    if not deltas:
        return []
    lines = ["graph deltas:"]
    for i, d in enumerate(deltas):
        if i >= _MAX_DELTA_LINES:
            lines.append(
                f"  ... and {len(deltas) - _MAX_DELTA_LINES} more "
                "delta(s) (full detail in the stream)"
            )
            break
        secs = d.get("seconds")
        lines.append(
            f"#graph_delta=+{d['added_edges']}e -{d['removed_edges']}e "
            f"+{d['added_vertices']}v "
            f"invalidated={d.get('cache_invalidated', 0)} "
            f"rows_patched={d.get('rows_patched', 0)} "
            f"dirty={d.get('dirty_predictions', 0)} "
            f"digest={str(d['graph_digest'])[:12]}"
            + (f" ({secs * 1000:.1f} ms)" if secs is not None else "")
            + (f" [{d['replica']}]" if d.get("replica") else "")
        )
    return lines


_MAX_STREAM_LINES = 20


def render_stream(events: List[Dict[str, Any]]) -> List[str]:
    """The streaming-graph block (stream/): every ``delta_commit``
    receipt (the multi-writer log's total-order facts per sequence
    point) and every ``finetune_round`` drain, with the closing
    head-vs-model staleness summary. Empty for non-streaming runs."""
    commits = [e for e in events if e["event"] == "delta_commit"]
    rounds = [e for e in events if e["event"] == "finetune_round"]
    if not (commits or rounds):
        return []
    lines = ["stream:"]
    for i, e in enumerate(commits):
        if i >= _MAX_STREAM_LINES:
            lines.append(
                f"  ... and {len(commits) - _MAX_STREAM_LINES} more "
                "commit(s) (full detail in the stream)"
            )
            break
        secs = e.get("seconds")
        fp = e.get("fp_rate")
        lines.append(
            f"#delta_commit=seq {e['seq']} [{e['writer']}#"
            f"{e['writer_seq']}] +{e['added_edges']}e "
            f"-{e['removed_edges']}e +{e['added_vertices']}v "
            f"dirty={e.get('dirty', 0)} "
            f"({e.get('dirty_mode', 'exact')}"
            + (f", fp={fp:.3f}" if fp is not None else "")
            + f") digest={str(e['graph_digest'])[:12]}"
            + (f" ({secs * 1000:.1f} ms)" if secs is not None else "")
        )
    for e in rounds:
        secs = e.get("seconds")
        loss = e.get("loss")
        lines.append(
            f"#finetune_round={e['round']} seq {e['seq_lo']}.."
            f"{e['seq_hi']} dirty={e['dirty']} "
            f"epochs={e['epochs']} batches={e['batches']} "
            + (f"loss={loss:.4f} " if loss is not None else "loss=n/a ")
            + f"ckpt_step={e['ckpt_step']}"
            + (f" rollout={e['verdict']}" if e.get("verdict") else "")
            + (f" ({secs:.2f}s)" if secs is not None else "")
        )
    if commits and rounds:
        head = commits[-1]["seq"]
        model = rounds[-1]["seq_hi"]
        lines.append(
            f"#stream_staleness=model at seq {model} vs graph head "
            f"{head} (lag {max(head - model, 0)})"
        )
    return lines


def render_numerics(events: List[Dict[str, Any]],
                    rec: Dict[str, Any]) -> List[str]:
    """The numerics-health block (obs/numerics, NTS_NUMERICS=1): the
    LAST ``tensor_stats`` snapshot per tensor group (within a stream the
    latest per name supersedes), the global grad norm / wire quant-error
    gauges, and every ``nonfinite_provenance`` verdict. Empty for
    uninstrumented streams."""
    stats: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e["event"] == "tensor_stats":
            stats[e["name"]] = e
    provs = [e for e in events if e["event"] == "nonfinite_provenance"]
    gauges = rec.get("gauges") or {}
    if not (stats or provs):
        return []

    def _n(v):
        return f"{v:.4g}" if v is not None else "n/a"

    lines = ["numerics:"]
    for name, e in sorted(stats.items()):
        tail = ""
        if e.get("quant_rel_err") is not None:
            tail = f" quant_rel_err={e['quant_rel_err']:.3g}"
        lines.append(
            f"#numerics_{name}=finite={e['finite_fraction']:.4f} "
            f"absmax={_n(e.get('absmax'))} rms={_n(e.get('rms'))} "
            f"zero={e['zero_fraction']:.4f}{tail}"
            + (f" (epoch {e['epoch']})" if e.get("epoch") is not None
               else "")
        )
    gn = gauges.get("numerics.grad_global_norm")
    if gn is not None:
        lines.append(f"#grad_global_norm={gn:g}")
    qe = gauges.get("wire.quant_rel_err")
    if qe is not None:
        lines.append(f"#wire_quant_rel_err={qe:g}")
    for e in provs:
        lines.append(
            f"#nonfinite_provenance="
            f"layer {e['layer'] if e.get('layer') is not None else '?'} "
            f"op={e.get('op') or '?'} name={e.get('name') or '?'} "
            f"({e['fault_kind']} at epoch {e.get('epoch')}, "
            f"{e.get('checked', 0)} taps checked"
            + (", injected)" if e.get("injected") else ")")
        )
    return lines


def render_probes(events: List[Dict[str, Any]]) -> List[str]:
    """The ``backend_probe`` block (bench.py's subprocess PJRT check) —
    the stale-anchor cause, visible at last. Empty without probes."""
    probes = [e for e in events if e["event"] == "backend_probe"]
    if not probes:
        return []
    lines = ["backend probes:"]
    for e in probes:
        lines.append(
            f"#backend_probe=attempt {e['attempt']} "
            f"outcome={e['outcome']} "
            f"platform={e.get('platform') or '?'} "
            f"{e['seconds']:.1f}s"
            + (f" (timeout_s={e['timeout_s']:g})"
               if e.get("timeout_s") is not None else "")
        )
        err = e.get("error")
        if err:
            tail = str(err).strip().splitlines()[-1][:160]
            lines.append(f"    error: {tail}")
    return lines


_TIMELINE_SKIP = ("event", "run_id", "schema", "ts", "seq", "error")


def recovery_timeline(events: List[Dict[str, Any]]) -> List[str]:
    """``fault``/``recovery`` records as offset-stamped one-liners; the
    elastic ``rank_loss``/``replan`` records and ``stream_rotated``
    markers (the NTS_METRICS_MAX_MB guard) ride the same timeline — a
    truncated history must say so in the report."""
    t0 = events[0]["ts"] if events else 0.0
    lines: List[str] = []
    for e in events:
        if e["event"] not in ("fault", "recovery", "rank_loss", "replan",
                              "stream_rotated", "nonfinite_provenance",
                              "target_loss", "straggler", "rollout"):
            continue
        detail = " ".join(
            f"{k}={e[k]}" for k in sorted(e)
            if k not in _TIMELINE_SKIP and e[k] is not None
        )
        lines.append(f"  +{e['ts'] - t0:8.2f}s {e['event']:<8s} {detail}")
    return lines


def render_elastic(events: List[Dict[str, Any]],
                   rec: Dict[str, Any]) -> List[str]:
    """The elastic-timeline block (resilience/elastic, NTS_ELASTIC=1):
    heartbeat volume, every rank-loss detection, every survivor replan
    with its time-to-recover (rank_loss -> first post-replan epoch_end),
    and the final dist.active_partitions gauge. Empty for runs that
    never ran elastic."""
    beats = [e for e in events if e["event"] == "heartbeat"]
    losses = [e for e in events if e["event"] == "rank_loss"]
    replans = [e for e in events if e["event"] == "replan"]
    if not (beats or losses or replans):
        return []
    lines = ["elastic timeline:"]
    if beats:
        parts = {e["partition"] for e in beats}
        lines.append(
            f"#heartbeats={len(beats)} over {len(parts)} partition(s)"
        )
    for e in losses:
        part = e.get("partition")
        missed = e.get("missed_beats")
        lines.append(
            f"#rank_loss=partition "
            f"{part if part is not None else '?'} at epoch "
            f"{e.get('epoch')} ({e.get('reason', '?')}"
            + (f", {missed} missed beats)" if missed is not None else ")")
        )
    # the rank_loss -> first-post-replan-epoch pairing has ONE
    # implementation (trace_timeline.elastic_report, run_id-guarded for
    # merged dirs); this block and the span-timeline verdict must never
    # disagree on the same stream
    from neutronstarlite_torch.tools.trace_timeline import elastic_report

    episodes = (elastic_report(events) or {}).get("episodes") or []
    for e, ep in zip(replans, episodes):
        secs = e.get("seconds")
        moved = e.get("moved_vertices")
        lines.append(
            f"#replan={e['from_partitions']}->{e['to_partitions']} "
            f"partitions (lost partition {e.get('lost')}"
            + (f", {moved} vertices re-owned" if moved is not None else "")
            + (f", rebuilt in {secs * 1000:.1f} ms)" if secs is not None
               else ")")
        )
        if ep["recover_s"] is not None:
            lines.append(
                f"#time_to_recover={ep['recover_s']:.2f}s "
                "(rank_loss -> first post-replan epoch_end)"
            )
    active = (rec.get("gauges") or {}).get("dist.active_partitions")
    if active is not None:
        lines.append(f"#active_partitions={int(active)}")
    return lines


def render_fleet(events: List[Dict[str, Any]]) -> List[str]:
    """The telemetry-fabric block (obs/hub + obs/skew + serve/crosshost):
    hub/exporter ``telemetry`` snapshots, every ``target_loss`` (the
    cross-host analog of rank_loss), every advisory ``straggler``
    verdict, and every ``rollout`` attempt with its canary evidence.
    Empty for streams the fabric never touched."""
    telemetry = [e for e in events if e["event"] == "telemetry"]
    losses = [e for e in events if e["event"] == "target_loss"]
    stragglers = [e for e in events if e["event"] == "straggler"]
    rollouts = [e for e in events if e["event"] == "rollout"]
    if not (telemetry or losses or stragglers or rollouts):
        return []
    lines = ["fleet telemetry:"]
    if telemetry:
        hub = [e for e in telemetry if e.get("source") == "hub"]
        lines.append(
            f"#telemetry={len(telemetry)} snapshot(s)"
            + (f" ({len(hub)} hub poll(s))" if hub else "")
        )
        last = (hub or telemetry)[-1]
        if last.get("targets") is not None:
            lines.append(
                f"#fleet_targets={last.get('targets_ok')}/"
                f"{last.get('targets')} ok, "
                f"{last.get('targets_lost')} lost"
            )
        slo = last.get("slo")
        if isinstance(slo, dict) and slo.get("objectives"):
            lines.append(
                f"#fleet_slo={slo.get('worst')} "
                f"({slo.get('breaching')}/{slo.get('objectives')} "
                "breaching)"
            )
    for e in losses:
        lines.append(
            f"#target_loss={e.get('target')} after "
            f"{e.get('missed_polls')} missed poll(s) "
            f"({e.get('reason', '?')}) — merged view continues on the "
            "survivors"
        )
    for e in stragglers:
        exc = e.get("excess")
        lines.append(
            f"#straggler=partition {e.get('partition')} at epoch "
            f"{e.get('epoch')}"
            + (f" (+{exc * 100:.0f}% over the fleet median"
               if isinstance(exc, (int, float)) else " (")
            + f", {e.get('consecutive')} consecutive) — "
            "slow-but-alive, advisory (NOT a rank_loss)"
        )
    for e in rollouts:
        canary = e.get("canary") or {}
        dis = canary.get("disagreement")
        detail = ""
        if dis is not None:
            tol = canary.get("tolerance")
            detail = (
                f" canary disagreement={dis:g}"
                + (f" (tol {tol:g})" if isinstance(tol, (int, float))
                   else "")
            )
        err = e.get("error")
        lines.append(
            f"#rollout={e.get('verdict')} ckpt={e.get('ckpt_dir')}"
            f"{detail} restarted={e.get('restarted', 0)}/"
            f"{e.get('replicas', '?')}"
            + (f" rolled_back={e['rolled_back']}"
               if e.get("rolled_back") else "")
            + (f" — {err}" if err else "")
        )
    return lines


def render_run(path: str, rec: Dict[str, Any]) -> str:
    """The reference-shaped #key=value(ms) block for one run."""
    et = rec.get("epoch_time", {})
    lines = [
        f"== run {rec.get('run_id', '?')} "
        f"[{rec.get('algorithm') or '?'} fp={rec.get('fingerprint') or '?'}]"
        f"{' (synthesized)' if rec.get('synthesized') else ''} — {path}",
        "--------------------finish algorithm !",
        f"#epochs={rec.get('epochs', 0)}",
        f"#avg_epoch_time={_ms(rec.get('avg_epoch_s'))}(ms)",
        f"#first_epoch_time={_ms(et.get('first_s'))}(ms)",
        f"#warm_median_epoch_time={_ms(et.get('warm_median_s'))}(ms)",
        f"#compile_overhead={_ms(et.get('compile_overhead_s'))}(ms)",
    ]
    for name, ph in sorted((rec.get("phases") or {}).items()):
        lines.append(
            f"#{name}_time={_ms(ph.get('total_s'))}(ms) "
            f"count={ph.get('count', 0)}"
        )
    for name, t in sorted((rec.get("timings") or {}).items()):
        if name == "epoch":  # already attributed above
            continue
        lines.append(
            f"#{name}_time={_ms(t.get('total_s'))}(ms) "
            f"count={t.get('count', 0)} avg={_ms(t.get('avg_s'))}(ms)"
        )
    for name, v in sorted((rec.get("counters") or {}).items()):
        v = int(v) if float(v).is_integer() else v
        lines.append(f"#{name}={v}")
    mem = rec.get("memory") or {}
    if mem.get("available"):
        lines.append(f"#peak_hbm_bytes={mem.get('peak_bytes_in_use')}")
        lines.append(f"#hbm_bytes_in_use={mem.get('bytes_in_use')}")
    else:
        lines.append("#peak_hbm_bytes=null (backend exposes no memory_stats)")
    loss = (rec.get("result") or {}).get("loss")
    if loss is not None:
        lines.append(f"#final_loss={loss}")
    lines.extend(rec.get("_ring") or [])
    lines.extend(rec.get("_tune") or [])
    lines.extend(rec.get("_deltas") or [])
    lines.extend(rec.get("_stream") or [])
    lines.extend(rec.get("_cost") or [])
    lines.extend(rec.get("_drift") or [])
    lines.extend(rec.get("_numerics") or [])
    lines.extend(rec.get("_elastic") or [])
    lines.extend(rec.get("_fleet") or [])
    lines.extend(render_sample(rec))
    lines.extend(rec.get("_scan") or [])
    lines.extend(rec.get("_hists") or [])
    lines.extend(rec.get("_slo") or [])
    lines.extend(rec.get("_probe") or [])
    lines.extend(rec.get("_trace") or [])
    timeline = rec.get("_timeline") or []
    if timeline:
        lines.append("recovery timeline:")
        lines.extend(timeline)
    return "\n".join(lines)


def render_table(rows: List[Dict[str, Any]]) -> str:
    """Cross-run comparison keyed by run_id."""
    header = ("run_id", "algo", "fp", "epochs", "warm_ms", "first_ms",
              "wire_MiB", "peak_hbm_MiB")
    table = [header]
    for rec in rows:
        et = rec.get("epoch_time", {})
        counters = rec.get("counters") or {}
        # None-checks, not truthiness: a legitimate 0 (P=1 dist run) must
        # render as 0.00, distinguishable from "not instrumented"
        wire = counters.get("wire.bytes_fwd")
        if wire is None:
            wire = counters.get("wire.feature_gather_bytes")
        mem = rec.get("memory") or {}
        peak = mem.get("peak_bytes_in_use")
        table.append((
            str(rec.get("run_id", "?"))[:40],
            str(rec.get("algorithm") or "?"),
            str(rec.get("fingerprint") or "?")[:12],
            str(rec.get("epochs", 0)),
            _ms(et.get("warm_median_s")),
            _ms(et.get("first_s")),
            f"{wire / 2**20:.2f}" if wire is not None else "n/a",
            f"{peak / 2**20:.1f}" if peak is not None else "n/a",
        ))
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in table
    )


# ---- --diff: two-run regression gate ---------------------------------------


def _load_side(path: str):
    """(train summary, serve summary) for one --diff side: the first
    stream under ``path`` carrying each (a side is one run's
    NTS_METRICS_DIR, or a single file)."""
    rec = srec = None
    for p in expand_paths([path]):
        try:
            events = load_events(p)
        except OSError as e:
            print(f"{p}: {e}", file=sys.stderr)
            continue
        if rec is None:
            rec = summarize(p, events)
        if srec is None:
            srec = summarize_serve(events)
    return rec, srec


def _diff_metrics(rec, srec):
    """{metric: value} — every entry is lower-is-better so the regression
    rule is uniform; None/absent entries are skipped in the comparison."""
    out = {}
    if rec is not None:
        et = rec.get("epoch_time") or {}
        out["warm_median_epoch_s"] = et.get("warm_median_s")
        out["avg_epoch_s"] = rec.get("avg_epoch_s")
        counters = rec.get("counters") or {}
        # wire.bytes_fwd is a run-total counter; normalize per epoch so a
        # longer run doesn't read as a wire regression (every other diff
        # metric is already per-epoch or a rate)
        wire = counters.get("wire.bytes_fwd")
        n_epochs = rec.get("epochs") or 0
        out["wire_bytes_fwd_per_epoch"] = (
            wire / n_epochs if wire is not None and n_epochs > 0 else None
        )
        # the fused-edge structural gate (scripts/ci_tier1.sh): the
        # attention/edge trainers pin their [Ep, f] edge-tensor HBM
        # traffic estimate here — exactly 0 on the fused path, so any
        # future regression that silently reroutes KERNEL:fused_edge back
        # to the eager chain trips the zero-baseline absolute floor
        gauges = rec.get("gauges") or {}
        out["edge_hbm_bytes_per_epoch"] = gauges.get(
            "kernel.edge_hbm_bytes_per_epoch"
        )
        # the async sampling pipeline's residual stall (sample/pipeline.py)
        # — per epoch, like every other diff metric; absent on sync runs
        # (the shared-metric filter skips it there)
        stall = counters.get("sample.stall_ms")
        out["sample_stall_ms_per_epoch"] = (
            stall / n_epochs if stall is not None and n_epochs > 0 else None
        )
        # the per-batch H2D payload (sample/fused.py's structural gate:
        # exactly 0 when fused, so any regression that reintroduces a
        # host transfer trips the zero-baseline absolute floor)
        h2d = counters.get("sample.h2d_bytes")
        out["sample_h2d_bytes_per_epoch"] = (
            h2d / n_epochs if h2d is not None and n_epochs > 0 else None
        )
        # numerics plane (obs/numerics, NTS_NUMERICS=1 / NTS_QUANT_PROBE):
        # the final grad-norm trajectory point and the measured wire
        # quantization error — both carry tolerance floors (_TOL_FLOORS):
        # grad norms swing with seeds/shuffling well beyond timing noise,
        # and the quant error of one payload jitters only at float
        # granularity, so a tight floor still catches a dtype regression
        out["grad_global_norm"] = gauges.get("numerics.grad_global_norm")
        out["wire_quant_rel_err"] = gauges.get("wire.quant_rel_err")
    if srec is not None:
        answered = srec.get("requests", 0)
        shed = srec.get("shed", 0)
        out["shed_rate"] = (
            shed / (answered + shed) if (answered + shed) > 0 else None
        )
        out["serve_p99_ms"] = (srec.get("latency_ms") or {}).get("p99")
    return out


def _micro_metrics(obj) -> Dict[str, Any]:
    """A tools/micro_bench JSON as a --diff side: per-op median ms, with
    the ``_eager`` / ``_fused`` suffix canonicalized away so a
    fused-vs-eager comparison shares keys across its two sides (each side
    should be produced with an --ops filter selecting one family — the
    ci_tier1 edge-family leg does)."""
    out: Dict[str, Any] = {}
    for name, rec in (obj.get("ops") or {}).items():
        ms = rec.get("ms")
        if ms is None:
            continue
        for suf in ("_eager", "_fused", "_1d", "_2d"):
            if name.endswith(suf):
                name = name[: -len(suf)]
                break
        key = f"micro.{name}_ms"
        if key in out:
            # both variants of one op in a single JSON (micro_bench run
            # without an --ops family filter) would silently compare a
            # mix; keep the first and say so loudly instead
            print(
                f"diff: duplicate canonical metric {key} in micro_bench "
                "side (both variants — _eager/_fused or _1d/_2d — "
                "present?) — keeping the first; produce each side with "
                "an --ops family filter (or comm_bench --side)",
                file=sys.stderr,
            )
            continue
        out[key] = ms
    return out


def _side_metrics(path: str) -> Dict[str, Any]:
    """One --diff side -> {metric: value}: an obs stream dir/file, or a
    micro_bench JSON file (detected by its {"platform", "ops"} shape)."""
    if os.path.isfile(path):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            lines = []
        for raw in lines:  # log lines may precede the one JSON line
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "ops" in obj and "platform" in obj:
                return _micro_metrics(obj)
            break  # a JSON object of another shape: treat as obs stream
    return _diff_metrics(*_load_side(path))


# per-metric tolerance floors: serve percentiles are histogram-derived
# (obs/hist, bounded relative quantile error ~1% per side), so two
# identical distributions can legitimately differ by up to ~2% between
# sides — a --tol below that would flag quantization noise as regression.
# grad_global_norm varies run to run with seeds/dropout far beyond
# timing noise (25% floor: catch a blow-up, not a reshuffle — the
# one-sided growth check here is deliberate and complements
# perf_sentinel's two-sided ADVISORY trajectory leg, which also
# catches the collapse-toward-zero direction);
# wire_quant_rel_err on one payload is near-deterministic (5% floor:
# a dtype/rounding regression doubles it, float jitter does not).
# The floor is implicit: the effective tolerance is max(--tol, floor).
_TOL_FLOORS = {
    "serve_p99_ms": 0.0202,
    "grad_global_norm": 0.25,
    "wire_quant_rel_err": 0.05,
}


def run_diff(a_path: str, b_path: str, tol: float,
             as_json: bool = False) -> int:
    """Compare run B against baseline A; exit 2 when any shared metric
    regressed (grew) by more than ``tol`` (fractional, e.g. 0.05 = 5%;
    against a 0.0 baseline ``tol`` is the absolute threshold instead).
    Histogram-derived metrics carry their quantile error bound as an
    implicit tolerance floor (_TOL_FLOORS). ``as_json`` emits one
    machine-readable object instead of the table. A side may also be a
    micro_bench JSON file (see _side_metrics)."""
    a = _side_metrics(a_path)
    b = _side_metrics(b_path)
    shared = [
        k for k in a
        if a.get(k) is not None and b.get(k) is not None
    ]
    if not shared:
        print("diff: no comparable metrics between the two sides",
              file=sys.stderr)
        return 1
    header = ("metric", "A", "B", "delta")
    table = [header]
    regressions = []
    detail: Dict[str, Dict[str, Any]] = {}
    for k in shared:
        va, vb = float(a[k]), float(b[k])
        eff_tol = max(tol, _TOL_FLOORS.get(k, 0.0))
        if va > 0:
            delta = (vb - va) / va
            dstr = f"{delta * 100:+.1f}%"
        else:
            delta = 1.0 if vb > 0 else 0.0
            dstr = "n/a" if vb == va else f"+{vb:g} (A was 0)"
        # zero baseline: no relative delta exists, so --tol acts as an
        # absolute floor (shed_rate 0 -> 0.0001 passes at --tol 0.05
        # instead of failing on ANY nonzero value)
        regressed = vb > va * (1.0 + eff_tol) if va > 0 else vb > tol
        if regressed:
            regressions.append(f"{k}: {va:g} -> {vb:g} ({dstr})")
        detail[k] = {"a": va, "b": vb, "delta": delta,
                     "regressed": regressed}
        table.append(
            (k, f"{va:g}", f"{vb:g}", dstr + (" REGRESSED" if regressed else ""))
        )
    if as_json:
        print(json.dumps({
            "tol": tol,
            "metrics": detail,
            "regressed": sorted(k for k in detail
                                if detail[k]["regressed"]),
        }))
        return 2 if regressions else 0
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    for row in table:
        print("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
    if regressions:
        print(
            f"REGRESSION beyond --tol {tol:g}: " + "; ".join(regressions),
            file=sys.stderr,
        )
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render obs JSONL metric streams into the "
        "reference-shaped #key=value(ms) report"
    )
    ap.add_argument("paths", nargs="*",
                    help="JSONL file(s) or NTS_METRICS_DIR-style directories")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line (the summaries) instead of text")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="compare run B against baseline A (each a file or "
                    "metrics dir); exit 2 on regression beyond --tol")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="--diff regression tolerance as a fraction "
                    "(default 0.05 = 5%%); absolute threshold when the "
                    "baseline value is 0")
    args = ap.parse_args(argv)

    if args.diff is not None:
        return run_diff(args.diff[0], args.diff[1], args.tol,
                        as_json=args.json)
    if not args.paths:
        ap.error("paths required (or use --diff A B)")

    paths = expand_report_paths(args.paths)
    if not paths:
        print("no .jsonl inputs found (a dir holding only a flight/ "
              "subdirectory would have said so above)", file=sys.stderr)
        return 1
    rows: List[Dict[str, Any]] = []
    failed = False
    # every loaded stream also feeds the CROSS-stream request-tracing
    # block: per-request chains span the router's and each replica's
    # files, so the join only makes sense over the merged view
    all_events: List[Dict[str, Any]] = []
    for p in paths:
        try:
            events = load_events(p)
        except OSError as e:
            print(f"{p}: {e}", file=sys.stderr)
            failed = True
            continue
        all_events.extend(events)
        rec = summarize(p, events)
        srec = summarize_serve(events)
        probe_lines = render_probes(events)
        fleet_lines = render_fleet(events)
        if rec is None and srec is None:
            if fleet_lines:
                # a hub's merged stream (obs/hub): no run behind it —
                # the fabric block + merged hists + SLO timeline render
                # it natively instead of "skipping"
                rows.append({
                    "event": "fleet_report",
                    "run_id": events[-1]["run_id"] if events else "?",
                    "telemetry_records": sum(
                        1 for e in events if e["event"] == "telemetry"
                    ),
                    "target_losses": sum(
                        1 for e in events if e["event"] == "target_loss"
                    ),
                    "stragglers": sum(
                        1 for e in events if e["event"] == "straggler"
                    ),
                    "rollouts": sum(
                        1 for e in events if e["event"] == "rollout"
                    ),
                    "_path": p,
                    "_fleet_only": True,
                    "_fleet": fleet_lines,
                    "_hists": render_hists(events),
                    "_slo": slo_timeline(events),
                    "_timeline": recovery_timeline(events),
                })
                continue
            if probe_lines:
                # a probe-only stream (bench.py's backend check with no
                # run behind it — every timed-out round since r05 looks
                # like this) renders its own small block
                probes = [
                    e for e in events if e["event"] == "backend_probe"
                ]
                rows.append({
                    "event": "backend_probe_report",
                    "run_id": probes[-1]["run_id"],
                    "attempts": len(probes),
                    "outcomes": [e["outcome"] for e in probes],
                    "_path": p,
                    "_probe_only": True,
                    "_probe": probe_lines,
                })
                continue
            only_stream = render_stream(events)
            if only_stream:
                # a stream-only file (a tailing replica's delta_commit /
                # finetune_round receipts with no run behind them, e.g. a
                # rotated-away or ingest-sidecar stream) renders the
                # streaming block natively
                rows.append({
                    "event": "stream_report",
                    "run_id": events[-1]["run_id"] if events else "?",
                    "delta_commits": sum(
                        1 for e in events if e["event"] == "delta_commit"
                    ),
                    "finetune_rounds": sum(
                        1 for e in events if e["event"] == "finetune_round"
                    ),
                    "_path": p,
                    "_stream_only": True,
                    "_stream": only_stream,
                    "_hists": render_hists(events),
                })
                continue
            # a run_start-only stream (trainer constructed/crashed before
            # its first epoch) is skippable noise, not a render failure —
            # but a directory yielding NOTHING still exits 1 below
            print(f"{p}: no run_summary, epoch, or serving events; skipping",
                  file=sys.stderr)
            continue
        # the span-timeline block (derived metrics) rides whichever record
        # renders this stream — the training one when present, else the
        # serving one — so it prints exactly once per stream
        from neutronstarlite_torch.tools.trace_timeline import timeline_block

        trace_lines = timeline_block(events)
        hist_lines = render_hists(events)
        slo_lines = slo_timeline(events)
        drift_lines = render_drift(events)
        delta_lines = render_deltas(events)
        stream_lines = render_stream(events)
        numerics_lines = render_numerics(events, rec or {})
        scan_lines = render_epoch_scan(events)
        if rec is not None:
            rec["_path"] = p
            rec["_timeline"] = recovery_timeline(events)
            rec["_ring"] = render_ring(events, rec)
            rec["_tune"] = render_tuning(events, rec)
            rec["_deltas"] = delta_lines
            rec["_stream"] = stream_lines
            rec["_cost"] = render_program_costs(events, rec)
            rec["_drift"] = drift_lines
            rec["_numerics"] = numerics_lines
            rec["_scan"] = scan_lines
            rec["_elastic"] = render_elastic(events, rec)
            rec["_fleet"] = fleet_lines
            rec["_hists"] = hist_lines
            rec["_slo"] = slo_lines
            rec["_probe"] = probe_lines
            rec["_trace"] = trace_lines
        if srec is not None:
            srec["_path"] = p
            srec["_events"] = events
            srec["_serve"] = True
            srec["_deltas"] = delta_lines if rec is None else []
            srec["_stream"] = stream_lines if rec is None else []
            srec["_cost"] = (
                render_program_costs(events, srec) if rec is None else []
            )
            srec["_drift"] = drift_lines if rec is None else []
            srec["_numerics"] = numerics_lines if rec is None else []
            srec["_scan"] = scan_lines if rec is None else []
            srec["_fleet"] = fleet_lines if rec is None else []
            srec["_hists"] = hist_lines if rec is None else []
            srec["_slo"] = slo_lines if rec is None else []
            srec["_trace"] = trace_lines if rec is None else []
        rows.extend(r for r in (rec, srec) if r is not None)
    if not rows:
        return 1
    if args.json:
        print(json.dumps(
            [{k: v for k, v in r.items() if not k.startswith("_")}
             for r in rows]
        ))
    else:
        for rec in rows:
            if rec.get("_probe_only"):
                print(f"== backend probe — {rec['_path']}")
                print("\n".join(rec["_probe"]))
            elif rec.get("_fleet_only"):
                lines = [f"== fleet {rec.get('run_id', '?')} — "
                         f"{rec['_path']}"]
                lines.extend(rec["_fleet"])
                lines.extend(rec.get("_hists") or [])
                lines.extend(rec.get("_slo") or [])
                timeline = rec.get("_timeline") or []
                if timeline:
                    lines.append("recovery timeline:")
                    lines.extend(timeline)
                print("\n".join(lines))
            elif rec.get("_stream_only"):
                lines = [f"== stream {rec.get('run_id', '?')} — "
                         f"{rec['_path']}"]
                lines.extend(rec["_stream"])
                lines.extend(rec.get("_hists") or [])
                print("\n".join(lines))
            elif rec.get("_serve"):
                print(render_serve(rec["_path"], rec, rec["_events"]))
            else:
                print(render_run(rec["_path"], rec))
            print()
        # fleet-merged distributed tracing: the per-request chain block
        # joins spans ACROSS the loaded streams (router + replicas), so
        # it renders once over the merged view, after the per-stream
        # blocks (lazy import: trace_timeline imports from this module)
        from neutronstarlite_torch.tools.trace_timeline import (
            request_tracing_block,
        )

        tracing_lines = request_tracing_block(all_events)
        if tracing_lines:
            print("\n".join(tracing_lines))
            print()
        train_rows = [r for r in rows if not r.get("_serve")
                      and not r.get("_probe_only")
                      and not r.get("_fleet_only")
                      and not r.get("_stream_only")]
        if len(train_rows) > 1:
            print(render_table(train_rows))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
