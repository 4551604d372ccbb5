"""Render the fleet telemetry fabric as a self-contained dashboard.

Port of ``neutronstarlite_tpu/tools/dashboard.py``, copied: only the
import paths differ. It reads the obs streams and ledger rows of either
package.

Input is either a hub's merged stream (``--stream`` file or
NTS_METRICS_DIR directory — any mix of hub + trainer + serve streams
renders) or a LIVE hub endpoint (``--url http://host:port`` — one
/telemetry snapshot is fetched and rendered); output is ONE static HTML
file with zero external assets (inline CSS, inline SVG sparklines — it
opens from a file:// path on an air-gapped rig) or, with ``--watch``,
a terminal ticker.

Panels:

- **fleet topology** — every polled target with its liveness verdict
  (ok / LOST with the miss count and last-ok age) from the hub's
  ``telemetry`` / ``target_loss`` / ``recovery`` records;
- **fleet health + SLO burn** — targets_ok/targets_lost over the run,
  the SLO rollup (worst state, breaching count) per poll;
- **latency quantiles** — the merged histograms' p50/p95/p99 (exact
  under the merge law) with per-poll sparklines from the perf ledger's
  ``kind=fleet`` rows (``--ledger`` / NTS_LEDGER_DIR) when available;
- **straggler heat strip** — per-partition epoch seconds from
  ``heartbeat.seconds`` shaded against the fleet median, with typed
  ``straggler`` records called out (obs/skew);
- **per-request waterfall** — when the input carries distributed-trace
  spans (router + replica streams, NTS_TRACE on), the slowest complete
  request chains render as stacked stage bars (queue/sample/execute/…
  plus the router-overhead remainder), with the complete-chain
  fraction, router-overhead quantiles, and the freshness lineage
  (graph_seq/model_seq) summarized above them
  (tools/trace_timeline.request_tracing_report).

Usage:
  python -m neutronstarlite_torch.tools.dashboard --stream DIR_OR_FILE
      [--out fleet_dashboard.html] [--ledger DIR]
  python -m neutronstarlite_torch.tools.dashboard --url http://host:port
      [--out ...]
  python -m neutronstarlite_torch.tools.dashboard --stream DIR --watch
      [--interval S] [--polls N]

Exit 0 on a rendered dashboard (even an empty one — "no data yet" is a
valid fleet state); exit 1 on unreadable inputs.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

from neutronstarlite_torch.obs import ledger
from neutronstarlite_torch.obs.hist import latest_hists
from neutronstarlite_torch.obs.schema import validate_event
from neutronstarlite_torch.obs.skew import partition_epoch_seconds

FETCH_TIMEOUT_S = 5.0


# ---- data model -------------------------------------------------------------


def load_stream_events(paths: List[str]) -> List[Dict[str, Any]]:
    from neutronstarlite_torch.tools.metrics_report import (
        expand_paths, load_events,
    )

    events: List[Dict[str, Any]] = []
    for p in expand_paths(paths):
        events.extend(load_events(p))
    return events


def fetch_url_events(url: str) -> List[Dict[str, Any]]:
    """One /telemetry snapshot from a live hub (or any exporter)."""
    u = url if "://" in url else f"http://{url}"
    if not u.rstrip("/").endswith("/telemetry"):
        u = u.rstrip("/") + "/telemetry"
    with urllib.request.urlopen(u, timeout=FETCH_TIMEOUT_S) as resp:
        body = resp.read().decode("utf-8")
    events: List[Dict[str, Any]] = []
    for raw in body.splitlines():
        raw = raw.strip()
        if not raw:
            continue
        rec = json.loads(raw)
        validate_event(rec)
        events.append(rec)
    return events


def fabric_model(events: List[Dict[str, Any]],
                 fleet_rows: Optional[List[Dict[str, Any]]] = None,
                 ) -> Dict[str, Any]:
    """Everything the panels render, from one pass over the records."""
    telemetry = [e for e in events if e.get("event") == "telemetry"]
    hub_polls = [e for e in telemetry if e.get("source") == "hub"]
    losses = [e for e in events if e.get("event") == "target_loss"]
    rejoins = [e for e in events if e.get("event") == "recovery"
               and e.get("action") == "target_rejoin"]
    stragglers = [e for e in events if e.get("event") == "straggler"]

    # per-target final liveness: lost unless a later rejoin
    targets: Dict[str, Dict[str, Any]] = {}
    for e in losses:
        targets[str(e.get("target"))] = {
            "state": "LOST", "missed_polls": e.get("missed_polls"),
            "last_ok_ts": e.get("last_ok_ts"), "ts": e.get("ts"),
        }
    for e in rejoins:
        t = str(e.get("target"))
        prior = targets.get(t)
        if prior is None or (e.get("ts") or 0) >= (prior.get("ts") or 0):
            targets[t] = {"state": "ok", "rejoined": True,
                          "ts": e.get("ts")}

    hists = latest_hists(events)
    quantiles = {
        name: {"count": h.count, **h.quantiles()}
        for name, h in sorted(hists.items())
    }

    # distributed request tracing (lazy import: trace_timeline pulls in
    # metrics_report at module load)
    from neutronstarlite_torch.tools.trace_timeline import (
        request_tracing_report,
    )

    tracing = request_tracing_report(events)

    last_poll = hub_polls[-1] if hub_polls else None
    heat = partition_epoch_seconds(events)
    return {
        "tracing": tracing,
        "polls": len(hub_polls),
        "last": last_poll,
        "poll_series": [
            {
                "ts": e.get("ts"),
                "targets": e.get("targets"),
                "targets_ok": e.get("targets_ok"),
                "targets_lost": e.get("targets_lost"),
                "slo": e.get("slo") or {},
            }
            for e in hub_polls
        ],
        "targets": targets,
        "losses": losses,
        "stragglers": stragglers,
        "quantiles": quantiles,
        "heat": heat,
        "fleet_rows": fleet_rows or [],
        "exporters": [e for e in telemetry if e.get("source") != "hub"],
    }


# ---- SVG / HTML helpers -----------------------------------------------------


def sparkline(values: List[Optional[float]], width: int = 180,
              height: int = 36, color: str = "#2a7de1") -> str:
    """Inline SVG polyline over ``values`` (Nones skipped); empty input
    renders an empty frame rather than nothing — a panel with no history
    yet still shows WHERE the history will appear."""
    pts = [(i, v) for i, v in enumerate(values) if v is not None]
    if not pts:
        return (f'<svg class="spark" width="{width}" height="{height}">'
                f'</svg>')
    lo = min(v for _, v in pts)
    hi = max(v for _, v in pts)
    span = (hi - lo) or 1.0
    n = max(len(values) - 1, 1)
    coords = " ".join(
        f"{(i / n) * (width - 4) + 2:.1f},"
        f"{height - 4 - ((v - lo) / span) * (height - 8):.1f}"
        for i, v in pts
    )
    return (
        f'<svg class="spark" width="{width}" height="{height}">'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
        f'points="{coords}"/></svg>'
    )


def _fmt(v: Any, nd: int = 2) -> str:
    if isinstance(v, bool) or v is None:
        return html.escape(str(v))
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return html.escape(str(v))


_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       background: #14171c; color: #d8dee6; margin: 1.5rem; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.0rem; margin-top: 1.6rem;
     border-bottom: 1px solid #2a313b; padding-bottom: .3rem; }
table { border-collapse: collapse; margin-top: .5rem; }
td, th { padding: .25rem .7rem; border: 1px solid #2a313b;
         font-size: .85rem; text-align: left; }
th { background: #1b2027; }
.ok { color: #4caf50; } .lost { color: #ef5350; font-weight: 600; }
.warn { color: #ffb300; } .dim { color: #7b8694; }
.spark { vertical-align: middle; background: #1b2027;
         border: 1px solid #2a313b; }
.heat td.cell { width: 1.4rem; height: 1.1rem; padding: 0;
                border: 1px solid #14171c; }
.badge { display: inline-block; padding: .1rem .5rem; border-radius: 3px;
         font-size: .8rem; margin-right: .4rem; }
.badge.ok { background: #1e3a24; } .badge.bad { background: #3a1e1e; }
.wf { display: inline-block; width: 420px; height: 1.1rem;
      background: #1b2027; border: 1px solid #2a313b;
      font-size: 0; white-space: nowrap; overflow: hidden; }
.wf span { display: inline-block; height: 100%; }
.legend span { display: inline-block; width: .8rem; height: .8rem;
               margin: 0 .25rem 0 .8rem; vertical-align: middle; }
"""

# waterfall stage palette: the serve stages in causal order, then the
# router-overhead remainder
_WF_COLORS = (
    ("queue", "#7b8694"), ("cache_lookup", "#2a7de1"),
    ("sample", "#8e5ad1"), ("h2d_copy", "#1faf9b"),
    ("handoff", "#b0a030"), ("execute", "#4caf50"),
    ("reply", "#caa26a"), ("router overhead", "#ef5350"),
)


def _heat_color(ratio: Optional[float]) -> str:
    """Shade a partition-epoch cell by its time relative to the epoch
    median: 1.0 = neutral, hotter = redder."""
    if ratio is None:
        return "#20262e"
    x = max(min((ratio - 1.0) / 1.0, 1.0), 0.0)  # 1.0..2.0x -> 0..1
    r = int(0x2a + x * (0xef - 0x2a))
    g = int(0x7d - x * (0x7d - 0x35))
    b = int(0x52 - x * (0x52 - 0x30))
    return f"#{r:02x}{g:02x}{b:02x}"


def render_html(model: Dict[str, Any], title: str = "fleet telemetry",
                ) -> str:
    out: List[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    last = model["last"]
    if last is not None:
        lost = last.get("targets_lost") or 0
        badge = ("<span class='badge bad'>DEGRADED</span>" if lost
                 else "<span class='badge ok'>HEALTHY</span>")
        out.append(
            f"<p>{badge} {_fmt(last.get('targets_ok'))}/"
            f"{_fmt(last.get('targets'))} targets ok over "
            f"{model['polls']} poll(s); SLO: "
            f"{_fmt((last.get('slo') or {}).get('worst'))} "
            f"({_fmt((last.get('slo') or {}).get('breaching'))} "
            f"breaching)</p>"
        )
    else:
        out.append("<p class='dim'>no hub poll records in this input "
                   "(exporter-only snapshot or trainer stream)</p>")

    # fleet topology -------------------------------------------------------
    out.append("<h2>fleet topology</h2>")
    if model["targets"] or model["exporters"]:
        out.append("<table><tr><th>target</th><th>state</th>"
                   "<th>detail</th></tr>")
        for t, info in sorted(model["targets"].items()):
            cls = "lost" if info["state"] == "LOST" else "ok"
            detail = (
                f"missed {info.get('missed_polls')} poll(s)"
                if info["state"] == "LOST"
                else ("rejoined after a loss" if info.get("rejoined")
                      else "")
            )
            out.append(f"<tr><td>{html.escape(t)}</td>"
                       f"<td class='{cls}'>{info['state']}</td>"
                       f"<td class='dim'>{html.escape(detail)}</td></tr>")
        for e in model["exporters"]:
            who = e.get("replica") or e.get("algorithm") or e.get("run_id")
            hp = e.get("health") or {}
            ok = hp.get("ok")
            cls = "ok" if ok else ("dim" if ok is None else "lost")
            out.append(
                f"<tr><td>{html.escape(str(who))}</td>"
                f"<td class='{cls}'>"
                f"{'ok' if ok else 'unknown' if ok is None else 'BAD'}"
                f"</td><td class='dim'>exporter surface, uptime "
                f"{_fmt(e.get('uptime_s'))}s</td></tr>"
            )
        out.append("</table>")
    else:
        out.append("<p class='dim'>no targets seen</p>")

    # fleet health over time ----------------------------------------------
    series = model["poll_series"]
    if series:
        out.append("<h2>fleet health (per poll)</h2><table>")
        ok_vals = [s.get("targets_ok") for s in series]
        lost_vals = [s.get("targets_lost") for s in series]
        breach = [(s.get("slo") or {}).get("breaching") for s in series]
        out.append(f"<tr><th>targets ok</th>"
                   f"<td>{sparkline(ok_vals, color='#4caf50')}</td>"
                   f"<td>{_fmt(ok_vals[-1])}</td></tr>")
        out.append(f"<tr><th>targets lost</th>"
                   f"<td>{sparkline(lost_vals, color='#ef5350')}</td>"
                   f"<td>{_fmt(lost_vals[-1])}</td></tr>")
        out.append(f"<tr><th>SLO breaching</th>"
                   f"<td>{sparkline(breach, color='#ffb300')}</td>"
                   f"<td>{_fmt(breach[-1])}</td></tr>")
        out.append("</table>")

    # latency quantiles ----------------------------------------------------
    out.append("<h2>latency quantiles (exact merge)</h2>")
    if model["quantiles"]:
        rows_by_name: Dict[str, List[Dict[str, Any]]] = {}
        for row in model["fleet_rows"]:
            for name, q in (row.get("hist_quantiles") or {}).items():
                rows_by_name.setdefault(name, []).append(q)
        out.append("<table><tr><th>histogram</th><th>count</th>"
                   "<th>p50</th><th>p95</th><th>p99</th>"
                   "<th>p99 history (ledger)</th></tr>")
        for name, q in model["quantiles"].items():
            hist_q = rows_by_name.get(name, [])
            spark = sparkline([r.get("p99") for r in hist_q])
            out.append(
                f"<tr><td>{html.escape(name)}</td>"
                f"<td>{_fmt(q.get('count'))}</td>"
                f"<td>{_fmt(q.get('p50'))}</td>"
                f"<td>{_fmt(q.get('p95'))}</td>"
                f"<td>{_fmt(q.get('p99'))}</td>"
                f"<td>{spark}</td></tr>"
            )
        out.append("</table>")
        out.append("<p class='dim'>quantiles reconstructed from native "
                   "1.02-growth buckets via the histogram merge law — "
                   "~1% relative error, NOT the /metrics ladder's</p>")
    else:
        out.append("<p class='dim'>no histograms in this input</p>")

    # per-request waterfall (distributed traces) ---------------------------
    tracing = model.get("tracing")
    if tracing is not None:
        out.append("<h2>per-request waterfall (distributed traces)</h2>")
        ov = {
            q: tracing.get(f"router_overhead_{q}_ms")
            for q in ("p50", "p95", "p99")
        }
        gs = tracing.get("graph_seqs") or []
        ms_ = tracing.get("model_seqs") or []
        out.append(
            f"<p>{_fmt(tracing['n_complete'])}/{_fmt(tracing['n_ok'])} "
            f"complete chains "
            f"(frac {_fmt(tracing['complete_frac'], 3)}); "
            f"router overhead ms p50/p95/p99 = "
            f"{_fmt(ov['p50'])}/{_fmt(ov['p95'])}/{_fmt(ov['p99'])}; "
            f"lineage graph_seq {_fmt(gs[0]) + '..' + _fmt(gs[-1]) if gs else 'n/a'}, "
            f"model_seq {html.escape(','.join(str(m) for m in ms_)) if ms_ else 'n/a'}"
            f"</p>"
        )
        complete = [c for c in tracing["chains"] if c["complete"]]
        complete.sort(key=lambda c: c["total_ms"], reverse=True)
        if complete:
            out.append("<p class='legend dim'>" + "".join(
                f"<span style='background:{col}'></span>{html.escape(nm)}"
                for nm, col in _WF_COLORS
            ) + "</p>")
            out.append("<table><tr><th>req</th><th>total</th>"
                       "<th>stages</th><th>fabric</th></tr>")
            for c in complete[:12]:
                total = c["total_ms"] or 1e-9
                segs = []
                for nm, col in _WF_COLORS[:-1]:
                    d = (c.get("stages_ms") or {}).get(nm)
                    if not d:
                        continue
                    segs.append(
                        f"<span style='width:{d / total * 100:.2f}%;"
                        f"background:{col}' "
                        f"title='{html.escape(nm)}: {d:.3f}ms'></span>"
                    )
                overhead = c.get("router_overhead_ms")
                if overhead and overhead > 0:
                    segs.append(
                        f"<span style='width:"
                        f"{overhead / total * 100:.2f}%;"
                        f"background:{_WF_COLORS[-1][1]}' "
                        f"title='router overhead: {overhead:.3f}ms'>"
                        f"</span>"
                    )
                fabric = ", ".join(
                    f"{c[k]} {lbl}" for k, lbl in (
                        ("n_retries", "retry"), ("n_reroutes", "re-route"),
                        ("n_suspects", "suspect"), ("n_sheds", "shed"),
                    ) if c.get(k)
                ) or "—"
                out.append(
                    f"<tr><td>{html.escape(str(c.get('req_id')))}</td>"
                    f"<td>{_fmt(c['total_ms'])}ms</td>"
                    f"<td><div class='wf'>{''.join(segs)}</div></td>"
                    f"<td class='dim'>{html.escape(fabric)}</td></tr>"
                )
            out.append("</table>")
        incomplete = [
            c for c in tracing["chains"]
            if not c["complete"] and c["status"] == "ok"
        ]
        if incomplete:
            out.append(
                f"<p class='warn'>{len(incomplete)} answered request(s) "
                f"with an incomplete trace chain (replica leg missing — "
                f"torn stream or NTS_TRACE off on a replica)</p>"
            )

    # straggler heat strip -------------------------------------------------
    out.append("<h2>straggler heat strip</h2>")
    heat = model["heat"]
    if heat:
        epochs = sorted({ep for per in heat.values() for ep in per})
        out.append("<table class='heat'><tr><th>partition</th>")
        out.extend(f"<th class='dim'>{ep}</th>" for ep in epochs)
        out.append("</tr>")
        import statistics as _st

        med_by_epoch = {
            ep: _st.median([per[ep] for per in heat.values() if ep in per])
            for ep in epochs
        }
        flagged = {e.get("partition") for e in model["stragglers"]}
        for p in sorted(heat):
            mark = " ⚠" if p in flagged else ""
            out.append(f"<tr><th>p{p}{mark}</th>")
            for ep in epochs:
                s = heat[p].get(ep)
                med = med_by_epoch.get(ep) or 0.0
                ratio = (s / med) if (s and med > 0) else None
                out.append(
                    f"<td class='cell' title='p{p} e{ep}: {_fmt(s, 3)}s' "
                    f"style='background:{_heat_color(ratio)}'></td>"
                )
            out.append("</tr>")
        out.append("</table>")
        for e in model["stragglers"]:
            out.append(
                f"<p class='warn'>straggler: partition "
                f"{_fmt(e.get('partition'))} at epoch "
                f"{_fmt(e.get('epoch'))} — {_fmt(e.get('seconds'), 3)}s "
                f"vs median {_fmt(e.get('median_s'), 3)}s "
                f"({_fmt((e.get('excess') or 0) * 100, 0)}% over, "
                f"{_fmt(e.get('consecutive'))} consecutive) — "
                f"slow-but-alive, advisory</p>"
            )
    else:
        out.append("<p class='dim'>no per-partition timings "
                   "(heartbeat.seconds) in this input</p>")

    out.append(f"<p class='dim'>generated "
               f"{time.strftime('%Y-%m-%d %H:%M:%S')}</p>")
    out.append("</body></html>")
    return "".join(out)


# ---- terminal watch mode ----------------------------------------------------


def watch_line(model: Dict[str, Any]) -> str:
    last = model["last"]
    if last is None:
        return "dashboard: no hub polls yet"
    q = model["quantiles"]
    lat = next(
        (f"{name} p99={v.get('p99'):.1f}" for name, v in q.items()
         if v.get("p99") is not None), "no hists",
    )
    lost = last.get("targets_lost") or 0
    return (
        f"dashboard: poll {model['polls']}: "
        f"{last.get('targets_ok')}/{last.get('targets')} ok"
        + (f" ({lost} LOST)" if lost else "")
        + f" | slo={_fmt((last.get('slo') or {}).get('worst'))}"
        + f" | {lat}"
        + (f" | stragglers={len(model['stragglers'])}"
           if model["stragglers"] else "")
    )


# ---- CLI --------------------------------------------------------------------


def _load(args) -> Dict[str, Any]:
    if args.url:
        events = fetch_url_events(args.url)
    else:
        events = load_stream_events(args.stream)
    fleet_rows = []
    ldir = args.ledger or ledger.ledger_dir()
    if ldir:
        fleet_rows = [r for r in ledger.read_rows(directory=ldir)
                      if r.get("kind") == "fleet"]
    return fabric_model(events, fleet_rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render the fleet telemetry fabric (hub stream or "
        "live hub URL) as one self-contained HTML dashboard"
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--stream", nargs="+",
                     help="merged-stream file(s) or a metrics directory")
    src.add_argument("--url",
                     help="live hub (or exporter) base URL — one "
                     "/telemetry snapshot is fetched")
    ap.add_argument("--out", default="fleet_dashboard.html")
    ap.add_argument("--ledger", default=None,
                    help="perf-ledger dir for quantile history "
                    "sparklines (default NTS_LEDGER_DIR)")
    ap.add_argument("--title", default="fleet telemetry")
    ap.add_argument("--watch", action="store_true",
                    help="terminal ticker instead of HTML")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--polls", type=int, default=None,
                    help="watch mode: stop after N refreshes "
                    "(default: forever)")
    args = ap.parse_args(argv)

    try:
        model = _load(args)
    except Exception as e:
        print(f"dashboard: cannot load input: {e}", file=sys.stderr)
        return 1

    if args.watch:
        n = 0
        try:
            while True:
                print(watch_line(model), flush=True)
                n += 1
                if args.polls is not None and n >= args.polls:
                    break
                time.sleep(args.interval)
                model = _load(args)
        except KeyboardInterrupt:
            pass
        return 0

    doc = render_html(model, title=args.title)
    try:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(doc)
    except OSError as e:
        print(f"dashboard: cannot write {args.out}: {e}", file=sys.stderr)
        return 1
    print(f"dashboard: wrote {args.out} ({len(doc)} bytes; "
          f"{model['polls']} hub poll(s), "
          f"{len(model['quantiles'])} histogram(s), "
          f"{len(model['stragglers'])} straggler record(s))",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
