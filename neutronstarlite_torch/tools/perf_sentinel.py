"""Trend-aware perf regression sentinel over the cross-run ledger.

Port of ``neutronstarlite_tpu/tools/perf_sentinel.py``, copied: only the
import paths differ. It reads the obs streams and ledger rows of either
package.

The pairwise ``metrics_report --diff`` gate has a structural flaw on a
noisy rig: its baseline is ONE run, so the CI host's ~20% run-to-run
throughput swing eats the whole error budget — --tol had to be cranked
to 1.0 on the timing legs, which also waves real regressions through.
The sentinel replaces the single-run baseline with the TRAJECTORY:

  baseline  = median of the last K ledger rows matching the candidate's
              key (kind + graph digest + cfg fingerprint + backend —
              obs/ledger.row_key)
  tolerance = max(nsigma * 1.4826 * MAD, floor) of that same window,
              capped at --max-tol

MAD (median absolute deviation) is the robust spread estimate: the
rig's own observed noise sets the tolerance, so steady ±10% jitter does
NOT trip while a real 25% step-change still does (1.4826 * MAD estimates
sigma for a normal; nsigma=3 puts the gate at the noise's 3-sigma edge).
A single outlier in the history moves neither the median nor the MAD —
the property a mean/stdev baseline lacks.

Exit contract matches ``--diff`` so ci_tier1 adopts it per-gate:
0 = no regression (or not enough matching history to judge — gating on
a guess would be worse than not gating), 2 = regression beyond
tolerance, 1 = usage/unreadable ledger. ``--json`` emits one
machine-readable object in the --diff shape ({tol, metrics:{m:{a, b,
delta, regressed}}, regressed:[...]} plus baseline_n/tol per metric and
a warnings list).

Suite rows additionally get the margin check the ROADMAP kept as a
hand-written note: ``--suite-budget`` (defaulting to the row's own
recorded timeout) warns — or fails with ``--suite-fatal`` — when the
latest suite duration exceeds 80% of the timeout, and warns when
DOTS_PASSED dropped below the baseline median.

Usage:
  python -m neutronstarlite_torch.tools.perf_sentinel check
      [--ledger DIR] [--kind run|suite|probe] [--k 8]
      [--min-baseline 2] [--nsigma 3.0] [--floor 0.08] [--max-tol 0.5]
      [--suite-budget S] [--suite-fatal] [--json]
  python -m neutronstarlite_torch.tools.perf_sentinel record-suite
      --duration S --dots N --rc RC --timeout S [--ledger DIR]
  python -m neutronstarlite_torch.tools.perf_sentinel list-keys
      [--ledger DIR] [--json]     (also: perf_sentinel --list-keys)

``list-keys`` enumerates the distinct (kind, graph digest, cfg,
backend) trajectories the ledger holds with row counts and last-seen
timestamps — the first stop when a check says "min-baseline not met"
(usually the key changed: new backend fingerprint, new cfg, new graph).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neutronstarlite_torch.obs import ledger  # noqa: E402
from neutronstarlite_torch.obs.ledger import as_number as _num  # noqa: E402
# the robust median+MAD tolerance math lives in obs/skew.py now — ONE
# definition shared with the live straggler detector (which applies the
# identical law to per-partition epoch times); re-exported here under the
# historical names so existing callers keep working
from neutronstarlite_torch.obs.skew import (  # noqa: E402,F401
    baseline_stats,
    effective_tolerance,
)

# lower-is-better scalars gated per row kind; hist p99s join dynamically
GATED_METRICS = {
    "run": (
        "warm_median_epoch_s",
        "avg_epoch_s",
        "wire_bytes_fwd_per_epoch",
        "sample_stall_ms_per_epoch",
        # the fused sampler's structural zero (sample/fused.py): any
        # regression that reintroduces a per-batch host transfer grows
        # it off the 0-baseline trajectory
        "sample_h2d_bytes_per_epoch",
        "edge_hbm_bytes_per_epoch",
        "peak_hbm_bytes",
        # measured wire quantization error (obs/numerics): a dtype or
        # rounding regression grows it; the MAD window absorbs float
        # jitter. grad_global_norm is NOT here — it is not
        # lower-is-better; see the advisory two-sided leg in check()
        "wire_quant_rel_err",
    ),
    "suite": ("suite_duration_s",),
    "probe": ("seconds",),
    # serve rows (tools/serve_bench --> obs/ledger.serve_row): tail
    # latency + shed rate trend-gate exactly like epoch time — the key
    # embeds mode/replicas/CB so trajectories never mix load shapes.
    # router_overhead_p99_ms rides only on serve_bench --trace rows
    # (client latency minus the replica's summed stage time, from the
    # merged span streams) — absent on untraced rows, so it just skips
    "serve": ("p50_ms", "p95_ms", "p99_ms", "shed_rate",
              "router_overhead_p99_ms"),
    # fleet rows (obs/hub.fleet_row): the hub's merged cross-host view —
    # the fleet-wide latency tails ride in via hist_quantiles (below),
    # so the scalar tuple only carries the liveness-shaped metrics
    "fleet": ("targets_lost",),
}

SUITE_MARGIN_FRAC = 0.8  # the ROADMAP "watch the margin" note as a number


def _metric_values(row: Dict[str, Any], kind: str) -> Dict[str, float]:
    """The gated scalars one row carries (absent/null metrics skipped);
    hist quantiles flatten to ``hist_<name>_p99`` so serve/epoch tails
    ride the same gate."""
    out: Dict[str, float] = {}
    for m in GATED_METRICS.get(kind, ()):
        v = _num(row.get(m))
        if v is not None:
            out[m] = v
    for name, q in (row.get("hist_quantiles") or {}).items():
        v = _num((q or {}).get("p99"))
        if v is not None:
            out[f"hist_{name}_p99"] = v
    return out


def list_keys(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The distinct (kind, graph digest, cfg, backend) trajectories a
    ledger holds, with row counts and first/last-seen timestamps —
    the answer to "why does the sentinel say min-baseline not met"
    without hand-grepping JSONL."""
    groups: Dict[tuple, Dict[str, Any]] = {}
    for r in rows:
        key = ledger.row_key(r)
        g = groups.get(key)
        ts = _num(r.get("ts"))
        if g is None:
            g = groups[key] = {
                "kind": key[0], "graph_digest": key[1], "cfg": key[2],
                "backend": key[3], "rows": 0,
                "first_ts": ts, "last_ts": ts,
            }
        g["rows"] += 1
        if ts is not None:
            if g["first_ts"] is None or ts < g["first_ts"]:
                g["first_ts"] = ts
            if g["last_ts"] is None or ts > g["last_ts"]:
                g["last_ts"] = ts
    return sorted(
        groups.values(),
        key=lambda g: (str(g["kind"]), -(g["last_ts"] or 0.0)),
    )


def check(rows: List[Dict[str, Any]], kind: str, k: int, min_baseline: int,
          nsigma: float, floor: float, max_tol: float,
          suite_budget: Optional[float] = None) -> Dict[str, Any]:
    """Gate the latest row of ``kind`` against its matching history.

    Returns {candidate, baseline_n, tol, metrics, regressed, warnings};
    ``regressed`` empty when nothing tripped (or history was too thin —
    each skipped metric says so in warnings)."""
    of_kind = [r for r in rows if r.get("kind") == kind]
    out: Dict[str, Any] = {
        "kind": kind, "tol": floor, "metrics": {},
        "regressed": [], "warnings": [],
    }
    if not of_kind:
        out["warnings"].append(f"no {kind} rows in the ledger")
        return out
    cand = of_kind[-1]
    key = ledger.row_key(cand)
    history = [r for r in of_kind[:-1] if ledger.row_key(r) == key]
    if kind == "suite":
        # a failed/timed-out suite execution (nonzero rc) is not a valid
        # baseline: its duration saturates at the timeout and its
        # DOTS_PASSED is truncated, so including it would drag the
        # median toward exactly the degraded state the gate exists to
        # catch. The CANDIDATE is still judged whatever its rc.
        history = [r for r in history if not r.get("rc")]
    window = history[-k:]
    out["candidate"] = {
        "run_id": cand.get("run_id"), "ts": cand.get("ts"),
        "backend": cand.get("backend"), "cfg": cand.get("cfg"),
    }
    out["baseline_n"] = len(window)
    cand_metrics = _metric_values(cand, kind)
    for m, b_val in sorted(cand_metrics.items()):
        base_vals = [
            v for v in (_metric_values(r, kind).get(m) for r in window)
            if v is not None
        ]
        if len(base_vals) < min_baseline:
            out["warnings"].append(
                f"{m}: only {len(base_vals)} matching baseline row(s) "
                f"(< {min_baseline}); not gated"
            )
            continue
        stats = baseline_stats(base_vals)
        med = stats["median"]
        tol = effective_tolerance(med, stats["mad"], nsigma, floor, max_tol)
        if med > 0:
            delta = (b_val - med) / med
            regressed = b_val > med * (1.0 + tol)
        else:
            delta = 1.0 if b_val > 0 else 0.0
            regressed = b_val > tol  # zero baseline: tol is absolute
        out["metrics"][m] = {
            "a": med, "b": b_val, "delta": delta, "regressed": regressed,
            "tol": tol, "mad": stats["mad"], "baseline_n": stats["n"],
        }
        if regressed:
            out["regressed"].append(m)

    if kind == "run":
        # ADVISORY grad-norm trajectory leg (obs/numerics): the final
        # grad_global_norm checked TWO-SIDED against its own history —
        # a norm blowing up OR collapsing to ~0 is an optimization-
        # health drift, but neither direction is "better", so it warns
        # instead of gating (the sentinel's contract for this leg)
        gn = _num(cand.get("grad_global_norm"))
        base_gn = [
            v for v in (_num(r.get("grad_global_norm")) for r in window)
            if v is not None
        ]
        if gn is not None and len(base_gn) >= min_baseline:
            stats = baseline_stats(base_gn)
            med = stats["median"]
            tol = effective_tolerance(med, stats["mad"], nsigma, floor,
                                      max_tol)
            if med > 0 and abs(gn - med) > med * tol:
                out["warnings"].append(
                    f"grad_global_norm: {gn:g} vs baseline median "
                    f"{med:g} ({(gn - med) / med * 100:+.1f}%, beyond "
                    f"±{tol:.0%}) — gradient-scale drift (advisory; "
                    "check the numerics block / tensor_stats records)"
                )
                out["grad_norm_drift"] = True

    if kind == "suite":
        budget = suite_budget if suite_budget is not None else _num(
            cand.get("timeout_s")
        )
        dur = _num(cand.get("suite_duration_s"))
        if budget and dur is not None and dur > SUITE_MARGIN_FRAC * budget:
            out["warnings"].append(
                f"suite_margin: suite ran {dur:.0f}s — over "
                f"{SUITE_MARGIN_FRAC:.0%} of the {budget:.0f}s timeout "
                f"({dur / budget:.0%}); the next noise swing can truncate "
                "a passing run (raise the timeout with ROADMAP.md or trim "
                "the suite)"
            )
            out["suite_margin_exceeded"] = True
        dots = _num(cand.get("dots_passed"))
        base_dots = [
            v for v in (_num(r.get("dots_passed")) for r in window)
            if v is not None
        ]
        if dots is not None and len(base_dots) >= min_baseline:
            med_dots = float(statistics.median(base_dots))
            if dots < med_dots:
                out["warnings"].append(
                    f"dots_passed: {dots:.0f} < baseline median "
                    f"{med_dots:.0f} — fewer tests passing than the "
                    "trajectory"
                )
    return out


def _render(result: Dict[str, Any]) -> str:
    lines = [
        f"perf sentinel: kind={result['kind']} "
        f"baseline_n={result.get('baseline_n', 0)}"
    ]
    header = ("metric", "baseline", "latest", "delta", "tol")
    table = [header]
    for m, d in sorted(result["metrics"].items()):
        table.append((
            m, f"{d['a']:g}", f"{d['b']:g}",
            f"{d['delta'] * 100:+.1f}%" + (
                " REGRESSED" if d["regressed"] else ""
            ),
            f"{d['tol'] * 100:.1f}%",
        ))
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    lines.extend(
        "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        for row in table
    )
    for w in result["warnings"]:
        lines.append(f"  warning: {w}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="trend-aware perf regression sentinel over the "
        "NTS_LEDGER_DIR cross-run ledger (exit 2 on regression)"
    )
    sub = ap.add_subparsers(dest="cmd")

    chk = sub.add_parser("check", help="gate the latest ledger row "
                         "against its matching history")
    chk.add_argument("--ledger", default=None,
                     help="ledger directory (default NTS_LEDGER_DIR)")
    chk.add_argument("--kind", default="run",
                     choices=sorted(GATED_METRICS))
    chk.add_argument("--k", type=int, default=8,
                     help="baseline window: last K matching rows")
    chk.add_argument("--min-baseline", type=int, default=2,
                     help="fewest matching rows a metric needs before it "
                     "gates (thinner history = warn, exit 0)")
    chk.add_argument("--nsigma", type=float, default=3.0,
                     help="MAD multiplier (1.4826*MAD estimates sigma)")
    chk.add_argument("--floor", type=float, default=0.08,
                     help="relative tolerance floor (absolute threshold "
                     "against a zero baseline, the --diff convention)")
    chk.add_argument("--max-tol", type=float, default=0.5,
                     help="relative tolerance cap — a wild history must "
                     "not wave everything through")
    chk.add_argument("--suite-budget", type=float, default=None,
                     help="suite rows: the tier-1 timeout to check the "
                     "80%% margin against (default: the row's own "
                     "recorded timeout_s)")
    chk.add_argument("--suite-fatal", action="store_true",
                     help="escalate the suite-margin warning to exit 2")
    chk.add_argument("--json", action="store_true")

    rec = sub.add_parser("record-suite", help="append one kind=suite row "
                         "(ci_tier1.sh calls this after the pytest leg)")
    rec.add_argument("--ledger", default=None)
    rec.add_argument("--duration", type=float, required=True)
    rec.add_argument("--dots", type=int, required=True)
    rec.add_argument("--rc", type=int, required=True)
    rec.add_argument("--timeout", type=float, required=True)

    lk = sub.add_parser("list-keys", help="enumerate the distinct "
                        "(kind, graph digest, cfg, backend) trajectories "
                        "with row counts and last-seen timestamps")
    lk.add_argument("--ledger", default=None)
    lk.add_argument("--json", action="store_true")

    ap.add_argument("--list-keys", action="store_true",
                    dest="list_keys_flag",
                    help="shorthand for the list-keys subcommand "
                    "(ledger from NTS_LEDGER_DIR)")

    args = ap.parse_args(argv)
    if args.cmd is None and args.list_keys_flag:
        args.cmd = "list-keys"
        args.ledger = None
        args.json = False
    if args.cmd is None:
        ap.error("a subcommand is required (check | record-suite | "
                 "list-keys)")

    directory = args.ledger or ledger.ledger_dir()
    if not directory:
        print("perf_sentinel: no ledger directory (--ledger or "
              "NTS_LEDGER_DIR)", file=sys.stderr)
        return 1

    if args.cmd == "record-suite":
        path = ledger.append_row(
            ledger.suite_row(args.duration, args.dots, args.rc,
                             args.timeout),
            directory=directory,
        )
        if path is None:
            print("perf_sentinel: suite row append failed",
                  file=sys.stderr)
            return 1
        print(f"perf_sentinel: recorded suite row "
              f"({args.duration:.0f}s, {args.dots} dots) -> {path}",
              file=sys.stderr)
        return 0

    path = ledger.ledger_path(directory)
    if not path or not os.path.exists(path):
        # the documented contract: an unreadable/absent ledger is exit 1,
        # not a vacuous pass — a hard gate pointed at a typo'd path must
        # fail loudly, indistinguishable-from-clean is the worst outcome
        print(f"perf_sentinel: no ledger file at {path!r} (nothing was "
              "ever recorded here, or the path is wrong)", file=sys.stderr)
        return 1
    rows = ledger.read_rows(directory=directory)

    if args.cmd == "list-keys":
        keys = list_keys(rows)
        if args.json:
            print(json.dumps({"ledger": path, "keys": keys}))
            return 0
        print(f"perf_sentinel: {len(keys)} trajectory key(s) across "
              f"{len(rows)} row(s) in {path}")
        header = ("kind", "graph_digest", "cfg", "backend", "rows",
                  "last_seen")
        table = [header]
        for g in keys:
            last = g["last_ts"]
            last_s = (
                time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(last))
                if last is not None else "-"
            )
            table.append((
                str(g["kind"]), str(g["graph_digest"])[:16], str(g["cfg"]),
                str(g["backend"])[:24], str(g["rows"]), last_s,
            ))
        widths = [max(len(r[i]) for r in table) for i in range(len(header))]
        for row in table:
            print("  ".join(c.ljust(w) for c, w in zip(row, widths))
                  .rstrip())
        return 0

    result = check(
        rows, args.kind, args.k, args.min_baseline, args.nsigma,
        args.floor, args.max_tol, suite_budget=args.suite_budget,
    )
    result["tol"] = args.floor
    failed = bool(result["regressed"]) or (
        args.suite_fatal and result.get("suite_margin_exceeded")
    )
    if args.json:
        print(json.dumps(result))
    else:
        print(_render(result))
        if result["regressed"]:
            print(
                "REGRESSION beyond MAD tolerance: "
                + "; ".join(
                    f"{m}: {result['metrics'][m]['a']:g} -> "
                    f"{result['metrics'][m]['b']:g} "
                    f"({result['metrics'][m]['delta'] * 100:+.1f}% > "
                    f"{result['metrics'][m]['tol'] * 100:.1f}%)"
                    for m in result["regressed"]
                ),
                file=sys.stderr,
            )
    return 2 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
