"""Prediction-drift auditor: the analytic models get audited, not trusted.

Port of ``neutronstarlite_tpu/tools/drift_audit.py``, copied: only the
import paths differ. It reads the obs streams and ledger rows of either
package.

The system leans on analytic predictions in several load-bearing places:
the live wire counters are PRICED by ``wire_accounting``'s formulas (the
``wire.bytes_per_epoch_fwd`` gauge), and the tuner's prior
(``predict_all``/``predict_mesh`` byte scores) prunes the candidate
space and decides outright on a cached-mode miss. Nothing ever checked
those predictions against what actually ran — a mispriced model would
keep winning tuner decisions forever.

This module closes the loop. After a run (the in-process
``audit_registry`` hook in ``ToolkitBase.finalize_metrics``) or offline
over any obs stream (the CLI), it compares:

- **wire_accounting**: the predicted per-epoch forward wire bytes
  (gauge) vs the live per-epoch counter. They are priced by one shared
  formula today, so drift here means a code path desynchronized them —
  exactly the regression the shared-formula design exists to prevent;
- **tune_prior**: within each tuning episode's MEASURED trials, whether
  the prior's ranking held — the prior's byte-argmin candidate vs the
  measured-seconds argmin. Drift = how much slower the prior's pick
  actually ran than the measured best. This is the one that matters on
  a cached-mode miss, where the prior decides alone;
- **wire_quant** (the numerics leg, obs/numerics): the MEASURED relative
  RMS error of the narrowed (bf16) ring payload — the
  ``wire.quant_rel_err`` gauge / ``tensor_stats`` records — against
  ``NTS_QUANT_TOL``. A ``WIRE_DTYPE:bf16`` tuner decision whose measured
  error exceeds the tolerance gets its tune-cache entry flagged for
  re-trial exactly like a mispriced prior: the decision traded accuracy
  for bytes on a payload where the trade measurably does not hold;
- **staleness** (the streaming leg, stream/): how far the served model's
  last fine-tuned sequence point (``finetune_round.seq_hi`` /
  ``stream.model_seq``) lags the graph head the fleet is actually
  serving (``delta_commit.seq`` / ``stream.head_seq``). The implicit
  "prediction" here is the freshness contract — the model was trained
  on the graph it serves — and a lag beyond ``NTS_STALENESS_TOL``
  sequence points is that contract measurably broken: the fine-tune
  worker is not keeping up with the delta rate.

Drift beyond ``--threshold`` (``NTS_DRIFT_TOL``, default 0.1) emits one
typed ``model_drift`` record per disagreement (rendered by
metrics_report as a "prediction drift:" block), and — when the drift
implicates a tuner decision — FLAGS the matching tune-cache entries for
re-trial (``tune/cache.flag_for_retrial``): the next ``NTS_TUNE=measure``
run treats a flagged entry as a loud miss and re-runs real trials
instead of replaying a decision whose cost model was wrong.

Usage:
  python -m neutronstarlite_torch.tools.drift_audit <metrics-dir-or-file>
      [--threshold 0.1] [--tune-dir DIR] [--no-flag] [--emit] [--json]

Exit 0 = no drift, 3 = drift found (distinct from --diff's 2: drift is
a model-quality signal, not a per-run perf regression), 1 = no usable
input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neutronstarlite_torch.obs.ledger import as_number as _num  # noqa: E402
from neutronstarlite_torch.utils.logging import get_logger  # noqa: E402

log = get_logger("tools")

DEFAULT_THRESHOLD = 0.1


def drift_threshold() -> float:
    """``NTS_DRIFT_TOL``: the relative disagreement above which a typed
    ``model_drift`` record is emitted (default 0.1 = 10%)."""
    raw = os.environ.get("NTS_DRIFT_TOL", "")
    if not raw:
        return DEFAULT_THRESHOLD
    try:
        return float(raw)
    except ValueError:
        log.warning("bad NTS_DRIFT_TOL=%r; using %g", raw,
                    DEFAULT_THRESHOLD)
        return DEFAULT_THRESHOLD


def wire_drift(counters: Dict[str, Any], gauges: Dict[str, Any],
               epochs: int, threshold: float) -> List[Dict[str, Any]]:
    """Predicted (gauge) vs observed (live counter / epochs) wire bytes.
    Empty when the run carries no wire telemetry or the two agree within
    the threshold."""
    pred = _num(gauges.get("wire.bytes_per_epoch_fwd"))
    total = _num(counters.get("wire.bytes_fwd"))
    if pred is None or total is None or not epochs:
        return []
    obs_v = total / epochs
    if pred > 0:
        drift = obs_v / pred - 1.0
    else:
        drift = 1.0 if obs_v > 0 else 0.0
    if abs(drift) <= threshold:
        return []
    return [{
        "metric": "wire_bytes_fwd_per_epoch",
        "source": "wire_accounting",
        "predicted": pred,
        "observed": obs_v,
        "drift": drift,
        "threshold": threshold,
    }]


def tune_prior_drift(events: List[Dict[str, Any]],
                     threshold: float) -> List[Dict[str, Any]]:
    """Per tuning episode — a (run_id, family, partitions) group of
    ``tune_trial`` records: did the prior's byte ranking pick the
    measured winner? Drift = measured seconds of the prior's pick /
    measured best - 1. run_id is part of the group key because the CLI
    merges every stream in a dir: without it, two runs' trials of the
    SAME candidate would land in one ranking and the rig's ~20%
    run-to-run swing would read as prior drift."""
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("event") != "tune_trial":
            continue
        groups.setdefault(
            (e.get("run_id"), e.get("family"), e.get("partitions")), []
        ).append(e)
    out: List[Dict[str, Any]] = []
    for (run_id, family, partitions), trials in sorted(
        groups.items(), key=lambda kv: tuple(str(x) for x in kv[0])
    ):
        measured = [
            t for t in trials
            if _num(t.get("seconds")) is not None
            and _num(t.get("predicted_bytes")) is not None
        ]
        if len(measured) < 2:
            continue  # a ranking needs two measured points
        prior_pick = min(measured, key=lambda t: t["predicted_bytes"])
        best = min(measured, key=lambda t: t["seconds"])
        best_s, pick_s = float(best["seconds"]), float(prior_pick["seconds"])
        drift = (pick_s / best_s - 1.0) if best_s > 0 else 0.0
        if drift <= threshold:
            continue
        out.append({
            "metric": "tune_prior_ranking",
            "source": "tune_prior",
            "predicted": best_s,
            "observed": pick_s,
            "drift": drift,
            "threshold": threshold,
            "family": family,
            "partitions": partitions,
            "candidate": prior_pick.get("candidate"),
            "measured_best": best.get("candidate"),
            # the episode's full cache-key facts ride along when the
            # trial records carry them (select._decide stamps them), so
            # flagging can hit exactly the implicated entry instead of
            # every (family, P) entry across graphs and rigs
            "graph_digest": prior_pick.get("graph_digest"),
            "backend": prior_pick.get("backend"),
            "layers": prior_pick.get("layers"),
            "episode_run_id": run_id,
        })
    return out


_NARROW_WIRE = ("bf16", "bfloat16")


def _run_quant_errors(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """{run_id: max measured wire quant error} — from ``tensor_stats``
    records carrying ``quant_rel_err`` (the NTS_QUANT_PROBE / NTS_NUMERICS
    wire groups), with the run_summary ``wire.quant_rel_err`` gauge as
    the records-rotated-away fallback."""
    out: Dict[str, float] = {}
    for e in events:
        err = None
        if e.get("event") == "tensor_stats":
            err = _num(e.get("quant_rel_err"))
        elif e.get("event") == "run_summary":
            err = _num((e.get("gauges") or {}).get("wire.quant_rel_err"))
        if err is None:
            continue
        rid = e.get("run_id")
        out[rid] = max(out.get(rid, 0.0), err)
    return out


def wire_quant_drift(events: List[Dict[str, Any]],
                     quant_threshold: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
    """The numerics leg: per run, the MEASURED relative RMS error of the
    narrowed ring payload (obs/numerics — wire.quant_rel_err) against
    ``NTS_QUANT_TOL``. A breach emits one drift entry; when the stream
    shows the bf16 wire came from a TUNER decision, the entry carries
    the decision's full cache-key facts so ``flag_tune_cache`` marks
    exactly the implicated entry for re-trial — the same loud-miss
    contract mispriced priors get. An explicitly-pinned WIRE_DTYPE:bf16
    run still gets the record (the user deserves the audit), just with
    nothing to flag."""
    if quant_threshold is None:
        from neutronstarlite_torch.obs.numerics import quant_tol

        quant_threshold = quant_tol()
    errors = _run_quant_errors(events)
    if not errors:
        return []
    decisions: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") != "tune_decision":
            continue
        wd = str((e.get("decision") or {}).get("wire_dtype", "")).lower()
        if wd in _NARROW_WIRE or "bf16" in (e.get("candidate") or ""):
            decisions[e.get("run_id")] = e
    out: List[Dict[str, Any]] = []
    for rid, err in sorted(errors.items(), key=lambda kv: str(kv[0])):
        if err <= quant_threshold:
            continue
        entry: Dict[str, Any] = {
            "metric": "wire_quant_rel_err",
            "source": "wire_quant",
            "predicted": quant_threshold,
            "observed": err,
            # NTS_QUANT_TOL=0 is the legitimate "flag ANY measured
            # error" setting — the drift is then the raw error, not a
            # ratio against zero
            "drift": (err / quant_threshold - 1.0) if quant_threshold > 0
            else err,
            "threshold": quant_threshold,
            "episode_run_id": rid,
        }
        d = decisions.get(rid)
        if d is not None:
            entry.update({
                "family": d.get("family"),
                "partitions": d.get("partitions"),
                "candidate": d.get("candidate"),
                "graph_digest": d.get("graph_digest"),
                "backend": d.get("backend"),
                "layers": d.get("layers"),
            })
        out.append(entry)
    return out


def staleness_drift(events: List[Dict[str, Any]],
                    tol: Optional[int] = None) -> List[Dict[str, Any]]:
    """The streaming-freshness leg: per run, the graph-head sequence the
    fleet serves (max ``delta_commit.seq``, with the run_summary
    ``stream.head_seq`` gauge as the records-rotated-away fallback) vs
    the last sequence point the published model was fine-tuned through
    (max ``finetune_round.seq_hi`` / ``stream.model_seq``). A lag beyond
    ``NTS_STALENESS_TOL`` emits one ``source="staleness"`` entry — drift
    and threshold are expressed as fractions of the head (the report's
    rendering contract); the raw ``lag``/``tol`` counts ride along."""
    if tol is None:
        from neutronstarlite_torch.stream.finetune import (
            staleness_tol_from_env,
        )

        tol = staleness_tol_from_env()
    heads: Dict[str, int] = {}
    models: Dict[str, int] = {}
    for e in events:
        rid = e.get("run_id")
        kind = e.get("event")
        if kind == "delta_commit":
            s = _num(e.get("seq"))
            if s is not None:
                heads[rid] = max(heads.get(rid, 0), int(s))
        elif kind == "finetune_round":
            s = _num(e.get("seq_hi"))
            if s is not None:
                models[rid] = max(models.get(rid, 0), int(s))
        elif kind == "run_summary":
            g = e.get("gauges") or {}
            h, m = _num(g.get("stream.head_seq")), _num(
                g.get("stream.model_seq"))
            if h is not None:
                heads[rid] = max(heads.get(rid, 0), int(h))
            if m is not None:
                models[rid] = max(models.get(rid, 0), int(m))
    out: List[Dict[str, Any]] = []
    for rid, head in sorted(heads.items(), key=lambda kv: str(kv[0])):
        model = models.get(rid, 0)
        lag = head - model
        if lag <= tol or head <= 0:
            continue
        out.append({
            "metric": "model_staleness_seq",
            "source": "staleness",
            "predicted": float(head),
            "observed": float(model),
            "drift": float(model) / head - 1.0,
            "threshold": float(tol) / head,
            "head_seq": head,
            "model_seq": model,
            "lag": lag,
            "tol": int(tol),
            "episode_run_id": rid,
        })
    return out


def audit_events(events: List[Dict[str, Any]],
                 threshold: Optional[float] = None,
                 quant_threshold: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
    """Every drift entry one stream's records support (run_summary wire
    pairs + tune episodes + measured wire quant errors). Pure: no
    records emitted, nothing flagged."""
    threshold = threshold if threshold is not None else drift_threshold()
    out: List[Dict[str, Any]] = []
    for e in events:
        if e.get("event") == "run_summary":
            out.extend(wire_drift(
                e.get("counters") or {}, e.get("gauges") or {},
                int(e.get("epochs") or 0), threshold,
            ))
    out.extend(tune_prior_drift(events, threshold))
    out.extend(wire_quant_drift(events, quant_threshold))
    out.extend(staleness_drift(events))
    return out


def flag_tune_cache(drifts: List[Dict[str, Any]],
                    tune_directory: Optional[str] = None) -> List[str]:
    """Flag the tune-cache entries a tuner-prior drift implicates for
    re-trial; returns the flagged entry paths. Matching uses EVERY
    cache-key fact the drift carries (family, partitions, graph digest,
    backend, layers — None facts match anything, tolerating streams
    whose trials predate the key stamping), so one graph's drift on one
    rig never wipes another rig's measured decisions. Each drift dict
    gains ``flagged_entries`` (all basenames) and ``flagged_entry``
    (the first — the compact report cross-link)."""
    from neutronstarlite_torch.tune import cache

    directory = tune_directory or cache.tune_dir()
    if not directory:
        return []
    flagged: List[str] = []
    for d in drifts:
        if d.get("source") not in ("tune_prior", "wire_quant"):
            continue
        if d.get("source") == "wire_quant" and d.get("family") is None:
            # a pinned-cfg bf16 run: measured error, but no tuner
            # decision to flag (and a fact-free find_entries would
            # match EVERY entry in the cache)
            continue
        for path in cache.find_entries(
            directory, family=d.get("family"),
            partitions=d.get("partitions"),
            graph_digest=d.get("graph_digest"),
            backend=d.get("backend"),
            layers=d.get("layers"),
        ):
            if d.get("source") == "wire_quant":
                reason = (
                    f"measured wire quant error {d['observed']:.3g} > "
                    f"NTS_QUANT_TOL {d['threshold']:g} "
                    f"(decision {d.get('candidate')})"
                )
            else:
                reason = (
                    f"prior ranking drift {d['drift'] * 100:+.1f}% "
                    f"(prior pick {d.get('candidate')} vs measured best "
                    f"{d.get('measured_best')})"
                )
            if cache.flag_for_retrial(path, reason):
                flagged.append(path)
                names = d.setdefault("flagged_entries", [])
                names.append(os.path.basename(path))
                d["flagged_entry"] = names[0]
    return flagged


def audit_registry(metrics, epochs: int,
                   threshold: Optional[float] = None) -> List[Dict[str, Any]]:
    """The in-process post-run hook (ToolkitBase.finalize_metrics): audit
    the live registry's wire pair and emit ``model_drift`` records for
    any breach. ``NTS_DRIFT_AUDIT=0`` disables. Never raises."""
    if metrics is None or os.environ.get("NTS_DRIFT_AUDIT", "1") == "0":
        return []
    try:
        threshold = threshold if threshold is not None else drift_threshold()
        snap = metrics.snapshot(include_hists=False)
        drifts = wire_drift(
            snap["counters"], snap["gauges"], epochs, threshold
        )
        # the numerics leg, in-process: a measured wire quant error over
        # NTS_QUANT_TOL leaves its model_drift record in the stream
        # (flagging stays with the offline CLI, which has the tune facts)
        from neutronstarlite_torch.obs.numerics import quant_tol

        qtol = quant_tol()
        qerr = _num(snap["gauges"].get("wire.quant_rel_err"))
        if qerr is not None and qerr > qtol:
            drifts.append({
                "metric": "wire_quant_rel_err",
                "source": "wire_quant",
                "predicted": qtol,
                "observed": qerr,
                "drift": (qerr / qtol - 1.0) if qtol > 0 else qerr,
                "threshold": qtol,
            })
        for d in drifts:
            metrics.event("model_drift", **d)
        return drifts
    except Exception as e:  # telemetry must never fail a run
        log.warning("drift audit failed: %s", e)
        return []


# ---- CLI --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="audit analytic predictions (wire pricing, tuner "
        "priors) against measured telemetry; exit 3 on drift beyond "
        "--threshold"
    )
    ap.add_argument("paths", nargs="+",
                    help="obs JSONL file(s) or NTS_METRICS_DIR-style dirs")
    ap.add_argument("--threshold", type=float, default=None,
                    help="relative drift threshold (default NTS_DRIFT_TOL "
                    "or 0.1)")
    ap.add_argument("--tune-dir", default=None,
                    help="tune cache to flag on tuner-prior drift "
                    "(default NTS_TUNE_DIR)")
    ap.add_argument("--no-flag", action="store_true",
                    help="report only; never touch the tune cache")
    ap.add_argument("--emit", action="store_true",
                    help="write the model_drift records as a new "
                    "drift-audit stream next to the audited one (dirs "
                    "only), so metrics_report renders them")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from neutronstarlite_torch.tools.metrics_report import (
        expand_paths, load_events,
    )

    paths = expand_paths(args.paths)
    if not paths:
        print("no .jsonl inputs found", file=sys.stderr)
        return 1
    events: List[Dict[str, Any]] = []
    for p in paths:
        try:
            events.extend(load_events(p))
        except OSError as e:
            print(f"{p}: {e}", file=sys.stderr)
    if not events:
        print("no parseable records in the inputs", file=sys.stderr)
        return 1

    threshold = (
        args.threshold if args.threshold is not None else drift_threshold()
    )
    drifts = audit_events(events, threshold)
    flagged: List[str] = []
    if drifts and not args.no_flag:
        flagged = flag_tune_cache(drifts, args.tune_dir)

    if drifts and args.emit:
        emit_dir = next((p for p in args.paths if os.path.isdir(p)), None)
        if emit_dir is None:
            print("--emit needs a directory input; skipping emission",
                  file=sys.stderr)
        else:
            from neutronstarlite_torch.obs import registry as obs_registry
            import time as _time

            reg = obs_registry.MetricsRegistry(
                f"driftaudit-{os.getpid()}", algorithm="DRIFTAUDIT",
                path=os.path.join(
                    emit_dir,
                    f"{_time.strftime('%Y%m%d-%H%M%S')}-driftaudit-"
                    f"{os.getpid()}.jsonl",
                ),
            )
            for d in drifts:
                reg.event("model_drift", **d)
            reg.close()

    if args.json:
        print(json.dumps({
            "threshold": threshold,
            "drift": drifts,
            "flagged": [os.path.basename(p) for p in flagged],
        }))
    else:
        if not drifts:
            print(f"drift audit: no prediction drifted beyond "
                  f"{threshold:.0%}")
        for d in drifts:
            if d.get("source") == "staleness":
                print(
                    f"model drift: {d['metric']} model at seq "
                    f"{d['observed']:g} vs graph head {d['predicted']:g} "
                    f"(lag {d['lag']} > NTS_STALENESS_TOL {d['tol']}, "
                    f"source=staleness)"
                )
                continue
            extra = ""
            if d.get("candidate"):
                extra = (
                    f" prior_pick={d['candidate']} "
                    f"measured_best={d.get('measured_best')}"
                )
            if d.get("flagged_entry"):
                extra += f" flagged={d['flagged_entry']}"
            print(
                f"model drift: {d['metric']} predicted={d['predicted']:g} "
                f"observed={d['observed']:g} "
                f"({d['drift'] * 100:+.1f}% > {threshold:.0%}, "
                f"source={d['source']}){extra}"
            )
    return 3 if drifts else 0


if __name__ == "__main__":
    raise SystemExit(main())
