"""Declarative SLOs evaluated as rolling multi-window burn rates.

Port of ``neutronstarlite_tpu/obs/slo.py``, copied: the same records, the same
validation and the same semantics (tests/test_torch_obs.py holds the two
copies against each other).

``NTS_SLO_SPEC`` carries objectives like::

    serve_p99_ms<=75@5m;shed_rate<=0.01@1m

Each entry is ``metric<=threshold@window``. Metrics:

==================  =========================================================
``serve_pNN_ms``    quantile NN of the live ``serve.latency_ms`` histogram
``queue_pNN_ms``    quantile NN of ``serve.queue_ms`` (batcher wait)
``epoch_pNN_ms``    quantile NN of ``train.epoch_ms`` (trainer step time)
``shed_rate``       sheds / (answered + sheds) over the window (counters)
==================  =========================================================

Windows take ``ms``/``s``/``m``/``h`` suffixes. A malformed spec raises at
parse time — a typo'd objective silently never evaluating would defeat the
point (the ``NTS_FAULT_SPEC`` loudness contract).

Burn rate (quantile objectives): the SLO ``serve_p99_ms<=75`` allows 1% of
requests over 75 ms; the burn rate is the observed over-threshold fraction
divided by that allowance, computed over a **rolling window** of the live
histogram (cumulative-snapshot deltas, obs/hist.py). Two windows evaluate
per objective — the spec window and a short window (W/12, the classic
fast-burn confirmation) — and the state machine is hysteretic:

- **breach** when BOTH windows burn above 1.0 (sustained + still
  happening);
- **recover** only when both fall below ``RECOVER_FRAC`` (0.9) — the gap
  keeps a burn oscillating around 1.0 from flapping the state (and the
  shed signal) every evaluation.

Each transition (and the first evaluation, so every armed run carries at
least one verdict) emits a typed ``slo_status`` record into the obs
stream; a breach entering also triggers the flight recorder (obs/flight).
``SloEngine.shed_advice`` is the serve admission signal: while a
*sheddable* (latency-quantile) objective is breaching, the effective
queue bound shrinks to ``max_queue / burn`` — under sustained overload
burn-rate shedding fires long before the static hard bound
(serve/batcher.py consults it as the FIRST gate).
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

RECOVER_FRAC = 0.9  # hysteresis: exit breach only below this burn
SHORT_WINDOW_DIV = 12.0  # the fast-confirmation window is W / 12

# metric grammar -> (histogram name, sheddable). Quantile comes from the
# _pNN_ suffix; shed_rate is the one counter-ratio metric.
_QUANTILE_METRICS = {
    "serve": ("serve.latency_ms", True),
    "queue": ("serve.queue_ms", True),
    "epoch": ("train.epoch_ms", False),
}
_QUANTILE_RE = re.compile(r"^(?P<base>[a-z_]+)_p(?P<q>\d{1,2}(?:\.\d+)?)_ms$")


class Objective:
    """One parsed objective (immutable spec + mutable burn state)."""

    __slots__ = ("raw", "metric", "threshold", "window_s", "kind",
                 "hist_name", "q", "sheddable", "state", "burn", "burn_short",
                 "value", "window_count", "emitted")

    def __init__(self, raw: str, metric: str, threshold: float,
                 window_s: float, kind: str, hist_name: Optional[str],
                 q: Optional[float], sheddable: bool):
        self.raw = raw
        self.metric = metric
        self.threshold = threshold
        self.window_s = window_s
        self.kind = kind  # "quantile" | "rate"
        self.hist_name = hist_name
        self.q = q
        self.sheddable = sheddable
        self.state = "ok"
        self.burn: Optional[float] = None
        self.burn_short: Optional[float] = None
        self.value: Optional[float] = None
        self.window_count = 0
        self.emitted = False  # first-evaluation record sent?

    def verdict(self) -> Dict[str, Any]:
        return {
            "objective": self.raw,
            "metric": self.metric,
            "state": self.state,
            "threshold": self.threshold,
            "window_s": self.window_s,
            "value": self.value,
            "burn_rate": self.burn,
            "burn_rate_short": self.burn_short,
            "window_count": self.window_count,
        }


def _parse_window(tok: str, entry: str) -> float:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h)", tok)
    if not m:
        raise ValueError(
            f"bad SLO window {tok!r} in entry {entry!r}; want e.g. "
            "30s / 5m / 1h / 500ms"
        )
    mult = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2)]
    return float(m.group(1)) * mult


def parse_slo_spec(text: str) -> List[Objective]:
    """Parse the ``NTS_SLO_SPEC`` grammar; ValueError on garbage."""
    out: List[Objective] = []
    for entry in (text or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        m = re.fullmatch(
            r"(?P<metric>[a-z0-9_.]+)\s*<=\s*(?P<thr>\d+(?:\.\d+)?)"
            r"\s*@\s*(?P<win>[0-9a-z.]+)", entry,
        )
        if not m:
            raise ValueError(
                f"bad NTS_SLO_SPEC entry {entry!r}; want "
                "metric<=threshold@window (e.g. serve_p99_ms<=75@5m)"
            )
        metric = m.group("metric")
        threshold = float(m.group("thr"))
        window_s = _parse_window(m.group("win"), entry)
        if window_s <= 0:
            raise ValueError(f"SLO window must be > 0 in {entry!r}")
        if metric == "shed_rate":
            out.append(Objective(entry, metric, threshold, window_s,
                                 "rate", None, None, False))
            continue
        qm = _QUANTILE_RE.fullmatch(metric)
        if qm and qm.group("base") in _QUANTILE_METRICS:
            hist_name, sheddable = _QUANTILE_METRICS[qm.group("base")]
            q = float(qm.group("q")) / 100.0
            if not 0.0 < q < 1.0:
                raise ValueError(f"bad SLO quantile in {entry!r}")
            out.append(Objective(entry, metric, threshold, window_s,
                                 "quantile", hist_name, q, sheddable))
            continue
        known = sorted(
            f"{b}_pNN_ms" for b in _QUANTILE_METRICS
        ) + ["shed_rate"]
        raise ValueError(
            f"unknown SLO metric {metric!r} in entry {entry!r}; "
            f"known: {known}"
        )
    return out


class _Snap:
    __slots__ = ("t", "hists", "counters")

    def __init__(self, t: float, hists: Dict[str, Tuple[int, int, Dict[int, int]]],
                 counters: Dict[str, float]):
        self.t = t
        self.hists = hists
        self.counters = counters


class SloEngine:
    """Evaluates objectives over the registry's live histograms/counters.

    ``tick()`` is cheap to call from hot paths (client submit, flusher
    record): it re-evaluates at most every ``eval_interval_s`` and only
    snapshots the histograms the objectives actually reference."""

    def __init__(self, registry, objectives: List[Objective],
                 eval_interval_s: float = 0.25):
        self.registry = registry
        self.objectives = objectives
        self.eval_interval_s = float(eval_interval_s)
        self._lock = threading.Lock()
        self._snaps: deque = deque()
        self._last_eval = 0.0
        self._max_window = max(
            (o.window_s for o in objectives), default=0.0
        )
        # history snapshots are retained at half the SHORTEST confirmation
        # window — the finest delta any objective ever subtracts — so a
        # 1h objective keeps O(dozens) bucket-dict copies, not one per
        # 0.25s evaluation (window-length error from the spacing is at
        # most 1.5x on the short window; burn rates are fractions, so the
        # length error largely cancels between numerator and denominator)
        self._snap_spacing = min(
            (max(o.window_s / SHORT_WINDOW_DIV, 2 * self.eval_interval_s)
             for o in objectives),
            default=self.eval_interval_s,
        ) / 2.0
        self._hist_names = sorted(
            {o.hist_name for o in objectives if o.hist_name}
        )
        self._need_counters = any(o.kind == "rate" for o in objectives)

    @classmethod
    def from_env(cls, registry, spec: Optional[str] = None,
                 scope: Optional[str] = None) -> Optional["SloEngine"]:
        """Engine for ``NTS_SLO_SPEC`` (or an explicit spec); None when
        unset/empty. Parse errors raise — a typo'd objective must not
        silently disarm SLO-driven shedding.

        ``scope`` filters to the objectives this surface can actually
        observe — ``"serve"`` (serve/queue latency + shed_rate, the
        InferenceServer) or ``"train"`` (epoch time, ToolkitBase) — so
        one shared spec arms each metric in exactly one place and a
        training run never emits vacuous verdicts for serve objectives
        it has no samples for."""
        raw = spec if spec is not None else os.environ.get("NTS_SLO_SPEC", "")
        objectives = parse_slo_spec(raw)
        if scope == "serve":
            objectives = [
                o for o in objectives
                if o.kind == "rate"
                or (o.hist_name or "").startswith("serve.")
            ]
        elif scope == "train":
            objectives = [
                o for o in objectives if o.hist_name == "train.epoch_ms"
            ]
        if not objectives:
            return None
        log.info("SLO engine armed (%s): %s", scope or "all",
                 "; ".join(o.raw for o in objectives))
        return cls(registry, objectives)

    # ---- snapshot plumbing ----------------------------------------------
    def _take_snapshot(self, now: float) -> _Snap:
        hists: Dict[str, Tuple[int, int, Dict[int, int]]] = {}
        for name in self._hist_names:
            view = self.registry.hist_view(name)
            if view is not None:
                hists[name] = view
        counters: Dict[str, float] = {}
        if self._need_counters:
            for c in ("serve.shed", "serve.requests"):
                counters[c] = self.registry.counter_get(c)
        return _Snap(now, hists, counters)

    def _window_base(self, now: float, window_s: float) -> Optional[_Snap]:
        """The snapshot at (or nearest before) ``now - window_s`` — the
        subtraction base for the rolling delta. None when the engine is
        younger than the window (zero baseline: the delta then counts
        everything observed so far, which IS the window's content)."""
        target = now - window_s
        base = None
        for s in self._snaps:
            if s.t <= target:
                base = s
            else:
                break
        return base

    @staticmethod
    def _hist_delta(new: Optional[Tuple[int, int, Dict[int, int]]],
                    old: Optional[Tuple[int, int, Dict[int, int]]]):
        if new is None:
            return 0, 0, {}
        n_count, n_zero, n_buckets = new
        if old is None:
            return n_count, n_zero, dict(n_buckets)
        o_count, o_zero, o_buckets = old
        buckets = {
            i: c - o_buckets.get(i, 0)
            for i, c in n_buckets.items()
            if c - o_buckets.get(i, 0) > 0
        }
        return max(n_count - o_count, 0), max(n_zero - o_zero, 0), buckets

    def _quantile_burn(self, obj: Objective, new: _Snap,
                       base: Optional[_Snap]):
        """(burn, value, n) over the delta between two cumulative
        histogram snapshots."""
        h = self.registry.hist(obj.hist_name)
        count, zero, buckets = self._hist_delta(
            new.hists.get(obj.hist_name),
            base.hists.get(obj.hist_name) if base is not None else None,
        )
        n = count
        if n == 0 or h is None:
            return None, None, 0
        bad = sum(c for i, c in buckets.items()
                  if h.bucket_mid(i) > obj.threshold)
        allowed = max(1.0 - obj.q, 1e-9)
        burn = (bad / n) / allowed
        # the window's quantile estimate (nearest rank over the delta)
        rank = max(1, math.ceil(obj.q * n))
        value: Optional[float] = None
        if rank <= zero:
            value = 0.0
        else:
            remaining = rank - zero
            for i in sorted(buckets):
                remaining -= buckets[i]
                if remaining <= 0:
                    value = h.bucket_mid(i)
                    break
        return burn, value, n

    def _rate_burn(self, obj: Objective, new: _Snap, base: Optional[_Snap]):
        shed = new.counters.get("serve.shed", 0.0) - (
            base.counters.get("serve.shed", 0.0) if base is not None else 0.0
        )
        answered = new.counters.get("serve.requests", 0.0) - (
            base.counters.get("serve.requests", 0.0)
            if base is not None else 0.0
        )
        total = shed + answered
        if total <= 0:
            return None, None, 0
        rate = shed / total
        burn = rate / max(obj.threshold, 1e-9)
        return burn, rate, int(total)

    # ---- evaluation ------------------------------------------------------
    def tick(self, now: Optional[float] = None, force: bool = False) -> None:
        """Re-evaluate every objective (rate-limited); emits ``slo_status``
        records on state transitions and on each objective's first
        evaluation."""
        t = time.time() if now is None else float(now)
        transitions: List[Objective] = []
        with self._lock:
            if not force and t - self._last_eval < self.eval_interval_s:
                return
            self._last_eval = t
            snap = self._take_snapshot(t)
            # the fresh snapshot is always the delta's "new" side; it only
            # joins the retained history at the spacing granularity
            if not self._snaps or t - self._snaps[-1].t >= self._snap_spacing:
                self._snaps.append(snap)
            horizon = t - self._max_window - 2 * self._snap_spacing
            while len(self._snaps) > 2 and self._snaps[1].t < horizon:
                self._snaps.popleft()
            for obj in self.objectives:
                short_w = max(obj.window_s / SHORT_WINDOW_DIV,
                              2 * self.eval_interval_s)
                long_base = self._window_base(t, obj.window_s)
                short_base = self._window_base(t, short_w)
                if obj.kind == "quantile":
                    burn, value, n = self._quantile_burn(obj, snap, long_base)
                    burn_s, _v, _n = self._quantile_burn(obj, snap, short_base)
                else:
                    burn, value, n = self._rate_burn(obj, snap, long_base)
                    burn_s, _v, _n = self._rate_burn(obj, snap, short_base)
                obj.burn, obj.burn_short = burn, burn_s
                obj.value, obj.window_count = value, n
                prev = obj.state
                if prev == "ok":
                    if (burn is not None and burn > 1.0
                            and burn_s is not None and burn_s > 1.0):
                        obj.state = "breach"
                else:  # breach: hysteretic exit
                    if ((burn is None or burn < RECOVER_FRAC)
                            and (burn_s is None or burn_s < RECOVER_FRAC)):
                        obj.state = "ok"
                if obj.state != prev or not obj.emitted:
                    obj.emitted = True
                    # capture the verdict UNDER the lock: a concurrent
                    # tick could flip the state again before emission,
                    # and the breach record (the flight trigger) must
                    # reflect the transition that was detected
                    transitions.append((obj.metric, obj.verdict()))
        # emission outside the lock: registry.event takes its own lock and
        # may trigger a flight dump on a breach record
        for metric, verdict in transitions:
            try:
                self.registry.event("slo_status", **verdict)
                self.registry.gauge_set(f"slo.{metric}", verdict["state"])
            except Exception as e:  # telemetry must never kill serving
                log.warning("slo_status emit failed (%s)", e)
            if verdict["state"] == "breach":
                log.warning(
                    "SLO BREACH %s: burn=%.2f short=%.2f value=%s",
                    verdict["objective"], verdict["burn_rate"] or 0.0,
                    verdict["burn_rate_short"] or 0.0, verdict["value"],
                )

    # ---- consumers -------------------------------------------------------
    def verdicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [o.verdict() for o in self.objectives]

    def route_state(self) -> Tuple[bool, float]:
        """(draining, burn): whether any *sheddable* objective is in
        breach, and the worst sheddable burn rate — the serve fleet's
        in-process consumption of the /slo surface (least-burn routing
        + drain-on-breach, serve/fleet.py). Call after a ``tick()``."""
        with self._lock:
            burn = 0.0
            draining = False
            for o in self.objectives:
                if not o.sheddable:
                    continue
                burn = max(burn, o.burn or 0.0)
                if o.state == "breach":
                    draining = True
            return draining, burn

    def shed_advice(self, queue_depth: int, max_queue: int,
                    now: Optional[float] = None) -> Optional[str]:
        """The burn-rate admission gate (serve/batcher.py's FIRST gate):
        while a sheddable objective is breaching, the effective queue
        bound shrinks to ``max_queue / burn`` — returns the shed reason,
        or None to admit. Always admits into an empty queue (soft bound
        >= 1), so total shed-out cannot starve the window of the fresh
        completions that would let the burn recover."""
        self.tick(now=now)
        with self._lock:
            worst: Optional[Objective] = None
            for o in self.objectives:
                if not (o.sheddable and o.state == "breach"):
                    continue
                if worst is None or (o.burn or 0.0) > (worst.burn or 0.0):
                    worst = o
            if worst is None:
                return None
            burn = max(worst.burn or 1.0, 1.0)
            soft = max(1, int(max_queue / burn))
            if queue_depth < soft:
                return None
            return (
                f"slo_burn {worst.metric} burn={burn:.1f} "
                f"(depth {queue_depth} >= soft bound {soft})"
            )

    def close(self) -> None:
        """Final forced evaluation so the stream's last ``slo_status``
        reflects end-of-run state."""
        try:
            self.tick(force=True)
        except Exception as e:
            log.warning("slo final tick failed (%s)", e)
