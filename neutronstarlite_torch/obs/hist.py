"""Log-bucketed mergeable latency histograms (HDR-style, fixed memory).

Port of ``neutronstarlite_tpu/obs/hist.py``, copied: the same records, the same
validation and the same semantics (tests/test_torch_obs.py holds the two
copies against each other).

Every latency surface obs/ previously summarized as a scalar (`_TimingStat`
min/max/avg) or recomputed by full-sorting raw records (serve_bench's p99
over every ``serve_request`` line — which stream rotation silently
truncates) becomes one :class:`LogHistogram`: geometric buckets with a
bounded relative quantile error, O(1) record, and O(buckets) fixed memory
regardless of sample count. Two histograms with the same geometry merge by
bucket-count addition — associative, commutative, and rank-order
preserving — so per-rank / per-chunk snapshots recombine into the exact
histogram a single observer would have built.

Error bound: with growth ``g`` a value lands in bucket
``i = floor(log(v / min_value) / log(g))`` and is reported as the bucket's
geometric midpoint ``min_value * g^(i+0.5)``, so any reported quantile is
within ``sqrt(g) - 1`` of the nearest-rank exact quantile (relative). The
default ``g = 1.02`` bounds that at ~1.0%; values below ``min_value``
clamp into bucket 0 (sub-nanosecond when observing milliseconds).

Stream serialization (the typed ``hist`` record, obs/schema.py): each
emission is a CUMULATIVE snapshot — within one stream the LATEST record
per (run_id, name) supersedes earlier ones, and records from different
streams/ranks merge. Cumulative (not delta) snapshots are what make p99
survive ``NTS_METRICS_MAX_MB`` rotation: the newest chunk always carries
the whole distribution even after older raw records were rotated away.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

DEFAULT_GROWTH = 1.02
DEFAULT_MIN_VALUE = 1e-3
# fixed-memory bound: bucket indices clamp here, capping representable
# values at min_value * growth^(MAX_BUCKETS) (~1e32 at the defaults) —
# far beyond any latency, and a hard ceiling on per-histogram memory
MAX_BUCKETS = 4096


class LogHistogram:
    """Geometric-bucket histogram: O(1) record, ≤ ``rel_error`` quantiles."""

    __slots__ = ("unit", "growth", "min_value", "_log_g", "count", "sum",
                 "zero_count", "min", "max", "buckets")

    def __init__(self, unit: str = "ms", growth: float = DEFAULT_GROWTH,
                 min_value: float = DEFAULT_MIN_VALUE):
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth!r}")
        if not min_value > 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value!r}")
        self.unit = unit
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_g = math.log(self.growth)
        self.count = 0
        self.sum = 0.0
        self.zero_count = 0  # values <= 0 (rank below every bucket)
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}

    @property
    def rel_error(self) -> float:
        """The documented relative quantile error bound: sqrt(g) - 1."""
        return math.sqrt(self.growth) - 1.0

    # ---- recording -------------------------------------------------------
    def index_of(self, value: float) -> int:
        if value < self.min_value:
            return 0
        i = int(math.log(value / self.min_value) / self._log_g)
        return i if i < MAX_BUCKETS else MAX_BUCKETS - 1

    def bucket_mid(self, index: int) -> float:
        """The bucket's geometric midpoint — the reported quantile value."""
        return self.min_value * self.growth ** (index + 0.5)

    def bucket_upper(self, index: int) -> float:
        return self.min_value * self.growth ** (index + 1)

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= 0.0:
            self.zero_count += 1
            return
        i = self.index_of(v)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    # ---- quantiles -------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate (None when empty); any positive
        answer is within ``rel_error`` of the exact order statistic."""
        if self.count == 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = max(1, math.ceil(q * self.count))
        if rank <= self.zero_count:
            return 0.0
        remaining = rank - self.zero_count
        est = None
        for i in sorted(self.buckets):
            remaining -= self.buckets[i]
            if remaining <= 0:
                est = self.bucket_mid(i)
                break
        if est is None:  # numeric-edge fallback (all mass consumed)
            est = self.bucket_mid(max(self.buckets)) if self.buckets else 0.0
        # the exact extrema are tracked outside the buckets: a bucket
        # midpoint can overshoot the true max by up to half a bucket —
        # clamp so p99 never reports above the largest observed sample
        # (tightens the estimate; never violates the error bound)
        if self.max is not None:
            est = min(est, self.max)
        return est

    def quantiles(self) -> Dict[str, Optional[float]]:
        """The serving-surface {p50, p95, p99} triple."""
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def count_le(self, bound: float) -> int:
        """Samples with (bucket-midpoint) value <= bound — the cumulative
        count the Prometheus exporter renders as ``_bucket{le=...}``."""
        n = self.zero_count
        for i, c in self.buckets.items():
            if self.bucket_mid(i) <= bound:
                n += c
        return n

    # ---- merge (associative, commutative) --------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Merge ``other`` into self in place (same geometry required)."""
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError(
                f"cannot merge histograms with different geometry: "
                f"(g={self.growth}, min={self.min_value}) vs "
                f"(g={other.growth}, min={other.min_value})"
            )
        self.count += other.count
        self.sum += other.sum
        self.zero_count += other.zero_count
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max, other.max)
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        return self

    def delta(self, baseline: Optional["LogHistogram"]) -> "LogHistogram":
        """A new histogram holding the samples recorded since
        ``baseline`` (a prior cumulative snapshot of THIS series; same
        geometry). Exact for counts/buckets/sum; min/max keep the
        current values (a conservative envelope — the true delta extrema
        are unrecoverable from two cumulative snapshots)."""
        if baseline is None:
            return self.copy()
        if (baseline.growth != self.growth
                or baseline.min_value != self.min_value):
            raise ValueError("delta baseline has different geometry")
        d = LogHistogram(self.unit, self.growth, self.min_value)
        d.count = max(self.count - baseline.count, 0)
        d.sum = self.sum - baseline.sum
        d.zero_count = max(self.zero_count - baseline.zero_count, 0)
        d.min = self.min
        d.max = self.max
        d.buckets = {
            i: c - baseline.buckets.get(i, 0)
            for i, c in self.buckets.items()
            if c - baseline.buckets.get(i, 0) > 0
        }
        return d

    def copy(self) -> "LogHistogram":
        h = LogHistogram(self.unit, self.growth, self.min_value)
        h.count = self.count
        h.sum = self.sum
        h.zero_count = self.zero_count
        h.min = self.min
        h.max = self.max
        h.buckets = dict(self.buckets)
        return h

    # ---- serialization (the typed `hist` record body) --------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "unit": self.unit,
            "growth": self.growth,
            "min_value": self.min_value,
            "count": self.count,
            "sum": self.sum,
            "zero_count": self.zero_count,
            "min": self.min,
            "max": self.max,
            "buckets": [[i, self.buckets[i]] for i in sorted(self.buckets)],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LogHistogram":
        h = cls(
            unit=str(d.get("unit", "ms")),
            growth=float(d.get("growth", DEFAULT_GROWTH)),
            min_value=float(d.get("min_value", DEFAULT_MIN_VALUE)),
        )
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.zero_count = int(d.get("zero_count", 0))
        h.min = d.get("min")
        h.max = d.get("max")
        h.buckets = {int(i): int(c) for i, c in d.get("buckets", [])}
        return h


def latest_hists(events: Iterable[Dict[str, Any]]) -> Dict[str, LogHistogram]:
    """Reconstruct the live histograms from a stream's typed ``hist``
    records: records are cumulative snapshots, so the LATEST per
    (run_id, name, rank-suffix of the stream — one stream is one rank)
    supersedes earlier ones within a run, and distinct runs merge.
    Returns {name: merged LogHistogram}; empty when the stream has none."""
    latest: Dict[tuple, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") != "hist":
            continue
        key = (e.get("run_id"), e.get("name"))
        prev = latest.get(key)
        if prev is None or e.get("seq", 0) >= prev.get("seq", 0):
            latest[key] = e
    out: Dict[str, LogHistogram] = {}
    for (_rid, name), rec in latest.items():
        h = LogHistogram.from_dict(rec)
        if name in out:
            try:
                out[name].merge(h)
            except ValueError:
                # geometry drift across runs: keep the larger sample
                if h.count > out[name].count:
                    out[name] = h
        else:
            out[name] = h
    return out


def merged_quantiles(events: Iterable[Dict[str, Any]],
                     name: str) -> Optional[Dict[str, Optional[float]]]:
    """{p50, p95, p99} for one histogram name across a stream's ``hist``
    records, or None when the stream carries no such histogram."""
    h = latest_hists(events).get(name)
    return h.quantiles() if h is not None and h.count else None


# the canonical `le` edge ladder (ms) the Prometheus exporter renders —
# a fixed, monotone set so scrape output stays bounded no matter how many
# native log buckets a histogram holds. The ladder is LOSSY by design: a
# quantile derived from it snaps to the nearest edge (error up to the
# edge spacing — tens of percent between sparse edges), while the native
# log buckets bound quantile error at sqrt(growth)-1 (~1% at 1.02). Exact
# cross-host merging therefore rides the /telemetry endpoint's native
# `hist` records, never the /metrics ladder; NTS_METRICS_LADDER only
# re-shapes what Prometheus scrapes.
PROM_EDGES_MS: List[float] = [
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
]

# parse-once cache keyed by the raw env value: the exporter calls
# prom_edges() on every scrape, and the knob never changes mid-process
_ladder_cache: Optional[Tuple[str, List[float]]] = None


def prom_edges() -> List[float]:
    """The `le` edge ladder the Prometheus exporter renders:
    ``NTS_METRICS_LADDER`` (comma-separated ms edges, strictly
    increasing, all > 0) when set and well-formed, else the canonical
    :data:`PROM_EDGES_MS`. A malformed knob WARNS and falls back — a
    scrape endpoint must never die on an env typo."""
    global _ladder_cache
    raw = os.environ.get("NTS_METRICS_LADDER", "").strip()
    if not raw:
        return PROM_EDGES_MS
    if _ladder_cache is not None and _ladder_cache[0] == raw:
        return _ladder_cache[1]
    try:
        edges = [float(tok) for tok in raw.split(",") if tok.strip()]
        if not edges:
            raise ValueError("no edges")
        if any(e <= 0 for e in edges):
            raise ValueError("edges must be > 0")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError("edges must be strictly increasing")
    except ValueError as e:
        log.warning("bad NTS_METRICS_LADDER=%r (%s); using the default "
                    "%d-edge ladder", raw, e, len(PROM_EDGES_MS))
        edges = PROM_EDGES_MS
    _ladder_cache = (raw, edges)
    return edges
