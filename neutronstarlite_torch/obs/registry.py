"""MetricsRegistry: counters/gauges/timings + the per-run JSONL event sink —
port of ``neutronstarlite_tpu/obs/registry.py``, copied.

One registry per trainer run (ToolkitBase constructs it). Metric state is
always accumulated in memory — snapshots ride inside the ``run_summary``
record that run() attaches to its result — and the JSONL event stream is
additionally written to disk when ``NTS_METRICS_DIR`` is set, under the
same file name and with the same records as the reference's (the port
runs in one process, so the name always carries ``-p0``).

``config_fingerprint`` gives the reference's digest for the same cfg: the
port's ``InputInfo`` holds only the keys the port honours, so its digest
is taken over the reference's full field set (``reference_dict``: the
reference's defaults with the port's values laid over them).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from neutronstarlite_torch.obs import flight as flight_mod
from neutronstarlite_torch.obs.hist import LogHistogram
from neutronstarlite_torch.obs.schema import SCHEMA_VERSION
from neutronstarlite_torch.utils.logging import get_logger, process_index

log = get_logger("obs")


def metrics_dir() -> Optional[str]:
    """The JSONL output directory (``NTS_METRICS_DIR``), or None."""
    return os.environ.get("NTS_METRICS_DIR") or None


def max_stream_bytes() -> int:
    """The per-stream size cap (``NTS_METRICS_MAX_MB``, fractional MB
    allowed) in bytes; 0 = unbounded. A long supervised run with per-hop
    ring records and per-request serve records can otherwise grow its
    JSONL file without limit."""
    raw = os.environ.get("NTS_METRICS_MAX_MB", "")
    if not raw:
        return 0
    try:
        mb = float(raw)
    except ValueError:
        log.warning("NTS_METRICS_MAX_MB=%r is not a number; ignoring", raw)
        return 0
    return int(mb * 2**20) if mb > 0 else 0


def config_fingerprint(cfg: Any) -> str:
    """Stable 12-hex-digit digest of a run configuration (InputInfo, dict,
    or any attribute bag) — the cross-run join key in metrics_report."""
    if cfg is None:
        return "none"
    if hasattr(cfg, "reference_dict"):
        d = cfg.reference_dict()
    elif dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        d = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        d = cfg
    else:
        d = {k: v for k, v in vars(cfg).items() if not k.startswith("_")}
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class _TimingStat:
    """Streaming summary of observed durations (count/total/min/max)."""

    __slots__ = ("count", "total_s", "min_s", "max_s")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    def as_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "avg_s": self.total_s / self.count if self.count else 0.0,
        }


class MetricsRegistry:
    """Counters, gauges, timing summaries, and the JSONL event writer."""

    def __init__(
        self,
        run_id: str,
        algorithm: str = "",
        fingerprint: str = "",
        path: Optional[str] = None,
    ) -> None:
        self.run_id = run_id
        self.algorithm = algorithm
        self.fingerprint = fingerprint
        self.path = path
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._timings: Dict[str, _TimingStat] = {}
        self._hists: Dict[str, LogHistogram] = {}
        self._seq = 0
        self.last_event_ts: Optional[float] = None
        # the always-on flight ring (obs/flight): every record this
        # registry emits lands in it; trigger records dump it. The newest
        # registry owns the process's SIGUSR2 snapshot target.
        self.flight = None
        if flight_mod.flight_enabled():
            self.flight = flight_mod.FlightRecorder()
            flight_mod.set_active(self.flight)
        # the sink opens LAZILY on the first substantive event (anything
        # beyond run_start): tools that construct trainers without running
        # them (aot_check, tests) must not litter NTS_METRICS_DIR with
        # run_start-only streams or leak open handles. run_start lines are
        # buffered and flushed with the first real write.
        self._fh = None
        self._pending: list = []
        # NTS_METRICS_MAX_MB stream size guard (rotate-once-with-warning,
        # see _maybe_rotate); resolved at construction so tests can vary it
        self._max_bytes = max_stream_bytes()
        self._bytes_written = 0
        self.rotations = 0
        self._reemitting_hists = False
        self.summary: Optional[Dict[str, Any]] = None
        # compiled-program cost records (obs/cost.capture_program_cost
        # appends here as well as emitting the typed event) — consolidated
        # into run_summary so bench.py's extra.metrics carries them
        self.program_costs: list = []

    # ---- metric primitives ----------------------------------------------
    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._timings.get(name)
            if stat is None:
                stat = self._timings[name] = _TimingStat()
            stat.observe(float(seconds))

    def hist_observe(self, name: str, value: float, unit: str = "ms") -> None:
        """O(1) record into the named LogHistogram (created on first use)
        — the distribution-preserving alternative to counter_add/observe
        for latency-shaped metrics (obs/hist.py has the error bound)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LogHistogram(unit=unit)
            h.record(value)

    def hist_set(self, name: str, hist: LogHistogram) -> None:
        """Install a fully-built histogram under ``name`` (replacing any
        prior), taking a defensive copy. This is the hub's merged-view
        hook (obs/hub.py): the hub reconstructs and merges its targets'
        histograms OUTSIDE the registry, then installs the result so the
        stock exporter /metrics and ``emit_hists`` render the fleet
        distribution with zero special-casing."""
        with self._lock:
            self._hists[name] = hist.copy()

    def hist(self, name: str) -> Optional[LogHistogram]:
        """The live histogram object (shared, not a copy — read-only use;
        the SLO engine reads bucket geometry off it)."""
        with self._lock:
            return self._hists.get(name)

    def hists(self) -> Dict[str, LogHistogram]:
        """{name: copy} — a consistent point-in-time snapshot (exporter)."""
        with self._lock:
            return {k: h.copy() for k, h in self._hists.items()}

    def hist_view(self, name: str):
        """(count, zero_count, buckets copy) for one histogram, or None —
        the SLO engine's rolling-window subtraction source; cheaper than a
        full copy (no geometry objects rebuilt)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            return (h.count, h.zero_count, dict(h.buckets))

    def counter_get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self, include_hists: bool = True) -> Dict[str, Any]:
        """The metric-state copy; ``include_hists=False`` skips the
        histogram serialization for consumers that only want scalars
        (the exporter's /healthz, or /metrics which takes LogHistogram
        copies via hists() instead of dicts)."""
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": {k: t.as_dict() for k, t in self._timings.items()},
            }
            if include_hists:
                out["hists"] = {
                    k: h.to_dict() for k, h in self._hists.items()
                }
            return out

    def emit_hists(self) -> None:
        """One typed ``hist`` record per histogram — a CUMULATIVE snapshot
        (the latest per name supersedes earlier ones; obs/hist.py has the
        merge semantics). Called at finalize/close, and re-emitted into
        the fresh chunk after an NTS_METRICS_MAX_MB rotation so quantiles
        survive the truncation that used to lose p99 entirely."""
        for name, d in sorted(self.snapshot()["hists"].items()):
            self.event("hist", name=name, **d)

    # ---- event stream ----------------------------------------------------
    def event(self, event_kind: str, **fields: Any) -> Dict[str, Any]:
        """Emit one structured event; returns the record (written as one
        JSONL line when a sink is open). The positional name avoids
        colliding with a ``kind=`` payload field (fault records carry
        one)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        rec: Dict[str, Any] = {
            "event": event_kind,
            "run_id": self.run_id,
            "schema": SCHEMA_VERSION,
            "ts": time.time(),
            "seq": seq,
        }
        rec.update(fields)
        self.last_event_ts = rec["ts"]
        rotated = False
        if self.path is not None:
            line = json.dumps(rec, default=str) + "\n"
            # sink state + writes stay under the lock: serving emits events
            # from multiple threads (batcher flusher + shedding clients),
            # and an unlocked lazy open could double-open the file while
            # interleaved buffered writes tear lines mid-record
            with self._lock:
                if self.path is None:  # another thread disabled the sink
                    pass
                elif self._fh is None and event_kind == "run_start":
                    self._pending.append(line)
                else:
                    try:
                        if self._fh is None:
                            self._fh = open(self.path, "a", encoding="utf-8")
                            for p in self._pending:
                                self._fh.write(p)
                                self._bytes_written += len(p)
                            self._pending.clear()
                            log.info("metrics stream: %s", self.path)
                        self._fh.write(line)
                        self._fh.flush()
                        self._bytes_written += len(line)
                        rotated = self._maybe_rotate_locked()
                    except OSError as e:  # telemetry must never kill a run
                        log.warning(
                            "metrics write failed (%s); disabling sink", e
                        )
                        self._fh = None
                        self.path = None
        # outside the lock: the flight ring/triggers and any post-rotation
        # histogram re-emission must never run under the writer lock
        return self._post_event(rec, rotated)

    def _post_event(self, rec: Dict[str, Any], rotated: bool) -> Dict[str, Any]:
        """Outside-the-lock tail of event(): the flight ring/triggers, and
        the post-rotation histogram re-emission (cumulative snapshots into
        the fresh chunk so quantiles survive the truncation)."""
        if rotated and not self._reemitting_hists:
            self._reemitting_hists = True  # hist records may themselves
            try:                           # rotate; never recurse
                # bounded retry: if the re-emission itself crosses the cap
                # mid-sequence, the fresh chunk would hold only a suffix of
                # the snapshots — emit once more so the newest chunk ends
                # with a complete set (two rounds bound the work; a cap
                # smaller than one snapshot set stays truncated, with the
                # .1 chunk still carrying the rest)
                for _ in range(2):
                    before = self.rotations
                    self.emit_hists()
                    if self.rotations == before:
                        break
            finally:
                self._reemitting_hists = False
        if self.flight is not None:
            self.flight.record(rec)
            self.flight.consider(rec)
        return rec

    def _maybe_rotate_locked(self) -> bool:
        """NTS_METRICS_MAX_MB guard — called with ``self._lock`` held right
        after a write. When the stream crosses the cap, the current file is
        rotated aside to ``<path>.1`` (one previous chunk retained; an older
        ``.1`` is overwritten — bounded disk, not unbounded history) and a
        LOUD ``stream_rotated`` record opens the fresh file, so a consumer
        that sees a truncated history knows it was truncated and why.
        Returns True when a rotation happened (event() then re-emits the
        histogram snapshots into the fresh chunk)."""
        if not self._max_bytes or self._bytes_written < self._max_bytes:
            return False
        rotated_to = self.path + ".1"
        try:
            self._fh.close()
            os.replace(self.path, rotated_to)
            self._fh = open(self.path, "a", encoding="utf-8")
        except OSError as e:
            log.warning("metrics rotation failed (%s); disabling sink", e)
            self._fh = None
            self.path = None
            return False
        seq = self._seq
        self._seq += 1
        marker = {
            "event": "stream_rotated",
            "run_id": self.run_id,
            "schema": SCHEMA_VERSION,
            "ts": time.time(),
            "seq": seq,
            "reason": (
                f"NTS_METRICS_MAX_MB: stream exceeded "
                f"{self._max_bytes / 2**20:g} MB"
            ),
            "rotated_to": rotated_to,
            "bytes_written": self._bytes_written,
        }
        line = json.dumps(marker, default=str) + "\n"
        self._fh.write(line)
        self._fh.flush()
        self.rotations += 1
        self._bytes_written = len(line)
        log.warning(
            "metrics stream %s exceeded NTS_METRICS_MAX_MB; rotated the "
            "first %d bytes to %s (older rotations are overwritten)",
            self.path, marker["bytes_written"], rotated_to,
        )
        return True

    def epoch_event(
        self, epoch: int, seconds: float, loss: Optional[float] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        self.observe("epoch", seconds)
        return self.event(
            "epoch",
            epoch=int(epoch),
            seconds=float(seconds),
            loss=float(loss) if loss is not None else None,
            **extra,
        )

    def run_summary(self, **fields: Any) -> Dict[str, Any]:
        """Emit the consolidated end-of-run record (metric snapshot + the
        caller's aggregates); kept on ``self.summary``. The final
        cumulative ``hist`` snapshots are flushed first so every finalized
        stream carries its distributions as typed records."""
        self.emit_hists()
        snap = self.snapshot()
        rec = self.event(
            "run_summary",
            algorithm=self.algorithm,
            fingerprint=self.fingerprint,
            counters=snap["counters"],
            gauges=snap["gauges"],
            timings=snap["timings"],
            hists=snap["hists"],
            program_costs=list(self.program_costs),
            **fields,
        )
        self.summary = rec
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


def open_run(algorithm: str, cfg: Any = None, seed: int = 0) -> MetricsRegistry:
    """Registry for one trainer run; opens the JSONL sink when
    ``NTS_METRICS_DIR`` is set and emits the ``run_start`` event."""
    fingerprint = config_fingerprint(cfg)
    rank = process_index()
    run_id = f"{(algorithm or 'run').lower()}-{fingerprint}-{os.getpid()}"
    path = None
    d = metrics_dir()
    if d:
        try:
            os.makedirs(d, exist_ok=True)
            fname = (
                f"{time.strftime('%Y%m%d-%H%M%S')}-{run_id}-p{rank}.jsonl"
            )
            path = os.path.join(d, fname)
        except OSError as e:
            log.warning("NTS_METRICS_DIR %r unusable (%s); metrics stay "
                        "in-memory only", d, e)
            path = None
    reg = MetricsRegistry(run_id, algorithm=algorithm,
                          fingerprint=fingerprint, path=path)
    reg.event(
        "run_start",
        algorithm=algorithm,
        fingerprint=fingerprint,
        seed=seed,
        process_index=rank,
        pid=os.getpid(),
    )
    return reg
