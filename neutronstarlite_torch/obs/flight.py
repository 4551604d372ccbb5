"""Fault-triggered flight recorder: the last N records at full resolution.

Port of ``neutronstarlite_tpu/obs/flight.py``, copied: the same records, the same
validation and the same semantics (tests/test_torch_obs.py holds the two
copies against each other).

The JSONL stream answers "what happened over the run"; it cannot answer
"what happened in the seconds before the crash" once ``NTS_METRICS_MAX_MB``
rotation or sampling has thinned it — and a hard death between epoch
boundaries leaves nothing at all. The flight recorder keeps an always-on,
bounded in-memory ring of every record the registry emits (spans included,
full resolution — one deque append per event, cheap enough to run
everywhere) and dumps it to a timestamped ``flight_*.jsonl`` on trigger:

- any ``fault`` or ``rank_loss`` record (detected or injected);
- a ``recovery`` record with ``action=giveup`` (retries exhausted);
- an ``slo_status`` record entering ``state=breach``;
- ``SIGUSR2`` (operator-initiated snapshot of a live run).

Dumps are ordinary schema-valid record streams — ``tools/metrics_report``
and ``tools/trace_timeline`` render them natively (the pre-fault epoch's
spans reconstruct the causal timeline of the failure). Knobs:

- ``NTS_FLIGHT=0`` disables the ring entirely;
- ``NTS_FLIGHT_SPANS`` — ring capacity in records (default 2048);
- ``NTS_FLIGHT_DIR`` — dump directory (default: the ``flight/``
  subdirectory of ``NTS_METRICS_DIR`` — a SUBdirectory so dump records,
  which duplicate stream records at full resolution, never double-count
  when a consumer globs the metrics dir; with neither set, triggers log
  a warning and skip);
- ``NTS_FLIGHT_MAX_DUMPS`` — dump cap (default 16, bounded disk under a
  fault storm). The budget is counted PER DUMP DIRECTORY across every
  recorder in the process — a serve fleet's N replica recorders share
  one NTS_FLIGHT_DIR, and N x 16 dumps from one fault storm is exactly
  the unbounded-disk failure the cap exists to prevent. Fleet replicas
  additionally prefix their dump filenames with the replica id
  (``recorder.tag``) so concurrent dumps never collide on a name and a
  postmortem knows whose ring it is reading.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from neutronstarlite_torch.utils.logging import get_logger, process_index

log = get_logger("obs")


def flight_enabled() -> bool:
    return os.environ.get("NTS_FLIGHT", "1") != "0"


def flight_capacity() -> int:
    raw = os.environ.get("NTS_FLIGHT_SPANS", "")
    try:
        n = int(raw) if raw else 2048
    except ValueError:
        log.warning("NTS_FLIGHT_SPANS=%r is not an int; using 2048", raw)
        n = 2048
    return max(n, 16)


# record kinds that trigger a dump (plus the giveup/breach field checks)
_TRIGGER_KINDS = ("fault", "rank_loss")


# the fleet-wide (per dump directory) dump budget: every recorder in the
# process draws from the same count for a given directory, so N replica
# recorders sharing NTS_FLIGHT_DIR cannot multiply the disk bound by N
_budget_lock = threading.Lock()
_dir_dump_counts: Dict[str, int] = {}


def reset_dump_budget() -> None:
    """Forget the per-directory dump counts (tests)."""
    with _budget_lock:
        _dir_dump_counts.clear()


class FlightRecorder:
    """Bounded ring of recent records + the trigger/dump policy."""

    def __init__(self, capacity: Optional[int] = None, tag: str = ""):
        # the replica id for fleet recorders (serve/fleet.py): prefixes
        # dump filenames so concurrent replica dumps can't collide
        self.tag = tag
        self.capacity = capacity if capacity is not None else flight_capacity()
        self._ring: deque = deque(maxlen=self.capacity)
        # pinned last-known records (obs/numerics tensor_stats etc.):
        # re-written at the head of EVERY dump even after the ring has
        # rotated them out — a postmortem always sees the last numerics
        # state, however long ago the last fetch epoch was
        self.pinned: Dict[str, Dict[str, Any]] = {}
        self._dump_lock = threading.Lock()
        self.dumps: List[str] = []
        raw = os.environ.get("NTS_FLIGHT_MAX_DUMPS", "")
        try:
            self.max_dumps = int(raw) if raw else 16
        except ValueError:  # telemetry must never kill a run
            log.warning("NTS_FLIGHT_MAX_DUMPS=%r is not an int; using 16",
                        raw)
            self.max_dumps = 16
        self.dropped_triggers = 0

    # ---- the hot path (MetricsRegistry.event) ----------------------------
    def record(self, rec: Dict[str, Any]) -> None:
        """One deque append; deque(maxlen=...) is thread-safe and O(1)."""
        self._ring.append(rec)

    def pin(self, key: str, rec: Dict[str, Any]) -> None:
        """Keep ``rec`` as the last-known record under ``key`` (latest
        wins): dumps prepend pinned records the ring no longer holds.
        Shares the dump lock: a pin landing mid-dump must not mutate
        the dict dump() is iterating (telemetry crashing on exactly the
        fault path would be the worst possible failure mode)."""
        with self._dump_lock:
            self.pinned[key] = rec

    def consider(self, rec: Dict[str, Any]) -> Optional[str]:
        """Dump when ``rec`` is a trigger record; returns the dump path."""
        kind = rec.get("event")
        trigger = None
        if kind in _TRIGGER_KINDS:
            trigger = f"{kind}_{rec.get('kind') or rec.get('reason') or ''}"
        elif kind == "recovery" and rec.get("action") == "giveup":
            trigger = "giveup"
        elif kind == "slo_status" and rec.get("state") == "breach":
            trigger = f"slo_breach_{rec.get('metric') or ''}"
        if trigger is None:
            return None
        return self.dump(trigger.rstrip("_"))

    # ---- dumping ---------------------------------------------------------
    def _dump_dir(self) -> Optional[str]:
        d = os.environ.get("NTS_FLIGHT_DIR")
        if d:
            return d
        m = os.environ.get("NTS_METRICS_DIR")
        # a SUBdirectory of the metrics dir: dump records duplicate the
        # stream's at full resolution, and consumers that glob
        # NTS_METRICS_DIR/*.jsonl (tests, report CLIs) must not count
        # every fault twice
        return os.path.join(m, "flight") if m else None

    def dump(self, trigger: str) -> Optional[str]:
        """Write the ring (oldest first) to ``flight_<stamp>-<trigger>``;
        returns the path, or None when skipped (no dir / cap reached)."""
        d = self._dump_dir()
        if d is None:
            log.warning(
                "flight trigger %r but neither NTS_FLIGHT_DIR nor "
                "NTS_METRICS_DIR is set; skipping the dump", trigger,
            )
            return None
        budget_key = os.path.abspath(d)
        with self._dump_lock:
            # the budget is fleet-wide per directory: N replica recorders
            # sharing one NTS_FLIGHT_DIR draw from ONE count
            with _budget_lock:
                used = _dir_dump_counts.get(budget_key, 0)
                if used >= self.max_dumps:
                    self.dropped_triggers += 1
                    return None
                _dir_dump_counts[budget_key] = used + 1
            records = list(self._ring)  # consistent snapshot of the ring
            # pinned last-known records not already in the ring ride the
            # head of the dump (dedup by (run_id, seq) so a recent
            # tensor_stats batch never writes twice)
            in_ring = {(r.get("run_id"), r.get("seq")) for r in records}
            pinned = [
                r for _, r in sorted(self.pinned.items())
                if (r.get("run_id"), r.get("seq")) not in in_ring
            ]
            records = pinned + records
            safe = "".join(
                c if c.isalnum() or c in "-_" else "_" for c in trigger
            ) or "trigger"
            prefix = f"flight_{self.tag}-" if self.tag else "flight_"
            fname = (
                f"{prefix}{time.strftime('%Y%m%d-%H%M%S')}-{safe}"
                f"-p{process_index()}-{os.getpid()}-{used}.jsonl"
            )
            path = os.path.join(d, fname)
            try:
                os.makedirs(d, exist_ok=True)
                with open(path, "w", encoding="utf-8") as fh:
                    for rec in records:
                        fh.write(json.dumps(rec, default=str) + "\n")
            except OSError as e:  # telemetry must never escalate a fault
                log.warning("flight dump to %s failed (%s)", path, e)
                with _budget_lock:  # a failed write spends no budget
                    _dir_dump_counts[budget_key] = max(
                        _dir_dump_counts.get(budget_key, 1) - 1, 0
                    )
                return None
            self.dumps.append(path)
        log.warning(
            "flight recorder: dumped %d record(s) to %s (trigger: %s)",
            len(records), path, trigger,
        )
        return path


# ---- SIGUSR2: operator-initiated snapshot of the live ring -----------------

_active: Optional["weakref.ref[FlightRecorder]"] = None
_signal_installed = False
# the SIGUSR2 handler this module displaced (another recorder's, in a
# process that runs both packages): it still runs after our dump
_displaced = None


def set_active(recorder: Optional[FlightRecorder]) -> None:
    """Install ``recorder`` as the process's SIGUSR2 dump target (latest
    registry wins — the events.set_sink convention) and hook the signal
    once. Signal installation only works on the main thread; elsewhere
    the recorder still rings and record-triggers still dump."""
    global _active, _signal_installed, _displaced
    _active = weakref.ref(recorder) if recorder is not None else None
    if _signal_installed or recorder is None:
        return
    if not hasattr(signal, "SIGUSR2"):  # non-POSIX
        return
    try:
        _displaced = signal.signal(signal.SIGUSR2, _on_sigusr2)
        _signal_installed = True
    except ValueError:  # not the main thread
        pass


def _on_sigusr2(signum, frame) -> None:
    rec = _active() if _active is not None else None
    if rec is not None:
        rec.dump("sigusr2")
    if callable(_displaced) and _displaced is not _on_sigusr2:
        _displaced(signum, frame)
