"""Typed ``fault`` / ``recovery`` records — port of
``neutronstarlite_tpu/resilience/events.py``.

The layers that detect or inject faults (the checkpoint store, the fault
injector, the supervisor) report through one process-level sink: any
object with ``.event(event_kind, **fields)``. The reference installs its
trainer's metrics registry there; the port's registry comes with the obs
slice, so until then no sink is installed unless a caller sets one (the
tests install a recording sink). Each record is also logged as the same
``FAULT ...`` / ``RECOVERY ...`` line as in the reference.

Emission is best-effort: a failing sink degrades to a log line and never
turns a recoverable fault into a fatal one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("resilience")

_sink = None


def set_sink(sink) -> None:
    """Install ``sink`` (an object with ``.event(event_kind, **fields)``, or
    None) as this process's fault/recovery sink."""
    global _sink
    _sink = sink


def emit(event: str, **fields: Any) -> Optional[Dict[str, Any]]:
    """Hand one typed event to the sink; None without a sink."""
    if _sink is None:
        return None
    try:
        return _sink.event(event, **fields)
    except Exception as e:  # telemetry must never escalate a fault
        log.warning("could not emit %s event (%s)", event, e)
        return None


def emit_fault(kind: str, **fields: Any) -> Optional[Dict[str, Any]]:
    """A detected or injected fault (kind: nonfinite_loss,
    nonfinite_params, divergence, stall, crash, exc, ckpt_corrupt)."""
    log.warning("FAULT %s %s", kind, fields or "")
    return emit("fault", kind=kind, **fields)


def emit_recovery(action: str, **fields: Any) -> Optional[Dict[str, Any]]:
    """A recovery action (action: rollback, restart, resume,
    ckpt_fallback, ckpt_retry, giveup)."""
    log.info("RECOVERY %s %s", action, fields or "")
    return emit("recovery", action=action, **fields)
