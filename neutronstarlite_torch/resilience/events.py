"""Typed ``fault`` / ``recovery`` records — port of
``neutronstarlite_tpu/resilience/events.py``.

The layers that detect or inject faults (the checkpoint store, the fault
injector, the supervisor) report through one process-level sink: any
object with ``.event(event_kind, **fields)``. Each trainer installs its
metrics registry there when it is built (``models/base.py``), so fault and
recovery records land in the run's stream by default; a caller may
install its own sink instead (the tests install a recording one). Each
record is also logged as the same ``FAULT ...`` / ``RECOVERY ...`` line as
in the reference.

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


def get_sink():
    """The installed sink, or None."""
    return _sink


def adopt_registry(registry) -> None:
    """Install a run's metrics registry as the sink, unless the caller
    installed a sink of another kind (a recording sink in a test): a newer
    run's registry replaces an older run's, never a caller's own sink."""
    from neutronstarlite_torch.obs.registry import MetricsRegistry

    if registry is not None and (_sink is None or isinstance(_sink, MetricsRegistry)):
        set_sink(registry)


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
