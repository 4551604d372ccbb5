"""Per-epoch health checks and the hung-step watchdog — port of
``neutronstarlite_tpu/resilience/guards.py``.

Every run loop calls :func:`epoch_check` through ``ToolkitBase.emit_epoch``
after the epoch's loss is known and before ``ckpt_epoch_end`` could save a
poisoned checkpoint. Checks:

- non-finite loss: :class:`NonFiniteLossError`;
- divergence: loss > ``NTS_DIVERGENCE_FACTOR`` (50) x max(best so far,
  ``NTS_DIVERGENCE_FLOOR`` = 1.0) from epoch ``NTS_DIVERGENCE_WARMUP`` (3)
  on: :class:`DivergenceError`;
- stall: epoch seconds > ``NTS_EPOCH_TIMEOUT_S`` (0 = off), skipping the
  first epoch of each attempt: :class:`StallError`;
- non-finite parameters every ``NTS_GUARD_PARAMS_EVERY`` epochs (default
  1, 0 = off): :class:`NonFiniteParamsError`, naming the leaves as
  ``jax.tree_util.keystr`` does (``obs/numerics.nonfinite_leaf_names``:
  one reduction over every leaf, one host fetch).

Before a non-finite guard raises, ``obs/numerics.capture_provenance``
replays the failing epoch layer by layer and records the first
non-finite layer in a ``nonfinite_provenance`` record.

The guards raise only when armed: inside ``supervised_run``, or forced by
``NTS_GUARDS=1`` (``NTS_GUARDS=0`` forces them off). Unarmed, a non-finite
loss is logged and the run goes on.

:class:`Watchdog` covers a step that never returns: a daemon thread that
interrupts the main thread when no epoch heartbeat arrives in time. The
supervisor arms it only under ``NTS_WATCHDOG_INTERRUPT=1``.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Callable, List, Optional

from neutronstarlite_torch.obs import numerics
from neutronstarlite_torch.resilience import faults
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("guards")


class HealthError(RuntimeError):
    """A guard trip; ``code`` is the kind of its ``fault`` record."""

    code = "health"

    def __init__(self, msg: str, epoch: Optional[int] = None):
        super().__init__(msg)
        self.epoch = epoch


class NonFiniteLossError(HealthError):
    code = "nonfinite_loss"


class NonFiniteParamsError(HealthError):
    code = "nonfinite_params"


class DivergenceError(HealthError):
    code = "divergence"


class StallError(HealthError):
    code = "stall"


# ---- arming ----------------------------------------------------------------

_armed_depth = 0


def guards_armed() -> bool:
    env = os.environ.get("NTS_GUARDS", "")
    if env == "0":
        return False
    if env == "1":
        return True
    return _armed_depth > 0


@contextlib.contextmanager
def armed():
    """Arm the guards for the enclosed (supervised) run."""
    global _armed_depth
    _armed_depth += 1
    try:
        yield
    finally:
        _armed_depth -= 1


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        log.warning("bad %s=%r; using %s", name, os.environ.get(name), default)
        return default


# ---- checks ----------------------------------------------------------------


def nonfinite_leaves(tree) -> List[str]:
    """Key paths of the floating tensors of ``tree`` that hold a NaN or an
    inf (``obs/numerics.nonfinite_leaf_names``)."""
    return numerics.nonfinite_leaf_names(tree)


def _state(toolkit) -> dict:
    st = getattr(toolkit, "_guard_state", None)
    if st is None:
        st = toolkit._guard_state = {"best": None, "epochs_this_attempt": 0}
    return st


def new_attempt(toolkit) -> None:
    """Reset the per-attempt counters before a retry; the best loss
    survives (a rollback restores the parameters that earned it)."""
    _state(toolkit)["epochs_this_attempt"] = 0


def epoch_check(toolkit, epoch: int, seconds: float, loss: Optional[float]) -> None:
    """The per-epoch health gate (called from ``ToolkitBase.emit_epoch``)."""
    heartbeat()
    st = _state(toolkit)
    first_of_attempt = st["epochs_this_attempt"] == 0
    st["epochs_this_attempt"] += 1

    finite = loss is not None and math.isfinite(float(loss))
    if not guards_armed():
        if loss is not None and not finite:
            log.warning(
                "non-finite loss %r at epoch %d (guards unarmed: run continues; "
                "wrap with resilience.supervised_run or NTS_GUARDS=1 to recover)",
                loss, epoch,
            )
        # an unarmed run never replays: a nan_loss@layer=k poison armed
        # this epoch is consumed here, or it would corrupt the next replay
        faults.clear_layer_poison()
        return

    if loss is not None and not finite:
        _capture_provenance(toolkit, epoch, "nonfinite_loss")
        raise NonFiniteLossError(f"non-finite loss {float(loss)!r} at epoch {epoch}",
                                 epoch=epoch)

    factor = env_float("NTS_DIVERGENCE_FACTOR", 50.0)
    floor = env_float("NTS_DIVERGENCE_FLOOR", 1.0)
    warmup = int(env_float("NTS_DIVERGENCE_WARMUP", 3))
    if finite:
        best = st["best"]
        if best is None or float(loss) < best:
            st["best"] = float(loss)
        elif factor > 0 and epoch >= warmup and float(loss) > factor * max(best, floor):
            raise DivergenceError(
                f"loss {float(loss):g} at epoch {epoch} diverged "
                f"(> {factor:g} x max(best={best:g}, {floor:g}))",
                epoch=epoch,
            )

    timeout_s = env_float("NTS_EPOCH_TIMEOUT_S", 0.0)
    if timeout_s > 0 and not first_of_attempt and seconds > timeout_s:
        raise StallError(
            f"epoch {epoch} took {seconds:.3f}s "
            f"(> NTS_EPOCH_TIMEOUT_S={timeout_s:g}s watchdog budget)",
            epoch=epoch,
        )

    every = int(env_float("NTS_GUARD_PARAMS_EVERY", 1.0))
    params = getattr(toolkit, "params", None)
    if every > 0 and params is not None and epoch % every == 0:
        bad = nonfinite_leaves(params)
        if bad:
            _capture_provenance(toolkit, epoch, "nonfinite_params")
            raise NonFiniteParamsError(
                f"non-finite parameters at epoch {epoch}: {', '.join(bad[:8])}"
                + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else ""),
                epoch=epoch,
            )


def _capture_provenance(toolkit, epoch: int, fault_kind: str) -> None:
    """The guard->provenance handoff (obs/numerics.capture_provenance): the
    replay runs the model's own forward, so an error in it raises."""
    numerics.capture_provenance(toolkit, epoch, fault_kind)


# ---- asynchronous watchdog -------------------------------------------------

_active_watchdog: Optional["Watchdog"] = None


def heartbeat() -> None:
    """Signal liveness (every epoch_check beats the active watchdog)."""
    wd = _active_watchdog
    if wd is not None:
        wd.beat()


class Watchdog:
    """Interrupts the main thread when no heartbeat lands within
    ``timeout_s`` (``first_beat_grace_s`` until the first one, which covers
    the attempt's graph load, restore and kernel build). ``interrupt`` is
    injectable for tests; the default raises KeyboardInterrupt in the main
    thread, which the supervisor turns into a StallError."""

    def __init__(self, timeout_s: float,
                 interrupt: Optional[Callable[[], None]] = None,
                 first_beat_grace_s: Optional[float] = None):
        if interrupt is None:
            import _thread

            interrupt = _thread.interrupt_main
        self.timeout_s = float(timeout_s)
        self.first_beat_grace_s = (
            float(first_beat_grace_s) if first_beat_grace_s is not None
            else max(10.0 * self.timeout_s, 60.0)
        )
        self.tripped = False
        self._interrupt = interrupt
        self._last_beat = time.monotonic()
        self._beat_count = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last_beat = time.monotonic()
        self._beat_count += 1

    def start(self) -> "Watchdog":
        global _active_watchdog
        self._last_beat = time.monotonic()  # not beat(): grace until #1
        self._thread = threading.Thread(target=self._loop, name="nts-watchdog", daemon=True)
        _active_watchdog = self
        self._thread.start()
        return self

    def stop(self) -> None:
        global _active_watchdog
        self._stop.set()
        if _active_watchdog is self:
            _active_watchdog = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        poll = max(min(self.timeout_s / 4.0, 0.5), 0.01)
        while not self._stop.wait(poll):
            limit = self.timeout_s if self._beat_count > 0 else self.first_beat_grace_s
            if time.monotonic() - self._last_beat > limit:
                self.tripped = True
                log.warning("watchdog: no epoch heartbeat in %.1fs; interrupting", limit)
                try:
                    self._interrupt()
                finally:
                    return
