"""Supervised training: rollback to the last good checkpoint with bounded
retries — port of ``neutronstarlite_tpu/resilience/supervisor.py``.

``supervised_run(toolkit)`` arms the guards, runs ``toolkit.run()`` and, on
a :class:`~.guards.HealthError`:

1. emits one ``fault`` record (kind = the guard's code);
2. gives up with :class:`RetriesExhaustedError`, naming every fault code
   seen, once ``NTS_MAX_RESTARTS`` (default 2) retries are spent;
3. otherwise sleeps ``NTS_BACKOFF_BASE_S`` (default 0.5) x 2^(attempt-1) x
   (1 + jitter), the jitter a seeded fraction in [0, 0.5) per (process,
   attempt), so workers that fail together do not retry in lockstep;
4. after two divergences in a row scales the learning rate by
   ``NTS_LR_BACKOFF`` (default 0.5; 1.0 disables);
5. rolls back when the checkpoint directory holds a checkpoint: the retry's
   ``run()`` resumes through ``ckpt_begin`` from the last good step (the
   guards trip before ``ckpt_epoch_end``, so a poisoned epoch is never
   saved). Without one, or after an LR change, it re-initialises the
   parameters, the optimizer and its config on the tables already built
   (``toolkit.init_model()``): the graph tables are not rebuilt;
6. emits one ``recovery`` record (rollback or restart) and retries.

Elastic mode (``NTS_ELASTIC=1``, resilience/elastic): on a
:class:`~.elastic.RankLossError` that names the lost partition, on a
multi-partition plan of the sim twin, the supervisor replans instead
(``elastic.replan_survivors``: P -> P - 1, in a ``replan`` span), restores
the replicated parameters from the last good checkpoint over the new plan
and records ``recovery(action=replan, partitions=P')``. A loss without a
partition (a collective timeout), a one-partition plan, or real ranks
(which cannot evict a member, ``elastic.RANKS_CAVEAT``) roll back on the
same plan. The dead set is cleared when ``supervised_run`` exits, so an
injected death never leaks into the next run in the process.

A run killed outright (a crash fault, a preemption) is recovered by the
next invocation, which resumes from the checkpoint (``ckpt_begin`` records
``resume``).

Telemetry (obs/): each attempt is an ``attempt`` span, the backoff sleep a
``backoff`` span and a re-initialisation a ``rebuild`` span on the
toolkit's tracer; the ``resilience.state`` / ``resilience.attempt`` /
``resilience.gave_up`` gauges and the ``resilience.faults`` /
``resilience.restarts`` / ``resilience.replans`` counters go to its
registry. The toolkit's
registry becomes the fault/recovery sink unless the caller installed a
sink of another kind.
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Any, Dict, List, Optional

from neutronstarlite_torch.obs.trace import Tracer
from neutronstarlite_torch.resilience import elastic, events, guards
from neutronstarlite_torch.resilience.guards import env_float
from neutronstarlite_torch.utils.logging import get_logger, process_index

log = get_logger("supervisor")


class RetriesExhaustedError(RuntimeError):
    """Every allowed restart failed; carries the last fault and every
    distinct ``HealthError.code`` seen across the attempts."""

    def __init__(self, msg: str, last_error: Optional[BaseException] = None,
                 codes: Optional[List[str]] = None):
        super().__init__(msg)
        self.last_error = last_error
        self.codes = list(codes or [])


def backoff_jitter_frac(attempt: int) -> float:
    """Seeded jitter in [0, 0.5) per (process, attempt); the seed is the
    process index unless ``NTS_BACKOFF_JITTER_SEED`` sets it."""
    seed = os.environ.get("NTS_BACKOFF_JITTER_SEED") or str(process_index())
    return 0.5 * random.Random(f"{seed}:{attempt}").random()


def _should_replan(toolkit, err: guards.HealthError) -> bool:
    """The survivor replan applies when elastic mode is armed, the fault
    is a rank loss that names the lost partition, and the trainer has a
    multi-partition plan of the sim twin to shrink."""
    if not (elastic.elastic_enabled() and isinstance(err, elastic.RankLossError)):
        return False
    if err.partition is None:
        # a collective timeout cannot name the partition: evicting a guess
        # could drop a healthy rank
        log.warning("rank loss without an identified partition (%s): cannot replan — "
                    "falling back to same-plan rollback", err)
        return False
    dist = getattr(toolkit, "dist", None)
    if dist is None or dist.partitions <= 1:
        log.warning("rank loss but no multi-partition plan to shrink — falling back to "
                    "same-plan rollback")
        return False
    if getattr(toolkit, "world", None) is not None:
        log.warning("rank loss on real ranks: %s", elastic.RANKS_CAVEAT)
        return False
    return True


def _have_restorable_checkpoint(toolkit) -> bool:
    """A look at the files only; restore verifies the digests, and when it
    rejects every step the retry's ckpt_begin re-initialises the model."""
    ckpt_dir = toolkit.cfg.checkpoint_dir
    if not ckpt_dir:
        return False
    from neutronstarlite_torch.utils.checkpoint import have_checkpoint

    try:
        return have_checkpoint(ckpt_dir, backend=toolkit.cfg.ckpt_backend)
    except (OSError, RuntimeError) as e:  # an unreadable directory counts as none
        log.warning("checkpoint probe of %s failed: %s", ckpt_dir, e)
        return False


def supervised_run(
    toolkit,
    max_restarts: Optional[int] = None,
    backoff_base_s: Optional[float] = None,
) -> Dict[str, Any]:
    """``toolkit.run()`` under the guards, with rollback and retries.
    Returns run()'s result; raises :class:`RetriesExhaustedError` when the
    restarts are spent."""
    if max_restarts is None:
        max_restarts = int(env_float("NTS_MAX_RESTARTS", 2.0))
    if backoff_base_s is None:
        backoff_base_s = env_float("NTS_BACKOFF_BASE_S", 0.5)
    lr_backoff = env_float("NTS_LR_BACKOFF", 0.5)
    watchdog_s = env_float("NTS_EPOCH_TIMEOUT_S", 0.0)
    use_interrupt = os.environ.get("NTS_WATCHDOG_INTERRUPT", "0") == "1"

    metrics = getattr(toolkit, "metrics", None)
    events.adopt_registry(metrics)
    tracer = getattr(toolkit, "tracer", None) or Tracer(metrics)

    def gauge(name, value):
        if metrics is not None:
            metrics.gauge_set(name, value)

    attempt = 0
    divergence_streak = 0
    codes_seen: List[str] = []
    with guards.armed(), contextlib.ExitStack() as cleanup:
        # injected deaths must not leak into the next run in this process;
        # the retries inside this loop still see them
        cleanup.callback(elastic.reset)
        while True:
            watchdog = None
            if watchdog_s > 0 and use_interrupt:
                grace = env_float("NTS_WATCHDOG_GRACE_S", 0.0)
                watchdog = guards.Watchdog(
                    watchdog_s, first_beat_grace_s=grace if grace > 0 else None,
                ).start()
            attempt_span = tracer.begin("attempt", cat="resilience", attempt=attempt + 1)
            gauge("resilience.state", "running")
            gauge("resilience.attempt", attempt + 1)
            try:
                try:
                    result = toolkit.run()
                    tracer.end(attempt_span, outcome="ok")
                    gauge("resilience.state", "ok")
                    return result
                except KeyboardInterrupt:
                    # only the watchdog's interrupt is a fault; a real
                    # Ctrl-C still ends the run
                    if watchdog is not None and watchdog.tripped:
                        raise guards.StallError(
                            f"watchdog: no epoch heartbeat within {watchdog_s:g}s"
                        ) from None
                    raise
                finally:
                    # disarm before handling: the backoff below beats no
                    # heartbeat
                    if watchdog is not None:
                        watchdog.stop()
            except guards.HealthError as err:
                tracer.end(attempt_span, outcome=err.code)
                attempt += 1
                if metrics is not None:
                    metrics.counter_add("resilience.faults")
                events.emit_fault(err.code, epoch=err.epoch, attempt=attempt, error=str(err))
                log.warning("supervised run attempt %d failed: [%s] %s",
                            attempt, err.code, err)
                if err.code not in codes_seen:
                    codes_seen.append(err.code)
                gauge("resilience.state", "retrying")
                if attempt > max_restarts:
                    gauge("resilience.state", "gave_up")
                    gauge("resilience.gave_up", 1)
                    events.emit_recovery(action="giveup", attempt=attempt, epoch=err.epoch)
                    raise RetriesExhaustedError(
                        f"giving up after {attempt - 1} restart(s) "
                        f"(NTS_MAX_RESTARTS={max_restarts}); fault codes seen "
                        f"across attempts: {', '.join(codes_seen)}; last fault: "
                        f"[{err.code}] {err}",
                        last_error=err, codes=codes_seen,
                    ) from err
                divergence_streak = (
                    divergence_streak + 1 if isinstance(err, guards.DivergenceError) else 0
                )
                if backoff_base_s > 0:
                    delay = backoff_base_s * (2.0 ** (attempt - 1))
                    delay *= 1.0 + backoff_jitter_frac(attempt)
                    log.info("backing off %.2fs before restart", delay)
                    with tracer.span("backoff", cat="resilience", attempt=attempt,
                                     delay_s=delay):
                        time.sleep(delay)
                scale_lr = False
                replan_extra: Dict[str, Any] = {}
                if _should_replan(toolkit, err):
                    # the plan for P - 1 at the rollback boundary; the
                    # retry restores the parameters over it
                    with tracer.span("replan", cat="resilience", attempt=attempt,
                                     lost_partition=err.partition):
                        new_p = elastic.replan_survivors(toolkit, err.partition)
                    rollback = _have_restorable_checkpoint(toolkit)
                    action = "replan"
                    replan_extra = {"partitions": new_p}
                    if metrics is not None:
                        metrics.counter_add("resilience.replans")
                else:
                    scale_lr = (divergence_streak >= 2 and lr_backoff > 0
                                and lr_backoff != 1.0)
                    if scale_lr:
                        old = toolkit.cfg.learn_rate
                        toolkit.cfg.learn_rate = old * lr_backoff
                        log.warning("repeated divergence: scaling LR %g -> %g",
                                    old, toolkit.cfg.learn_rate)
                    rollback = _have_restorable_checkpoint(toolkit)
                    if scale_lr or not rollback:
                        # fresh parameters and an AdamConfig with the new
                        # rate; with a checkpoint the retry restores over them
                        with tracer.span("rebuild", cat="resilience", attempt=attempt):
                            toolkit.init_model()
                    action = "rollback" if rollback else "restart"
                if not rollback:
                    # a restart's failed attempt leaves no epochs behind
                    # (a rollback rewinds in ckpt_begin instead)
                    toolkit.epoch_times.clear()
                    toolkit.loss_history.clear()
                    toolkit._first_epoch_trained = None
                if metrics is not None:
                    metrics.counter_add("resilience.restarts")
                guards.new_attempt(toolkit)
                # tells ckpt_begin not to record a second "resume", and to
                # re-initialise when a chosen rollback finds no intact step
                toolkit._supervised_retry = "rollback" if rollback else "restart"
                events.emit_recovery(
                    action=action, attempt=attempt, epoch=err.epoch, fault=err.code,
                    **replan_extra,
                    **({"lr_scaled_to": toolkit.cfg.learn_rate} if scale_lr else {}),
                )
            except BaseException as e:
                # not a health fault (a real Ctrl-C, a CUDA error): it
                # propagates, and the failed attempt's span still lands
                tracer.end(attempt_span, outcome=type(e).__name__)
                raise
