"""Continuous fine-tune worker: the model follows the streaming graph —
port of ``neutronstarlite_tpu/stream/finetune.py``.

Deltas commit into the stream log, the ingestor applies them to the
serving fleet and accumulates the DIRTY region (vertices whose aggregation
inputs changed), and between serve flushes this worker drains that region:
a few epochs of the sampled trainer's own batch step over seeds biased
toward dirty vertices, then a checkpoint through the digest-verified path,
published through a callback (a rollout hook, or None).

Isolation contract: training updates ``toolkit.params`` in place, and
every serving engine serves its own copy of the weights it restored
(serve/engine.py), so in-flight serving never sees half-trained weights.
New weights reach traffic only through the published checkpoint.

The round's seeds and batches are the reference's numpy draws: the same
Generator gives the same ``dirty_biased_seeds`` and the same host Sampler
batches (same batch_size and fanouts as training, so the same static
capacities). Each batch runs ``GCNSampleTrainer._train_batch``, whose
dropout masks come from the port's own seeded generator where the
reference folds a JAX key. The feature operand is the margin-padded slab
shared with serving (stream/ingest.py).

Knobs: ``epochs_per_drain``, ``dirty_frac`` (seed bias toward the dirty
region), ``staleness_tol`` / ``NTS_STALENESS_TOL`` (how many sequence
points the served model may lag the graph head before the lag is logged;
the worker keeps the ``stream.head_seq``/``stream.model_seq`` gauges).

Supervision: each round plants the ``finetune_round`` fault point
(``exc@point=finetune_round`` kills one round); the worker retries a
failed round up to ``max_retries`` times (typed ``recovery`` records),
then gives the round up LOUDLY — a fine-tune death degrades freshness,
never serving. Every completed round emits one typed ``finetune_round``
record.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from neutronstarlite_torch.resilience import events
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.sample.sampler import Sampler, dirty_biased_seeds
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("stream")

DEFAULT_STALENESS_TOL = 8


def staleness_tol_from_env() -> int:
    raw = os.environ.get("NTS_STALENESS_TOL", "")
    if raw:
        try:
            return max(int(raw), 0)
        except ValueError:
            log.warning(
                "NTS_STALENESS_TOL=%r is not an int; using %d", raw,
                DEFAULT_STALENESS_TOL,
            )
    return DEFAULT_STALENESS_TOL


class FineTuneWorker:
    """Background trainer draining the ingestor's dirty region.

    ``source`` is anything with ``take_dirty() -> (dirty, lo, hi)`` and
    a ``head_seq`` attribute — in practice the
    :class:`~neutronstarlite_torch.stream.ingest.StreamIngestor`.
    ``publish`` is called with the checkpoint dir after each round's
    save and should return the rollout record's fields (its ``verdict``
    rides the round's record); None skips publication.
    """

    def __init__(
        self,
        toolkit: Any,
        source: Any,
        ckpt_dir: str,
        *,
        publish: Optional[Callable[[str], Dict[str, Any]]] = None,
        epochs_per_drain: int = 1,
        dirty_frac: float = 0.7,
        seeds_per_round: Optional[int] = None,
        staleness_tol: Optional[int] = None,
        max_retries: int = 2,
        interval_s: float = 0.2,
        seed: int = 0,
        metrics=None,
    ):
        self.toolkit = toolkit
        self.source = source
        self.ckpt_dir = ckpt_dir
        self.publish = publish
        self.epochs_per_drain = max(int(epochs_per_drain), 1)
        self.dirty_frac = float(dirty_frac)
        self.seeds_per_round = seeds_per_round
        self.staleness_tol = (staleness_tol_from_env()
                              if staleness_tol is None else int(staleness_tol))
        self.max_retries = max(int(max_retries), 0)
        self.interval_s = float(interval_s)
        self.seed = int(seed)
        self.metrics = metrics if metrics is not None else toolkit.metrics
        self.rounds = 0  # completed rounds
        self.model_seq = 0  # last sequence point the published model saw
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from neutronstarlite_torch.utils.checkpoint import latest_npz_step

        latest = latest_npz_step(ckpt_dir) if os.path.isdir(ckpt_dir) else None
        self._next_step = (latest + 1) if latest is not None else 0

    # ---- one round -------------------------------------------------------

    def staleness(self) -> int:
        """How many sequence points the served model lags the applied
        graph head (the quantity NTS_STALENESS_TOL bounds)."""
        return max(int(self.source.head_seq) - int(self.model_seq), 0)

    def drain_once(self) -> Optional[Dict[str, Any]]:
        """Synchronous single drain: take the accumulated dirty region,
        fine-tune over it, checkpoint, publish. Returns the round
        summary, or None when nothing had changed. A failed round is
        retried up to ``max_retries`` times, then given up loudly."""
        dirty, lo, hi = self.source.take_dirty()
        if hi < lo:
            return None
        rnd = self.rounds
        attempt = 0
        while True:
            try:
                summary = self._round(rnd, dirty, lo, hi)
                break
            except Exception as exc:  # supervised: retry, then give up
                attempt += 1
                if attempt > self.max_retries:
                    events.emit_recovery(
                        "giveup", point="finetune_round", attempt=attempt,
                        epoch=rnd,
                    )
                    log.error(
                        "fine-tune round %d failed %d time(s), giving it "
                        "up: %s — the model stays at seq %d (stale by %d)",
                        rnd, attempt, exc, self.model_seq,
                        hi - self.model_seq,
                    )
                    return None
                events.emit_recovery(
                    "restart", point="finetune_round", attempt=attempt,
                    epoch=rnd,
                )
                log.warning(
                    "fine-tune round %d died (%s); supervised retry "
                    "%d/%d", rnd, exc, attempt, self.max_retries,
                )
        self.rounds += 1
        self.model_seq = hi
        if self.metrics is not None:
            self.metrics.gauge_set("stream.model_seq", self.model_seq)
        lag = self.staleness()
        if lag > self.staleness_tol:
            log.warning(
                "fine-tune worker is %d sequence points behind the graph "
                "head (NTS_STALENESS_TOL=%d) — drains are not keeping up "
                "with the delta rate", lag, self.staleness_tol,
            )
        return summary

    def _round(self, rnd: int, dirty: np.ndarray, lo: int,
               hi: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        # the worker-death chaos plant (exc@point=finetune_round)
        fault_point("finetune_round", epoch=rnd)
        tk = self.toolkit
        train_nids = np.where(tk.datum.mask == 0)[0]
        n = self.seeds_per_round
        if n is None:
            n = min(len(train_nids), max(tk.cfg.batch_size * 4, 1))
        seeds = dirty_biased_seeds(
            train_nids, dirty, int(n), self.dirty_frac, self._rng,
        )
        if len(seeds) == 0:
            raise RuntimeError("fine-tune round has no trainable seeds")
        # same batch_size/fanouts as training -> identical static
        # node_caps, the trainer's own batch step
        sampler = Sampler(
            tk.host_graph, seeds, tk.cfg.batch_size, tk.fanouts,
            seed=self.seed + 7919 * rnd + 1,
        )
        # the dropout stream of this round: apart from training's epochs
        # and from every other round
        round_epoch = self.seed + 104729 + rnd
        loss = None
        batches = 0
        for _ep in range(self.epochs_per_drain):
            for b in sampler.sample_epoch(shuffle=True):
                nodes, hops, seed_mask, seeds_arr = tk._to_device(b)
                out = tk._train_batch(nodes, hops, seed_mask, seeds_arr,
                                      round_epoch, batches)
                loss = out[0] if isinstance(out, tuple) else out
                batches += 1
        loss_f = float(loss) if loss is not None else float("nan")

        step = self._next_step
        tk.save(self.ckpt_dir, step)  # the digest-verified publish path
        self._next_step += 1

        verdict = None
        rollout: Dict[str, Any] = {}
        if self.publish is not None:
            rollout = self.publish(self.ckpt_dir) or {}
            verdict = rollout.get("verdict")
        seconds = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.counter_add("stream.finetune_rounds")
            self.metrics.observe("stream.finetune_round", seconds)
            fields = dict(
                round=rnd, seq_lo=int(lo), seq_hi=int(hi),
                dirty=int(len(dirty)), epochs=self.epochs_per_drain,
                batches=int(batches), loss=loss_f, ckpt_step=int(step),
                verdict=verdict, seconds=float(seconds),
            )
            self.metrics.event("finetune_round", **fields)
        log.info(
            "fine-tune round %d: drained seq %d..%d (%d dirty), %d "
            "batches, loss %.4f, ckpt step %d%s (%.2fs)",
            rnd, lo, hi, len(dirty), batches, loss_f, step,
            f", rollout {verdict}" if verdict else "", seconds,
        )
        return dict(
            round=rnd, seq_lo=lo, seq_hi=hi, dirty=int(len(dirty)),
            batches=batches, loss=loss_f, ckpt_step=step,
            verdict=verdict, rollout=rollout, seconds=seconds,
        )

    # ---- background operation --------------------------------------------

    def start(self) -> None:
        """Run drains on a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("fine-tune worker already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="finetune-worker", daemon=True,
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.drain_once()
            except Exception:
                # drain_once already retries; anything that escapes is a
                # supervisor bug — keep the worker alive, serving wins
                log.exception("fine-tune drain escaped its supervisor")
            self._stop.wait(self.interval_s)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
