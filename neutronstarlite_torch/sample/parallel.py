"""Multi-worker epoch sampling — port of ``neutronstarlite_tpu/sample/parallel.py``.

The epoch's batches are sharded over workers:

- batch i of epoch e is sampled with a Generator seeded by
  ``SeedSequence((seed, e, 0, i))`` (the shuffle by ``(seed, e, 1, 0)``),
  whichever worker or the main process makes it, so the worker count never
  changes a batch and the inline ``workers=0`` path yields the same batches;
- a persistent pool of ``fork``ed workers shares the host graph
  copy-on-write. A child forked after the CUDA context exists can deadlock
  on a lock a vanished thread held, so the trainer builds this sampler
  before the first tensor reaches the card; when CUDA is already
  initialised in the process a fork pool is refused and sampling runs
  inline, with a warning. ``NTS_SAMPLE_CTX=spawn`` starts the workers from
  a fresh interpreter instead, which pickles the graph once per worker;
- when the batches are drawn by the native sampler (``native/``, the
  default), the workers are threads of this process instead of forked
  children: GNU OpenMP's thread pool does not survive a fork (a forked
  child that enters a parallel region after its parent built the graph
  natively waits forever), and the native calls release the GIL, so the
  threads draw at once with no graph copied;
- results stream back through a queue and a reorder buffer, so the batches
  reach the trainer in epoch order.

Workers: ``NTS_SAMPLE_WORKERS`` wins; the default is min(4, cpu_count - 1).
The workers run NumPy and the native runtime only: this module imports no torch.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
from typing import List, Sequence

import numpy as np

from neutronstarlite_torch import native
from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.sample.sampler import SampledBatch, Sampler
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("sample_parallel")


class _WorkerError:
    """Sent across the result queue when a worker's sampling raises."""

    def __init__(self, msg: str):
        self.msg = msg


def _worker_main(state, in_q, out_q):
    """Spawn-context worker entry: rebuild an inline sampler from the
    pickled state and serve the queue."""
    graph, batch_size, fanouts, base_seed = state
    s = ParallelEpochSampler(
        graph, np.zeros(0, np.int64), batch_size, fanouts, seed=base_seed, workers=0,
    )
    _serve(s._make_one, in_q, out_q)


def _serve(make_one, in_q, out_q):
    while True:
        item = in_q.get()
        if item is None:
            return
        epoch, i, seeds = item
        try:
            out_q.put((epoch, i, make_one(seeds, epoch, i)))
        except Exception as e:  # reported to the consumer, which raises
            import traceback

            out_q.put((epoch, i, _WorkerError(f"{e}\n{traceback.format_exc(limit=5)}")))


def cuda_initialized() -> bool:
    """True when this process already holds a CUDA context (checked
    without importing torch)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def default_workers() -> int:
    env = os.environ.get("NTS_SAMPLE_WORKERS")
    if env is not None:
        return max(int(env), 0)
    return max(min(4, (os.cpu_count() or 1) - 1), 0)


def _batch_seed(base_seed: int, epoch: int, idx: int, kind: int = 0) -> np.random.SeedSequence:
    # kind 0 = batch sampling, 1 = the epoch shuffle
    return np.random.SeedSequence([int(base_seed), int(epoch), int(kind), int(idx)])


class ParallelEpochSampler:
    """Epoch-order batch stream with optional multiprocess seed sharding.
    ``sample_epoch(epoch)`` yields SampledBatch in a deterministic order."""

    def __init__(
        self,
        graph: CSCGraph,
        seed_nids: np.ndarray,
        batch_size: int,
        fanouts: Sequence[int],
        seed: int = 0,
        workers: int | None = None,
        ctx_method: str | None = None,
        hop_sampler=None,
    ):
        self.graph = graph
        self.seed_nids = np.asarray(seed_nids, dtype=np.int64)
        self.batch_size = int(batch_size)
        self.fanouts = list(fanouts)
        self.base_seed = int(seed)
        self.workers = default_workers() if workers is None else max(workers, 0)
        # the device hop sampler's tables live on the card: they cannot
        # cross into a worker, so its sampling runs inline
        self.hop_sampler = hop_sampler
        if hop_sampler is not None and self.workers > 0:
            log.info(
                "device hop sampler active: sampling runs inline (%d workers "
                "disabled: device tables cannot cross the process boundary)",
                self.workers,
            )
            self.workers = 0
        self.ctx_method = ctx_method or os.environ.get("NTS_SAMPLE_CTX") or "fork"
        if self.workers > 1 and self.ctx_method == "fork" and hop_sampler is None \
                and native.available():
            self.ctx_method = "thread"
        self._procs: list = []
        self._in_q = self._out_q = None
        if self.workers > 1 and self.ctx_method == "fork" and cuda_initialized():
            log.warning(
                "CUDA is already initialised in this process; disabling %d "
                "sampling workers (a fork after the CUDA context exists can "
                "deadlock a child): sampling runs inline (NTS_SAMPLE_CTX=spawn "
                "keeps workers at a pickling cost)", self.workers,
            )
            self.workers = 0
        if self.workers > 1:
            self._start_pool()

    def _start_pool(self):
        if self.ctx_method == "thread":
            import threading

            self._in_q, self._out_q = queue.Queue(), queue.Queue(maxsize=2 * self.workers)
            self._procs = [threading.Thread(target=_serve, daemon=True,
                                            args=(self._make_one, self._in_q, self._out_q))
                           for _ in range(self.workers)]
            for t in self._procs:
                t.start()
            return
        import multiprocessing as mp

        ctx = mp.get_context(self.ctx_method)
        self._in_q = ctx.Queue()
        self._out_q = ctx.Queue(maxsize=2 * self.workers)
        in_q, out_q = self._in_q, self._out_q
        if self.ctx_method == "fork":
            make_one = self._make_one  # graph shared copy-on-write

            def worker():
                _serve(make_one, in_q, out_q)

            targets = [dict(target=worker) for _ in range(self.workers)]
        else:  # spawn: module-level entry, graph pickled once per worker
            # with only the arrays the sampler reads
            slim = dataclasses.replace(
                self.graph, dst_of_edge=None, edge_weight_forward=None, row_offset=None,
                column_indices=None, src_of_edge=None, edge_weight_backward=None,
            )
            state = (slim, self.batch_size, self.fanouts, self.base_seed)
            targets = [dict(target=_worker_main, args=(state, in_q, out_q))
                       for _ in range(self.workers)]
        self._procs = [ctx.Process(daemon=True, **t) for t in targets]
        for p in self._procs:
            p.start()

    def close(self):
        """Stop the pool (idempotent; daemon workers also die with the
        parent)."""
        if self._in_q is not None:
            for _ in self._procs:
                self._in_q.put(None)
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive() and hasattr(p, "terminate"):  # a thread ends by itself
                    p.terminate()
            self._procs = []
            self._in_q = self._out_q = None
            self.workers = 0

    def _epoch_batches(self, epoch: int, shuffle: bool) -> List[np.ndarray]:
        nids = self.seed_nids.copy()
        if shuffle:
            np.random.default_rng(_batch_seed(self.base_seed, epoch, 0, kind=1)).shuffle(nids)
        return [nids[lo: lo + self.batch_size] for lo in range(0, len(nids), self.batch_size)]

    def _make_one(self, seeds: np.ndarray, epoch: int, idx: int) -> SampledBatch:
        ss = _batch_seed(self.base_seed, epoch, idx)
        s = Sampler(
            self.graph, seeds, self.batch_size, self.fanouts,
            seed=int(ss.generate_state(1)[0]), hop_sampler=self.hop_sampler,
        )
        return s._make_batch(seeds)

    def sample_epoch(self, epoch: int = 0, shuffle: bool = True):
        batches = self._epoch_batches(epoch, shuffle)
        if self._in_q is None or len(batches) <= 1:
            for i, seeds in enumerate(batches):
                yield self._make_one(seeds, epoch, i)
            return
        yield from self._sample_epoch_mp(batches, epoch)

    def _sample_epoch_mp(self, batches: List[np.ndarray], epoch: int):
        n = len(batches)
        for i, seeds in enumerate(batches):
            self._in_q.put((epoch, i, seeds))
        buf = {}
        nxt = 0
        while nxt < n:
            while nxt not in buf:
                try:
                    e, i, b = self._out_q.get(timeout=60.0)
                except queue.Empty:
                    dead = [getattr(p, "pid", p.name) for p in self._procs
                            if not p.is_alive()]
                    raise RuntimeError(
                        f"sampling workers stalled (dead pids: {dead}); epoch {epoch} "
                        f"batch {nxt} never arrived"
                    ) from None
                if isinstance(b, _WorkerError):
                    raise RuntimeError(f"sampling worker failed: {b.msg}")
                if e != epoch:
                    continue  # stale result of an abandoned earlier epoch
                buf[i] = b
            yield buf.pop(nxt)
            nxt += 1
