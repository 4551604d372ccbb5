"""Sampling pipeline: a bounded prefetch queue and an overlapped host-to-device
copy — port of ``neutronstarlite_tpu/sample/pipeline.py``.

One producer thread walks the scheduled epochs through the deterministic
batch source (``sample/parallel.ParallelEpochSampler``: batch i of epoch e
is a function of (seed, e, i)), so the pipeline changes when a batch is
made, never what is made: pipelined training equals synchronous training
bitwise wherever the step is repeatable.

- Each batch is staged by ``batch_to_device``: its arrays go into pinned
  host memory and are copied with ``non_blocking=True`` on a side CUDA
  stream, so the copy of batch i+1 overlaps the step of batch i. The
  consumer makes its stream wait on the copy's event before it touches the
  batch (``StagedBatch.ready``). On the CPU the arrays are wrapped as
  tensors and no copy is made.
- The queue is bounded (``NTS_SAMPLE_PREFETCH``, default 3): a slow
  consumer holds the producer back.
- The producer runs ahead across epoch boundaries.
- A producer failure (a sampling error, a failed copy, the
  ``sample_produce`` fault point) reaches the consumer as
  :class:`SampleWorkerError`, a ``HealthError``, so a supervised run rolls
  back and retries; a silent producer fails the consumer after
  ``stall_timeout_s``.
- ``close()`` drains and joins: no thread outlives its epoch loop.

``SAMPLE_PIPELINE`` (cfg) or ``NTS_SAMPLE_PIPELINE`` (env, wins when set
and not empty) selects the mode (``resolve_sample_pipeline``): ``sync``
(the default), ``pipelined`` (this module over the host sampler),
``device`` (this module over the device hop sampler) or ``fused``
(``sample/fused.py``).

Telemetry, with a metrics registry and a tracer (the trainer's), as in the
reference: the producer's ``sample_produce`` and ``h2d_copy`` spans, the
consumer's ``sample_wait`` spans; the ``sample.produced``,
``sample.h2d_bytes``, ``sample.h2d_ms`` and ``sample.stall_ms`` counters;
the ``sample.queue_depth`` histogram and peak gauge.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Iterable, List, Optional

import numpy as np
import torch

from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.resilience.guards import HealthError
from neutronstarlite_torch.sample.sampler import SampledBatch
from neutronstarlite_torch.utils.config import SAMPLE_PIPELINE_MODES
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("sample_pipeline")


class SampleWorkerError(HealthError):
    """The pipeline's producer died; a supervised run treats it like any
    other health fault (rollback to the last good checkpoint, retry)."""

    code = "sample_worker"


def resolve_sample_pipeline(cfg: Any = None) -> str:
    """The active sampling mode: ``NTS_SAMPLE_PIPELINE`` (set and not
    empty), then the cfg's ``SAMPLE_PIPELINE``, then ``sync``."""
    raw = os.environ.get("NTS_SAMPLE_PIPELINE", "")
    if not raw.strip():
        raw = getattr(cfg, "sample_pipeline", "") if cfg is not None else ""
    v = (raw or "").strip().lower()
    if v in ("", "sync", "off", "0"):
        return "sync"
    if v in ("pipelined", "on", "1"):
        return "pipelined"
    if v in SAMPLE_PIPELINE_MODES:
        return v
    if v == "auto":
        raise ValueError(
            "SAMPLE_PIPELINE:auto lets the autotuner choose the sampling mode; "
            "the torch port does not implement the autotuner yet: set sync, "
            "pipelined, device or fused"
        )
    raise ValueError(
        f"SAMPLE_PIPELINE/NTS_SAMPLE_PIPELINE must be sync, pipelined, device or "
        f"fused, got {raw!r}"
    )


def default_depth() -> int:
    """Prefetch depth (``NTS_SAMPLE_PREFETCH``, >= 1, default 3)."""
    raw = os.environ.get("NTS_SAMPLE_PREFETCH", "")
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            log.warning("NTS_SAMPLE_PREFETCH=%r is not an int; using 3", raw)
    return 3


def batch_arrays(b: SampledBatch) -> List[np.ndarray]:
    """A batch's arrays in payload order: nodes per layer, then (src_local,
    dst_local, weight) per hop, then seed_mask and seeds."""
    arrs = list(b.nodes)
    for h in b.hops:
        arrs += [h.src_local, h.dst_local, h.weight]
    return arrs + [b.seed_mask, b.seeds]


def payload_nbytes(b: SampledBatch) -> int:
    """Host bytes of one padded batch's payload: measured here, priced by
    ``sample_batch_payload_bytes`` (the two agree, capacities being
    static)."""
    return int(sum(np.asarray(a).nbytes for a in batch_arrays(b)))


def sample_batch_payload_bytes(node_caps, fanouts) -> int:
    """Bytes of one padded batch payload (the JAX package's
    ``tools/wire_accounting`` formula): int64 node ids per layer; per hop
    ``node_caps[h+1] * fanouts[h]`` edges of int64 src_local, int64
    dst_local and f32 weight; int64 seeds and f32 seed_mask."""
    caps = [int(c) for c in node_caps]
    fo = [int(f) for f in fanouts]
    if len(caps) != len(fo) + 1:
        raise ValueError(
            f"node_caps must be one longer than fanouts, got {len(caps)} caps / "
            f"{len(fo)} fanouts"
        )
    nodes = sum(caps) * 8
    hops = sum(caps[h + 1] * fo[h] * (8 + 8 + 4) for h in range(len(fo)))
    return nodes + hops + caps[-1] * (8 + 4)


def unpack(tensors, n_layers: int):
    """Payload order -> (nodes, hops, seed_mask, seeds)."""
    nodes = list(tensors[:n_layers + 1])
    rest = tensors[n_layers + 1:]
    hops = [tuple(rest[3 * h: 3 * h + 3]) for h in range(n_layers)]
    return nodes, hops, rest[-2], rest[-1]


class StagedBatch:
    """A batch on its way to the device. ``ready()`` returns its tensors in
    payload order, once the consumer's stream has waited for the copy."""

    def __init__(self, tensors, event=None, host=None):
        self._tensors = tensors
        self._event = event
        self._host = host  # the pinned sources, alive until the copy is done

    def ready(self):
        if self._event is not None:
            stream = torch.cuda.current_stream(self._tensors[0].device)
            stream.wait_event(self._event)
            for t in self._tensors:
                # allocated on the copy stream, used and freed on this one
                t.record_stream(stream)
            self._event = self._host = None
        return self._tensors


def batch_to_device(b: SampledBatch, device: torch.device, stream=None) -> StagedBatch:
    """Stage one batch on ``device``: on a CUDA device, copies from pinned
    memory on ``stream`` (a side stream) with an event recorded after them;
    on the CPU, the arrays as tensors."""
    arrs = batch_arrays(b)
    if device.type != "cuda":
        return StagedBatch([torch.from_numpy(np.asarray(a)) for a in arrs])
    host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrs]
    with torch.cuda.stream(stream):
        dev = [h.to(device, non_blocking=True) for h in host]
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(dev, event, host)


class _EpochDone:
    __slots__ = ("epoch",)

    def __init__(self, epoch: int):
        self.epoch = epoch


class _WorkerFailed:
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg


class SamplePipeline:
    """Bounded prefetch queue between a deterministic batch source and the
    step loop. ``source.sample_epoch(epoch)`` yields SampledBatch in order;
    ``epochs`` is the schedule, which the consumer must follow with
    :meth:`epoch_stream`. ``transfer`` maps a batch to what the consumer
    receives (default: ``batch_to_device`` on ``device``)."""

    def __init__(
        self,
        source: Any,
        epochs: Iterable[int],
        device=None,
        depth: Optional[int] = None,
        transfer=None,
        stall_timeout_s: float = 120.0,
        metrics: Any = None,
        tracer: Any = None,
    ):
        self.source = source
        self.metrics = metrics
        self.tracer = tracer
        self.epochs = list(epochs)
        self.depth = default_depth() if depth is None else max(int(depth), 1)
        if transfer is None:
            dev = torch.device(device if device is not None else "cpu")
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

            def transfer(b):
                return batch_to_device(b, dev, stream)

        self.transfer = transfer
        self.stall_timeout_s = float(stall_timeout_s)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self.peak_depth = 0
        self.produced = 0
        self.stall_s = 0.0  # consumer time blocked on the queue, all epochs
        self.last_epoch_stall_s = 0.0
        self._thread = threading.Thread(target=self._produce, name="sample-pipeline",
                                        daemon=True)
        self._thread.start()

    # ---- producer thread -------------------------------------------------
    def _span(self, name: str, dur_s: float, t0: float, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.complete(name, dur_s=dur_s, t0=t0, cat="sample", **attrs)

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close(); False = stopping."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for epoch in self.epochs:
                it = iter(self.source.sample_epoch(epoch))
                idx = 0
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    # chaos hook: exc/stall/crash specs with point=sample_produce
                    fault_point("sample_produce", epoch=epoch)
                    t1 = time.perf_counter()
                    payload = self.transfer(b)
                    t2 = time.perf_counter()
                    self._span("sample_produce", t1 - t0, t0, epoch=int(epoch), index=idx)
                    self._span("h2d_copy", t2 - t1, t1, epoch=int(epoch), index=idx)
                    if not self._put((epoch, idx, payload)):
                        return
                    self.produced += 1
                    depth = self._q.qsize()
                    m = self.metrics
                    if m is not None:
                        m.counter_add("sample.produced")
                        m.counter_add("sample.h2d_ms", (t2 - t1) * 1000.0)
                        if isinstance(b, SampledBatch):
                            m.counter_add("sample.h2d_bytes", payload_nbytes(b))
                        m.hist_observe("sample.queue_depth", depth, unit="")
                        if depth > self.peak_depth:
                            m.gauge_set("sample.queue_depth", depth)
                    self.peak_depth = max(self.peak_depth, depth)
                    idx += 1
                if self._stop.is_set() or not self._put(_EpochDone(epoch)):
                    return
        except BaseException as e:  # reported to the consumer, never a hang
            import traceback

            msg = f"{type(e).__name__}: {e}\n" + traceback.format_exc(limit=6)
            log.warning("sampling pipeline worker failed: %s", e)
            if not self._put(_WorkerFailed(msg)):
                try:
                    self._q.put_nowait(_WorkerFailed(msg))
                except queue.Full:
                    pass

    # ---- consumer side ---------------------------------------------------
    def _get(self):
        waited = 0.0
        while True:
            try:
                return self._q.get(timeout=0.25)
            except queue.Empty:
                waited += 0.25
                if not self._thread.is_alive():
                    raise SampleWorkerError(
                        "sampling pipeline worker died without delivering its epoch"
                    ) from None
                if waited >= self.stall_timeout_s:
                    raise SampleWorkerError(
                        f"sampling pipeline stalled for {self.stall_timeout_s:g}s "
                        "with a live worker"
                    ) from None

    def epoch_stream(self, epoch: int):
        """Yield this epoch's payloads in order; epochs must be consumed in
        the scheduled order."""
        self.last_epoch_stall_s = 0.0
        while True:
            t0 = time.perf_counter()
            item = self._get()
            wait = time.perf_counter() - t0
            self.stall_s += wait
            self.last_epoch_stall_s += wait
            if self.metrics is not None:
                self.metrics.counter_add("sample.stall_ms", wait * 1000.0)
                self.metrics.hist_observe("sample.stall_ms", wait * 1000.0)
            self._span("sample_wait", wait, t0, epoch=int(epoch))
            if isinstance(item, _WorkerFailed):
                raise SampleWorkerError(f"sampling pipeline worker failed: {item.msg}")
            if isinstance(item, _EpochDone):
                if item.epoch != epoch:
                    raise SampleWorkerError(
                        f"sampling pipeline out of order: consumer asked for epoch "
                        f"{epoch}, producer finished {item.epoch}"
                    )
                return
            e, idx, payload = item
            if e != epoch:
                raise SampleWorkerError(
                    f"sampling pipeline out of order: got batch {idx} of epoch {e} "
                    f"while consuming epoch {epoch}"
                )
            yield payload

    def close(self) -> None:
        """Drain and join the producer (idempotent, safe mid-epoch)."""
        self._stop.set()
        deadline = time.perf_counter() + 5.0
        while self._thread.is_alive() and time.perf_counter() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        if self._thread.is_alive():
            log.warning("sampling pipeline worker did not exit within 5s of close()")
