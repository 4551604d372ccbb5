"""Inference engine: a restored checkpoint -> one executable per shape bucket
— port of ``neutronstarlite_tpu/serve/engine.py``.

1. **Checkpoint load.** The model is rebuilt through the trainer's own
   lifecycle (``get_algorithm`` -> ``init_graph``/``init_nn``) and the
   weights restored through ``utils/checkpoint.py``: the digest-verified,
   quarantine-on-corruption restore that training resume uses. Either
   package's npz checkpoints restore.

2. **Eval-mode forward.** A bucket runs ``models/gcn_sample.batch_forward``
   with no dropout masks: the feature gather, then per hop
   ``minibatch_gather`` and a matmul (ReLU between layers), in the
   trainer's compute dtype (``PRECISION``), logits returned in f32. Served
   logits are therefore the trainer's own eval forward on the same batch.

3. **Shape buckets.** Request batches vary in size, so a small ladder of
   batch-size buckets (``ServeOptions.ladder``) is built ahead of traffic;
   a flush pads to the smallest covering bucket. JAX compiles each bucket
   once with ``jax.jit(...).lower(...).compile()``; on CUDA each bucket is
   one ``torch.cuda.CUDAGraph``, captured once over static input buffers
   shaped by ``ServeSampler.node_caps(bucket)`` (after one warm-up run on a
   side stream), with its own memory pool; on the CPU it is the eager
   forward. ``compile_counts`` proves the discipline either way: exactly
   one build per bucket, ever, clones included.

``SAMPLE_PIPELINE:fused`` builds a second ladder: each bucket captures
``sample/fused.fused_sample_subgraph`` plus the eval forward as one graph,
and a flush writes only the padded seeds, the live count and the draw key
into its static buffer before the one replay; no subgraph exists on the
host. The port's draw is a 32-bit counter hash, not ``jax.random``: fused
(and device-mode) served logits equal the port's eager forward on the same
draw, not JAX's.

Concurrency. A JAX executable is reentrant; a captured graph's static
buffers are not, and ``clone()`` shares the ladder between the replicas of
a fleet, which call it from several threads. Nor are two different graphs
independent: every capture runs on PyTorch's one capture stream, and
PyTorch keys the cuBLAS workspace by handle and stream, so the graphs
captured in one thread share one workspace, and two of them replayed at
once race in it (measured on the H100: a sync and a device bucket replayed
together answered up to 3.4e-6 off their lone replays). So every replay on
the card holds one process-wide lock around copy-in, replay and copy-out
(the logits reach the host before it is released); on the CPU each
bucket's eager forward holds its own lock. A bucket is built under the
engine's compile lock, with ``capture_error_mode="thread_local"``, and
``warmup()`` builds every bucket before a server starts its threads.

The host-to-device stage: ``prepare_batch`` packs a flush's arrays into
one pinned host buffer and copies it with one ``non_blocking`` copy on the
engine's side stream, recording an event; ``execute_prepared`` makes its
stream wait on that event, then copies into the graph's static buffer. The
pipelined server stages flush i+1 while flush i replays.

Live graph (``apply_delta``, serve/delta.py). A captured graph reads its
tensors by address, so a delta writes in place wherever the shapes allow:
the neighbour table's dirty rows, the fused degree tables (sized to the
table's row capacity) and, within a reserved margin (stream/ingest.py),
the appended feature rows; no bucket is captured again. A vertex append
past the margin makes a new feature slab and clears both ladders, and a
neighbour table that must change shape recaptures the fused buckets (their
ladder is keyed on the tables' shapes and addresses). The engine serves
its own copy of the restored weights: a fine-tune worker that trains the
toolkit's parameters in place (stream/finetune.py) never reaches a
serving bucket.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neutronstarlite_torch.models.gcn_sample import batch_forward
from neutronstarlite_torch.sample.sampler import SampledBatch
from neutronstarlite_torch.serve.batcher import ServeOptions
from neutronstarlite_torch.serve.sampling import ServeSampler
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")

_ALIGN = 16  # byte alignment of each array in a packed buffer
# held by every CUDA-graph replay in the process (see "Concurrency" above)
_REPLAY_LOCK = threading.Lock()


class ServeSetupError(RuntimeError):
    """Unservable configuration (no checkpoint, unsupported model, ...)."""


def batch_device_arrays(batch: SampledBatch) -> List[np.ndarray]:
    """A SampledBatch's forward operands in packing order: the node ids per
    layer (int64), then per hop src_local, dst_local (int64) and weight
    (float32). The seed mask and ids are not operands of the eval forward
    (the seeds are ``nodes[-1]``)."""
    arrs = [np.asarray(n) for n in batch.nodes]
    for h in batch.hops:
        arrs += [h.src_local, h.dst_local, h.weight]
    return arrs


def unflatten(tensors: Sequence[torch.Tensor], n_layers: int):
    """Packing order -> (nodes, hops) as ``batch_forward`` takes them."""
    nodes = list(tensors[:n_layers + 1])
    rest = tensors[n_layers + 1:]
    return nodes, [tuple(rest[3 * h: 3 * h + 3]) for h in range(n_layers)]


class Packing:
    """Byte layout of a list of 1-D arrays in one uint8 buffer, each array
    at a 16-byte aligned offset: the one buffer a flush's operands travel
    in (one host-to-device copy) and the bucket's static input buffer."""

    def __init__(self, specs: Sequence[Tuple[int, np.dtype]]):
        self.segments: List[Tuple[int, int, np.dtype]] = []
        off = 0
        for numel, dtype in specs:
            dtype = np.dtype(dtype)
            self.segments.append((off, int(numel), dtype))
            off += -(-int(numel) * dtype.itemsize // _ALIGN) * _ALIGN
        self.nbytes = max(off, _ALIGN)

    @classmethod
    def of(cls, arrays: Sequence[np.ndarray]) -> "Packing":
        return cls([(np.asarray(a).size, np.asarray(a).dtype) for a in arrays])

    def pack(self, arrays: Sequence[np.ndarray], pin: bool) -> torch.Tensor:
        """A host uint8 buffer (pinned when ``pin``) holding ``arrays``."""
        buf = torch.zeros(self.nbytes, dtype=torch.uint8, pin_memory=pin)
        view = buf.numpy()
        for (off, numel, dtype), a in zip(self.segments, arrays):
            a = np.ascontiguousarray(a, dtype=dtype).reshape(-1)
            if a.size != numel:
                raise ValueError(f"array of {a.size} elements packed into a slot of {numel}")
            view[off: off + numel * dtype.itemsize] = a.view(np.uint8)
        return buf

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Typed views of ``buf``'s segments (on ``buf``'s device)."""
        out = []
        for off, numel, dtype in self.segments:
            seg = buf[off: off + numel * dtype.itemsize]
            out.append(seg.view(getattr(torch, dtype.name)))
        return out


class Staged:
    """A flush's operands on their way to the device: the packed buffer
    (on the device once the copy is done), the copy's event (None on the
    CPU) and the pinned source, kept alive until the copy has run."""

    __slots__ = ("buf", "event", "host")

    def __init__(self, buf: torch.Tensor, event=None, host=None):
        self.buf = buf
        self.event = event
        self.host = host


class _Bucket:
    """One bucket's executable. CUDA: the captured graph, its static input
    buffer and output; the CPU: ``run(buf)``, the eager forward over a
    packed buffer. ``packing``: the layout of a sync bucket's buffer (None
    for a fused bucket). ``lock`` guards the static buffers across
    threads; on the card it is the process-wide replay lock."""

    def __init__(self, run, packing: Optional[Packing] = None, graph=None, static=None,
                 out=None):
        self.run = run
        self.packing = packing
        self.graph = graph
        self.static = static
        self.out = out
        self.lock = threading.Lock() if graph is None else _REPLAY_LOCK

    def __call__(self, staged: Staged, stream) -> np.ndarray:
        """Logits [bucket, classes] as a host array."""
        if self.graph is None:
            with self.lock:
                return self.run(staged.buf).numpy()
        with self.lock, torch.cuda.stream(stream):
            if staged.event is not None:
                stream.wait_event(staged.event)
                staged.buf.record_stream(stream)
            self.static.copy_(staged.buf)
            self.graph.replay()
            return self.out.cpu().numpy()


def eval_run(weights, feature: torch.Tensor, compute_dtype, caps, n_layers: int,
             packing: Packing):
    """``run(buf)`` of a sync bucket: the eval forward over the views of a
    packed buffer. It holds the tensors it reads, not the engine: a ladder
    that referred back to its engine would keep dead engines (and their
    graphs) alive until the cyclic garbage collector ran."""

    def run(buf: torch.Tensor) -> torch.Tensor:
        nodes, hops = unflatten(packing.views(buf), n_layers)
        with torch.no_grad():
            return batch_forward(weights, feature, nodes, hops, caps, compute_dtype)

    return run


def fused_run(weights, feature: torch.Tensor, compute_dtype, caps, fanouts, tables,
              bucket: int):
    """``run(buf)`` of a fused bucket: ``buf`` is int64 [bucket + 2], the
    padded seeds, the live count and the draw key; the draw, remap, gather
    and forward all run on ``buf``'s device."""
    from neutronstarlite_torch.sample.fused import fused_sample_subgraph

    def run(buf: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            nodes, hops = fused_sample_subgraph(
                *tables, buf[:bucket], buf[bucket], buf[bucket + 1], caps, fanouts,
            )
            return batch_forward(weights, feature, nodes, hops, caps, compute_dtype)

    return run


def capture(fn, device: torch.device):
    """(graph, output) of ``fn()`` captured as a CUDA graph after one
    warm-up call on a side stream (lazy set-up of the libraries it calls),
    in a memory pool of its own. Python's cyclic garbage collector is run
    before and held off during the capture: a collection inside it that
    freed a dead graph would invalidate the capture."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.no_grad():
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
        side.synchronize()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn()
        finally:
            if was_enabled:
                gc.enable()
    return graph, out


class InferenceEngine:
    """Checkpoint-backed scorer with a ladder of bucket executables."""

    def __init__(
        self,
        toolkit: Any,
        ckpt_dir: str,
        options: Optional[ServeOptions] = None,
        metrics: Any = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.toolkit = toolkit
        self.cfg = toolkit.cfg
        self.opts = options or ServeOptions.from_cfg(self.cfg)
        self.metrics = metrics if metrics is not None else toolkit.metrics
        # structural check FIRST: an unservable parameter family must fail
        # with this message, not an opaque shape mismatch inside restore
        self._check_servable(toolkit.params)
        self._restore(ckpt_dir)
        self.device = toolkit.device
        # a copy: the toolkit's parameters may go on training in place
        self.weights = [layer["W"].detach().clone() for layer in toolkit.params]
        self.feature = toolkit.feature
        self.fanouts = list(toolkit.fanouts)
        self.compute_dtype = toolkit.compute_dtype
        hop_sampler = None
        if self.opts.sample_pipeline in ("device", "fused"):
            # the sampled trainer this engine restored through already built
            # the neighbour table for the same mode: reuse it
            hop_sampler = toolkit.par_sampler.hop_sampler
        # the fused program's degree tables, shared with every clone
        # (``graph``: the host graph they hold; None until first use)
        self._fused_shared: Dict[str, Any] = {"graph": None, "degrees": None}
        self.sampler = ServeSampler(
            toolkit.host_graph, self.fanouts, self.opts.ladder(), rng=rng,
            hop_sampler=hop_sampler,
        )
        self.buckets = self.sampler.buckets
        # the two ladders (bucket -> _Bucket; fused: bucket -> (table
        # shapes, _Bucket)), the build counts and the compile lock are shared
        # with every clone: two replicas racing a cold bucket build it once
        self._compiled: Dict[int, _Bucket] = {}
        self._fused_compiled: Dict[int, Tuple[tuple, _Bucket]] = {}
        self.compile_counts: Dict[int, int] = {}
        self._compile_lock = threading.Lock()
        self._init_streams()

    def _init_streams(self) -> None:
        """This engine's side stream (host-to-device copies) and replay
        stream; None on the CPU."""
        cuda = self.device.type == "cuda"
        self._h2d_stream = torch.cuda.Stream(self.device) if cuda else None
        self._exec_stream = torch.cuda.Stream(self.device) if cuda else None

    def clone(self, metrics: Any = None,
              rng: Optional[np.random.Generator] = None) -> "InferenceEngine":
        """A warm replica engine over the SAME toolkit/params/graph: it
        shares the restored parameters, the feature slab, the device hop
        sampler's table and the bucket ladder (``_compiled``,
        ``compile_counts``: the same dicts), so a new replica serves its
        first request with ZERO builds. Its ServeSampler and streams are its
        own: numpy Generators are not thread-safe."""
        new = object.__new__(InferenceEngine)
        new.__dict__.update(self.__dict__)
        if metrics is not None:
            new.metrics = metrics
        new.sampler = ServeSampler(
            self.sampler.graph, self.fanouts, self.opts.ladder(), rng=rng,
            hop_sampler=self.sampler.hop_sampler,
        )
        new.buckets = new.sampler.buckets
        new._init_streams()
        return new

    @property
    def fused(self) -> bool:
        """SAMPLE_PIPELINE:fused — serve cache misses through the fused
        sample+execute ladder instead of host sample + bucket forward."""
        return self.opts.sample_pipeline == "fused"

    def graph_digest(self) -> str:
        """The canonical digest of the graph this engine serves: the
        tune-cache and perf-ledger key that a graph delta bumps
        (serve/delta.py updates the toolkit's cached copy)."""
        digest = getattr(self.toolkit, "_tune_graph_digest", None)
        if digest is None:
            from neutronstarlite_torch.graph.digest import graph_digest

            digest = graph_digest(self.sampler.graph)
            self.toolkit._tune_graph_digest = digest
        return digest

    def apply_delta(self, delta) -> Any:
        """Engine-level delta application (no cache or batcher state: the
        server and fleet paths add those; serve/delta.py has the
        semantics). Returns the DeltaPlan."""
        from neutronstarlite_torch.serve import delta as delta_mod

        return delta_mod.apply_to_engines([self], delta)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_config(
        cls,
        cfg: InputInfo,
        base_dir: Optional[str] = None,
        ckpt_dir: str = "",
        options: Optional[ServeOptions] = None,
        rng: Optional[np.random.Generator] = None,
        device=None,
    ) -> "InferenceEngine":
        """Full lifecycle from a cfg file's contents: load graph + datum,
        build the model, restore the checkpoint. ``device`` None is the CUDA
        card (raises without one); ``"cpu"`` runs on the CPU."""
        from neutronstarlite_torch.models import get_algorithm

        ckpt = ckpt_dir or cfg.checkpoint_dir
        if not ckpt:
            raise ServeSetupError(
                "no checkpoint directory: pass one explicitly or set "
                "CHECKPOINT_DIR in the cfg"
            )
        # serving never consumes the training batch stream: no worker pool
        prev = os.environ.get("NTS_SAMPLE_WORKERS")
        os.environ["NTS_SAMPLE_WORKERS"] = "0"
        try:
            toolkit = get_algorithm(cfg.algorithm)(cfg, base_dir=base_dir, device=device)
            toolkit.init_graph()
            toolkit.init_nn()
        finally:
            if prev is None:
                os.environ.pop("NTS_SAMPLE_WORKERS", None)
            else:
                os.environ["NTS_SAMPLE_WORKERS"] = prev
        return cls(toolkit, ckpt, options=options, rng=rng)

    def _restore(self, ckpt_dir: str) -> None:
        from neutronstarlite_torch.utils.checkpoint import have_checkpoint

        if not ckpt_dir or not have_checkpoint(ckpt_dir):
            raise ServeSetupError(
                f"no checkpoint under {ckpt_dir!r} — train first "
                "(CHECKPOINT_DIR + a run), or point serving at an "
                "existing one"
            )
        step = self.toolkit.restore(ckpt_dir)  # digest-verified restore
        if step == 0 and not have_checkpoint(ckpt_dir):
            # every retained step failed verification and was quarantined
            raise ServeSetupError(
                f"every checkpoint under {ckpt_dir!r} failed integrity "
                "verification (quarantined *.corrupt)"
            )
        self.ckpt_step = step
        log.info("serving checkpoint step %d from %s", step, ckpt_dir)

    # the one parameter family the bucket forward can rebuild today
    SERVABLE_FAMILIES = (
        "sampled-GCN (params = [{'W': ...}, ...]; ALGORITHM:GCNSAMPLESINGLE)",
    )

    @staticmethod
    def _param_family(p) -> str:
        """Best-effort name for a parameter tree's model family, so the
        refusal names what the checkpoint IS, not just what it isn't."""
        if not isinstance(p, (list, tuple)) or not p:
            return f"non-layer-list params ({type(p).__name__})"
        keys = set()
        for layer in p:
            if not isinstance(layer, dict):
                return f"layer list with non-dict entries ({type(layer).__name__})"
            keys |= set(layer)
        if "a" in keys:
            return "GAT family (attention vector 'a' present)"
        if "Ws" in keys or "Wd" in keys:
            return "GGCN family (gated edge-NN weights Ws/Wd)"
        if "W1" in keys or "W2" in keys:
            return "GIN family (two-layer MLP W1/W2)"
        if "C" in keys or "H" in keys:
            return "CommNet family (C/H projections)"
        if "bn" in keys:
            return "full-batch GCN family (batch-norm stats present)"
        return f"unrecognized family (layer keys: {sorted(keys)})"

    def _check_servable(self, p) -> None:
        """The engine serves the sampled-GCN parameter family: a list of
        layers each holding exactly one dense ``W``. Anything else would
        silently skip math — refuse, naming the DETECTED family and the
        supported list."""
        ok = isinstance(p, (list, tuple)) and len(p) > 0 and all(
            isinstance(layer, dict) and set(layer) == {"W"} for layer in p
        )
        if not ok:
            supported = "; ".join(self.SERVABLE_FAMILIES)
            raise ServeSetupError(
                f"ALGORITHM {self.cfg.algorithm!r} checkpoints are not "
                f"servable: detected {self._param_family(p)}; the engine "
                f"supports: {supported}"
            )

    # ---- bucket executables ----------------------------------------------
    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Build the executable ladder ahead of traffic (the ladder the
        configured pipeline actually serves through)."""
        for b in buckets if buckets is not None else self.buckets:
            if self.fused:
                self._ensure_fused(int(b))
            else:
                self._ensure_compiled(int(b))

    def _ensure_compiled(self, bucket: int) -> _Bucket:
        entry = self._compiled.get(bucket)
        if entry is not None:
            return entry
        with self._compile_lock:
            entry = self._compiled.get(bucket)  # a racing clone got here first
            if entry is None:
                entry = self._build_bucket(bucket)
            return entry

    def _build_bucket(self, bucket: int) -> _Bucket:
        caps = self.sampler.node_caps(bucket)
        n_layers = len(self.fanouts)
        # one host-side sample supplies the shapes (capacities are static
        # per bucket, so any seed set works). The draw is RNG-NEUTRAL (state
        # saved and restored): a warm engine (cloned ladder, zero builds)
        # and a cold one then consume the same stream, and one seed replays
        # the same serving trace on both
        rng_state = self.sampler.rng.bit_generator.state
        try:
            rep = self.sampler.sample(bucket, np.zeros(1, np.int64))
        finally:
            self.sampler.rng.bit_generator.state = rng_state
        arrays = batch_device_arrays(rep)
        packing = Packing.of(arrays)
        run = eval_run(self.weights, self.feature, self.compute_dtype, caps, n_layers, packing)
        t0 = time.perf_counter()
        static = packing.pack(arrays, pin=False).to(self.device)
        if self.device.type == "cuda":
            graph, out = capture(lambda: run(static), self.device)
            entry = _Bucket(run, packing, graph=graph, static=static, out=out)
        else:
            entry = _Bucket(run, packing)
        dt = time.perf_counter() - t0
        self._compiled[bucket] = entry
        self._built(f"serve.bucket_{bucket}", bucket, dt, lambda: run(static))
        log.info("%s bucket %d (caps %s) in %.3fs", self._built_how(), bucket, caps, dt)
        return entry

    def _built_how(self) -> str:
        return ("captured as a CUDA graph" if self.device.type == "cuda"
                else "built (eager on the CPU)")

    def _built(self, label: str, bucket: int, dt: float, forward) -> None:
        """Count one build; with a metrics registry, its counters and the
        bucket's ``program_cost`` record, counted over one eager forward."""
        self.compile_counts[bucket] = self.compile_counts.get(bucket, 0) + 1
        if self.metrics is None:
            return
        self.metrics.counter_add(f"serve.compiles.bucket_{bucket}")
        self.metrics.observe("serve.compile", dt)
        from neutronstarlite_torch.obs import cost

        if not cost.cost_enabled(self.metrics):
            return
        with cost.count_step(self.device) as count:
            forward()
        g = self.sampler.graph
        cost.capture_program_cost(self.metrics, label, count, g.e_num, g.v_num,
                                  self.device.type, bucket=bucket, compile_s=round(dt, 4))

    # ---- fused one-replay ladder (SAMPLE_PIPELINE:fused) -------------------
    def _fused_tables(self):
        """The fused program's device tables (nbr, eff_deg, out_deg,
        in_deg), read at call time: a delta patches them in place or, when
        a shape must change, replaces them (serve/delta.py). The degree
        tables are sized to the neighbour table's row capacity."""
        hs = self.sampler.hop_sampler
        shared = self._fused_shared
        deg = shared["degrees"]
        if deg is None or deg[0].shape[0] != hs.nbr.shape[0]:
            from neutronstarlite_torch.sample.fused import degree_tables

            shared["degrees"] = degree_tables(self.sampler.graph, self.device,
                                              rows=hs.nbr.shape[0])
            shared["graph"] = self.sampler.graph
        return (hs.nbr, hs.eff_deg) + tuple(shared["degrees"])

    def refresh_fused_degrees(self) -> None:
        """Rewrite the fused degree tables for the graph this engine now
        serves, in place where their size holds (serve/delta.py calls it
        once per shared table set, while no flush is in flight)."""
        shared = self._fused_shared
        deg, g = shared["degrees"], self.sampler.graph
        if deg is None or shared["graph"] is g:
            return
        if deg[0].shape[0] >= g.v_num:
            from neutronstarlite_torch.sample.fused import degree_tables

            # in place: the captured graphs read these tensors
            for old, new in zip(deg, degree_tables(g, self.device, rows=deg[0].shape[0])):
                old.copy_(new)
            shared["graph"] = g
        else:
            shared["degrees"] = None  # rebuilt at the next call

    def _ensure_fused(self, bucket: int) -> _Bucket:
        tables = self._fused_tables()
        # a captured graph reads its tables by address: a replaced table
        # (a shape change) needs a new capture
        key = tuple((tuple(a.shape), a.data_ptr()) for a in tables)
        entry = self._fused_compiled.get(bucket)
        if entry is not None and entry[0] == key:
            return entry[1]
        with self._compile_lock:
            entry = self._fused_compiled.get(bucket)
            if entry is not None and entry[0] == key:
                return entry[1]
            return self._build_fused_bucket(bucket, key)

    def fused_forward(self, buf: torch.Tensor, bucket: int) -> torch.Tensor:
        """Eager logits of a fused flush (``fused_run``'s operands)."""
        return self._fused_run(bucket)(buf)

    def _fused_run(self, bucket: int):
        return fused_run(self.weights, self.feature, self.compute_dtype,
                         self.sampler.node_caps(bucket), self.fanouts, self._fused_tables(),
                         bucket)

    def _build_fused_bucket(self, bucket: int, key) -> _Bucket:
        caps = self.sampler.node_caps(bucket)
        t0 = time.perf_counter()
        rep = torch.zeros(bucket + 2, dtype=torch.int64, device=self.device)
        rep[bucket] = 1  # one live seed (vertex 0), key 0
        run = self._fused_run(bucket)
        if self.device.type == "cuda":
            graph, out = capture(lambda: run(rep), self.device)
            entry = _Bucket(run, graph=graph, static=rep, out=out)
        else:
            entry = _Bucket(run)
        dt = time.perf_counter() - t0
        self._fused_compiled[bucket] = (key, entry)
        self._built(f"serve.fused_bucket_{bucket}", bucket, dt, lambda: run(rep))
        log.info("%s: fused bucket %d (caps %s, sample+execute one replay) in %.3fs",
                 self._built_how(), bucket, caps, dt)
        return entry

    def _stage(self, host: torch.Tensor) -> Staged:
        """One non-blocking copy of a pinned host buffer on the side stream
        (CUDA), or the buffer itself (CPU)."""
        if self.device.type != "cuda":
            return Staged(host)
        with torch.cuda.stream(self._h2d_stream):
            dev = torch.empty_like(host, device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._h2d_stream)
        return Staged(dev, event, host)

    def prepare_fused(self, ids: np.ndarray, bucket: int,
                      key: Optional[int] = None) -> Staged:
        """The fused flush's produce stage: pad the miss set to the bucket
        and stage (seeds, live count, draw key), the ONLY per-request
        operands. The key comes from the sampler's shared Generator unless
        given, so a serving trace replays from one seed."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if key is None:
            key = int(self.sampler.rng.integers(0, 2 ** 31 - 1))
        buf = torch.zeros(int(bucket) + 2, dtype=torch.int64,
                          pin_memory=self.device.type == "cuda")
        buf[: len(ids)] = torch.from_numpy(ids)
        buf[bucket] = len(ids)
        buf[bucket + 1] = int(key)
        return self._stage(buf)

    def execute_fused_prepared(self, prepared: Staged, bucket: int) -> np.ndarray:
        """ONE replay: device draw + remap + gather + forward for a prepared
        fused flush."""
        b = int(bucket)
        out = self._ensure_fused(b)(prepared, self._exec_stream)
        if self.metrics is not None:
            self.metrics.counter_add(f"serve.fused_dispatches.bucket_{b}")
            self._observe(out, b)
        return out

    def fused_predict_rows(self, ids: np.ndarray,
                           bucket: Optional[int] = None) -> np.ndarray:
        """Fresh fused logits [n, n_classes] for arbitrary vertex ids."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        b = int(bucket) if bucket is not None else self.sampler.bucket_for(len(ids))
        logits = self.execute_fused_prepared(self.prepare_fused(ids, b), b)
        return logits[: len(ids)]

    # ---- scoring ---------------------------------------------------------
    def _observe(self, out: np.ndarray, bucket: int) -> None:
        """NTS_NUMERICS=1: stats over every executed batch's logits (host
        numpy over the logits the reply already fetched)."""
        from neutronstarlite_torch.obs import numerics

        if numerics.numerics_enabled():
            numerics.observe_serve_batch(self.metrics, out, bucket)

    def prepare_batch(self, batch: SampledBatch) -> Staged:
        """SampledBatch -> its operands staged on the device: the H2D stage
        of the two-stage serve pipeline, one packed pinned buffer and one
        non-blocking copy, in flight while the previous flush executes."""
        arrays = batch_device_arrays(batch)
        return self._stage(Packing.of(arrays).pack(arrays, pin=self.device.type == "cuda"))

    def execute_prepared(self, prepared: Staged, bucket: int) -> np.ndarray:
        """Run the bucket's executable over staged operands (the executor
        stage): logits [bucket, n_classes]."""
        b = int(bucket)
        entry = self._ensure_compiled(b)
        if prepared.buf.numel() != entry.packing.nbytes:
            raise ValueError(
                f"a flush packed into {prepared.buf.numel()} bytes does not fit bucket "
                f"{b}'s {entry.packing.nbytes}"
            )
        out = entry(prepared, self._exec_stream)
        if self.metrics is not None:
            self._observe(out, b)
        return out

    def forward_batch(self, batch: SampledBatch,
                      bucket: Optional[int] = None) -> np.ndarray:
        """Logits [bucket, n_classes] for a prepared SampledBatch (rows
        beyond the real seed count are padding)."""
        b = int(bucket) if bucket is not None else len(batch.seeds)
        return self.execute_prepared(self.prepare_batch(batch), b)

    def predict(self, node_ids: np.ndarray) -> np.ndarray:
        """Fresh-sampled logits [n, n_classes] for arbitrary vertex ids."""
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        bucket = self.sampler.bucket_for(len(ids))
        if self.fused:
            return self.fused_predict_rows(ids, bucket)
        batch = self.sampler.sample(bucket, ids)
        logits = self.forward_batch(batch, bucket)
        return logits[: len(ids)]
