"""Mini-batch sampled GCN (the reference's GCN_CPU_SAMPLE toolkit) — port of
``neutronstarlite_tpu/models/gcn_sample.py``, registered as
``GCNSAMPLESINGLE``, ``GCNSAMPLE`` and ``GCNCPUSAMPLE``.

Per epoch the training seeds are shuffled and cut into batches; each batch
is a padded multi-hop subgraph (``sample/``), the network runs one
``minibatch_gather`` plus a matmul per hop, and every batch takes a loss,
a backward and an Adam step. Parameters: one Xavier ``W`` per layer (``h @
W``), no batch-norm; the hand-written Adam with its stepped decay.
``PRECISION:bfloat16``: the feature gather and the matmuls in bf16, the
edge weights, the aggregation's sums and the parameters in f32, the logits
returned in f32.

Sampling modes (``SAMPLE_PIPELINE``, or ``NTS_SAMPLE_PIPELINE``):

- ``sync``: the host sampler inside the step loop (the parity oracle);
- ``pipelined``: the same batches from a prefetching producer thread, with
  the copy to the card overlapped on a side stream (``sample/pipeline.py``);
- ``device``: the pipeline with each hop's draw on the device
  (``sample/device_sampler.py``);
- ``fused``: the whole batch step on the device, captured as one CUDA graph
  and replayed once per batch (``sample/fused.py``); no batch payload
  moves from the host.

Dropout: batch ``bi`` of epoch ``e`` draws layer ``i``'s mask from a
generator seeded from ``(seed + 1, e * 100003 + bi, i)`` (the port's form
of JAX's ``fold_in(fold_in(key, e * 100003 + bi), i)``), so a resumed run
replays a straight one; the fused step hashes the same kind of key on the
device. The full edge set never goes to the card: only the features, the
labels and (device, fused) the neighbour table do.

Telemetry (``obs/``), as in the reference: each epoch's stage split
(``sample_wait``, ``step_dispatch``, ``step_device``; also kept in
``stage_history``) goes to ``emit_epoch``; the ``sample.batches``,
``sample.h2d_bytes`` and ``wire.feature_gather_bytes`` registry counters
(``counts`` reads them) and the ``wire.feature_gather_bytes_per_batch``
gauge; the pipeline's producer spans and counters
(``sample/pipeline.py``); in the fused mode one ``epoch_scan`` record per
epoch (``dispatches``: the graph replays), the ``sample.dispatches``
counter and one ``program_cost`` record of the batch step, counted once and
undone. ``NTS_NUMERICS=1`` runs the step with the tensor-stat reductions
(params and grads per layer, the global grad norm) on the device; the
epoch keeps the last batch's stats, and the host fetches them every
``NTS_NUMERICS_EVERY`` epochs. In the fused mode the stats are outputs of
the captured graph itself, written into one static buffer.
``NTS_FINAL_EVAL=0`` (the base's benchmark switch; the reference's sampled
trainer ignores it) skips the end-of-run accuracy pass. Left for a later
slice: ``aot_args`` (tools).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from neutronstarlite_torch.models.base import ToolkitBase, register_algorithm
from neutronstarlite_torch.models.fullbatch import epoch_seed
from neutronstarlite_torch.nn.layers import dropout, dropout_mask
from neutronstarlite_torch.nn.param import AdamConfig, adam_init, adam_update, xavier_uniform
from neutronstarlite_torch.obs import numerics
from neutronstarlite_torch.ops.minibatch import get_feature, get_label, minibatch_gather
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.sample.parallel import ParallelEpochSampler
from neutronstarlite_torch.sample.pipeline import (
    SamplePipeline,
    batch_arrays,
    resolve_sample_pipeline,
    sample_batch_payload_bytes,
    unpack,
)
from neutronstarlite_torch.sample.sampler import Sampler, node_capacities
from neutronstarlite_torch.utils.config import GCN_SAMPLE_ALGORITHMS, check_supported
from neutronstarlite_torch.utils.logging import get_logger
from neutronstarlite_torch.utils.timing import get_time

log = get_logger("gcn_sample")

# cfg switches of the full-batch routes, which the sampled trainer has no
# use for: refused rather than ignored
_FULL_BATCH_ONLY = ("optim_kernel", "pallas_kernel", "kernel", "kernel_tile", "sublinear")
# the registry counters ``counts`` reads
_COUNTS = ("sample.batches", "sample.h2d_bytes", "wire.feature_gather_bytes")


def batch_forward(weights, feature: torch.Tensor, nodes, hops, node_caps, compute_dtype=None,
                  masks=None, drop_rate: float = 0.0) -> torch.Tensor:
    """Logits [B, classes] (f32) of one padded batch: the feature gather,
    then per hop ``minibatch_gather`` and a matmul (ReLU between layers).
    ``node_caps`` are the batch's per-layer capacities; ``compute_dtype``
    (bf16 under ``PRECISION:bfloat16``, else None) casts the gathered rows,
    the aggregations and the weights; ``masks``: one dropout keep-mask per
    hidden layer, or None (eval: the serving engine's forward)."""

    def cast(a: torch.Tensor) -> torch.Tensor:
        return a.to(compute_dtype) if compute_dtype is not None else a

    x = cast(get_feature(feature, nodes[0]))
    last = len(weights) - 1
    for i, (W, (src_l, dst_l, w)) in enumerate(zip(weights, hops)):
        agg = minibatch_gather(src_l, dst_l, w, x, node_caps[i + 1])
        h = cast(agg) @ cast(W)
        if i < last:
            h = torch.relu(h)
            if masks is not None:
                h = dropout(h, masks[i], drop_rate)
        x = h
    return x.float()


@register_algorithm(*GCN_SAMPLE_ALGORITHMS)
class GCNSampleTrainer(ToolkitBase):
    weight_mode = "gcn_norm"
    needs_device_graph = False
    supports_sample_pipeline = True

    @classmethod
    def check_cfg(cls, cfg) -> None:
        check_supported(cfg, resident=False)
        used = [k for k in _FULL_BATCH_ONLY if getattr(cfg, k)]
        if used:
            raise ValueError(
                f"{', '.join(used)} select full-batch aggregation routes; the sampled "
                f"trainer ({cfg.algorithm}) aggregates through minibatch_gather: drop them"
            )
        if not cfg.fanouts():
            raise ValueError("GCNSAMPLE requires FANOUT in the cfg")

    def _finalize_datum(self) -> None:
        # the training batch stream's worker pool forks here, before the
        # first tensor reaches the card (sample/parallel.py)
        self._resolve_tune_autos()
        cfg = self.cfg
        type(self).check_cfg(cfg)
        sizes = cfg.layer_sizes()
        fanouts = cfg.fanouts()
        # the cfg may list more fanouts than layers; use the last n_layers
        self.fanouts = fanouts[-(len(sizes) - 1):]
        self.sample_mode = resolve_sample_pipeline(cfg)
        hop_sampler = None
        if self.sample_mode in ("device", "fused"):
            from neutronstarlite_torch.sample.device_sampler import DeviceUniformSampler

            hop_sampler = DeviceUniformSampler.from_host(self.host_graph, device=self.device)
            log.info(
                "SAMPLE_PIPELINE:%s: on-device uniform hop sampler (neighbour table "
                "[%d, %d], %d pre-thinned vertices)", self.sample_mode,
                self.host_graph.v_num, hop_sampler.width, hop_sampler.thinned,
            )
        # one sampler for every worker count: batch i of epoch e is a
        # function of (seed, e, i), so the worker count is a throughput knob
        self.par_sampler = ParallelEpochSampler(
            self.host_graph, np.where(self.datum.mask == 0)[0], cfg.batch_size,
            self.fanouts, seed=self.seed, hop_sampler=hop_sampler,
        )
        self.sample_workers = self.par_sampler.workers
        self._last_sample_s = 0.0
        super()._finalize_datum()

    def build_model(self) -> None:
        cfg = self.cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sizes = cfg.layer_sizes()
        self.node_caps = node_capacities(cfg.batch_size, self.fanouts)
        self.compute_dtype = torch.bfloat16 if cfg.precision == "bfloat16" else None
        self.init_model()
        # eval streams (sequential) from the mask splits; training batches
        # come from self.par_sampler
        self.samplers = {
            which: Sampler(self.host_graph, np.where(self.datum.mask == which)[0],
                           cfg.batch_size, self.fanouts, seed=self.seed + which)
            for which in (0, 1, 2)
        }
        # the feature gather's bytes per batch: padded input rows at the
        # stored table's width (the cast to bf16 comes after the gather)
        self._gather_bytes_per_batch = (
            self.node_caps[0] * self.sizes[0] * self.datum.feature.dtype.itemsize
        )
        self._sample_payload_bytes = sample_batch_payload_bytes(self.node_caps, self.fanouts)
        self.metrics.gauge_set("wire.feature_gather_bytes_per_batch",
                               self._gather_bytes_per_batch)
        self.stage_history: List[Dict[str, float]] = []
        self._numerics_on = numerics.numerics_enabled()
        self._stats_layout = None  # the fused step's packed-stats layout
        self._fused = None
        if self.sample_mode == "fused":
            from neutronstarlite_torch.sample.fused import FusedEpochRunner, degree_tables

            hs = self.par_sampler.hop_sampler
            self._fused = FusedEpochRunner(
                self._fused_step,
                lambda: self.flat_params + self.opt_state.m + self.opt_state.v
                + [self.adam_step_t],
                self.node_caps, self.fanouts, cfg.batch_size,
                (hs.nbr, hs.eff_deg) + degree_tables(self.host_graph, self.device),
                np.where(self.datum.mask == 0)[0], self.seed + 1, self.device,
            )

    @property
    def counts(self) -> Dict[str, int]:
        """The sampling counters of this trainer's registry."""
        return {k: int(self.metrics.counter_get(k)) for k in _COUNTS}

    def init_model(self) -> None:
        """Parameters from the seed, a fresh optimizer and its config."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator().manual_seed(self.seed)
        self.params = [{"W": xavier_uniform(self.sizes[i], self.sizes[i + 1], gen).to(dev)}
                       for i in range(len(self.sizes) - 1)]
        self.flat_params = [layer["W"] for layer in self.params]
        for p in self.flat_params:
            p.requires_grad_(True)
        self.adam_cfg = AdamConfig(
            alpha=cfg.learn_rate, weight_decay=cfg.weight_decay,
            decay_rate=cfg.decay_rate, decay_epoch=cfg.decay_epoch,
        )
        self.opt_state = adam_init(self.flat_params)
        # the fused step's update count on the device (opt_state.step
        # mirrors it on the host)
        self.adam_step_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.drop_gen = torch.Generator(device=dev)

    # ---- the batch step ----------------------------------------------------
    def _forward(self, weights, nodes, hops, masks=None) -> torch.Tensor:
        """Logits [B, classes] (f32) of one padded batch at ``weights`` (one
        W per layer); ``masks``: one dropout keep-mask per hidden layer, or
        None (eval, or rate 0)."""
        return batch_forward(weights, self.feature, nodes, hops, self.node_caps,
                             self.compute_dtype, masks, self.cfg.drop_rate)

    def _mask_shapes(self):
        return [(self.node_caps[i + 1], self.sizes[i + 1]) for i in range(len(self.sizes) - 2)]

    def _step(self, nodes, hops, seed_mask, seeds, masks, step_t=None):
        """Loss, gradients and the Adam update of one batch, in place; with
        ``NTS_NUMERICS=1`` also the step's tensor stats on the device:
        returns the loss, or (loss, stats). The gradients are taken with
        respect to fresh leaves that share the parameters' storage: a
        captured step then builds its whole autograd graph inside the
        capture, on the capturing stream."""
        weights = [p.detach().requires_grad_(True) for p in self.flat_params]
        logits = self._forward(weights, nodes, hops, masks)
        loss = self.masked_nll_loss(logits, get_label(self.label, seeds), seed_mask)
        grads = torch.autograd.grad(loss, weights)
        adam_update(self.flat_params, grads, self.opt_state, self.adam_cfg, step_t=step_t)
        if not self._numerics_on:
            return loss.detach()
        stats = numerics.step_stats(params=self.params, grads=[{"W": g} for g in grads])
        return loss.detach(), stats

    def _train_batch(self, nodes, hops, seed_mask, seeds, epoch: int, bi: int):
        masks = None
        rate = self.cfg.drop_rate
        if rate > 0:
            masks = []
            for i, shape in enumerate(self._mask_shapes()):
                self.drop_gen.manual_seed(epoch_seed(self.seed + 1, epoch * 100003 + bi, i))
                masks.append(dropout_mask(shape, rate, self.drop_gen))
        return self._step(nodes, hops, seed_mask, seeds, masks)

    def _fused_step(self, nodes, hops, seed_mask, seeds, key):
        """The fused batch update (``FusedEpochRunner``): hashed dropout
        masks and the device update count, so that it can be captured; with
        ``NTS_NUMERICS=1`` the stats come back packed into one tensor
        (``numerics.pack_stats``), which the runner keeps in a static
        buffer."""
        from neutronstarlite_torch.sample.fused import dropout_keep

        rate = self.cfg.drop_rate
        masks = None
        if rate > 0:
            masks = [dropout_keep(key, i, shape, rate, self.device)
                     for i, shape in enumerate(self._mask_shapes())]
        out = self._step(nodes, hops, seed_mask, seeds, masks, step_t=self.adam_step_t)
        if not self._numerics_on:
            return out
        loss, stats = out
        self._stats_layout, packed = numerics.pack_stats(stats)
        return loss, packed

    def _to_device(self, b):
        tensors = [torch.from_numpy(np.asarray(a)).to(self.device) for a in batch_arrays(b)]
        return unpack(tensors, len(self.fanouts))

    # ---- evaluation and the epoch loop ---------------------------------------
    @torch.no_grad()
    def _evaluate(self, which: int) -> float:
        correct = total = 0
        for b in self.samplers[which].sample_epoch(shuffle=False):
            nodes, hops, _, _ = self._to_device(b)
            logits = self._forward(self.flat_params, nodes, hops).cpu().numpy()
            real = b.seed_mask > 0
            pred = logits.argmax(axis=1)[real]
            target = self.datum.label[b.seeds[real]]
            correct += int((pred == target).sum())
            total += int(real.sum())
        acc = correct / max(total, 1)
        name = {0: "Train", 1: "Eval", 2: "Test"}[which]
        log.info("%s Acc: %f %d %d", name, acc, total, correct)
        return acc

    def _epoch_batches(self, epoch: int, pipeline):
        """One epoch's device batches ``(nodes, hops, seed_mask, seeds)``;
        afterwards ``_last_sample_s`` holds the host time spent waiting on
        sampling (sync: the serial sample and copy time; pipelined: the
        residual queue stall)."""
        n_layers = len(self.fanouts)
        if pipeline is not None:
            for staged in pipeline.epoch_stream(epoch):
                yield unpack(staged.ready(), n_layers)
            self._last_sample_s = pipeline.last_epoch_stall_s
            return
        sample_s = 0.0
        it = iter(self.par_sampler.sample_epoch(epoch))
        while True:
            t0 = get_time()
            try:
                b = next(it)
            except StopIteration:
                break
            arrays = self._to_device(b)
            sample_s += get_time() - t0
            yield arrays
        self._last_sample_s = sample_s

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _after_epoch(self, epoch: int, t0: float, losses, stats, dispatch_s: float,
                     device_s: float) -> None:
        """Epoch-end bookkeeping: the numerics records, the epoch_loss fault
        point, the loss history, the counters and the stage split, the
        epoch record and the guards (``emit_epoch``), the checkpoint hook."""
        fused = self._fused is not None
        emit_s = self.maybe_emit_numerics(epoch, stats)  # kept out of the epoch's time
        # chaos hook (NTS_FAULT_SPEC): before the loss reaches the history
        epoch_loss = fault_point("epoch_loss", epoch=epoch, value=float(np.mean(losses)))
        dt = get_time() - t0 - emit_s
        self.epoch_times.append(dt)
        self.loss_history.append(float(epoch_loss))
        n = len(losses)
        m = self.metrics
        # the fused step gathers from the resident slab: no wire gather and
        # no batch payload from the host
        gather_bytes = 0 if fused else n * self._gather_bytes_per_batch
        if self.sample_mode in ("sync", "fused"):
            # pipelined and device count what their producer staged
            m.counter_add("sample.h2d_bytes", 0 if fused else n * self._sample_payload_bytes)
        m.counter_add("sample.batches", n)
        m.counter_add("wire.feature_gather_bytes", gather_bytes)
        if fused:
            r = self._fused
            m.counter_add("sample.dispatches", r.n_batches)
            m.gauge_set("sample.graph_captures", r.captures)
            m.event("epoch_scan", bucket=int(r.n_batches), batches=n,
                    dispatches=int(r.n_batches), h2d_bytes=0, epoch=int(epoch),
                    seconds=round(dt, 6), replays=int(r.replays))
        stages = {
            "sample_wait": self._last_sample_s,
            "step_dispatch": dispatch_s,
            "step_device": device_s,
        }
        self.stage_history.append(stages)
        self.emit_epoch(epoch, dt, self.loss_history[-1], stages=stages, batches=n,
                        feature_gather_bytes=gather_bytes)
        if epoch % max(1, self.cfg.epochs // 10) == 0 or epoch == self.cfg.epochs - 1:
            log.info("Epoch %d loss %f (%d batches)", epoch, self.loss_history[-1], n)
        self.ckpt_epoch_end(epoch)

    def _count_fused_cost(self, epoch: int) -> None:
        """The fused batch step's program_cost, counted once on one eager
        step and undone (``count_program_cost``)."""
        r = self._fused

        def one():
            r.epoch_t.fill_(int(epoch))
            r.batch_t.zero_()
            r._shuffle()
            r.step()

        self.adam_step_t.fill_(self.opt_state.step)
        self.count_program_cost(
            f"sample.fused_step_b{r.n_batches}", one,
            self.flat_params + self.opt_state.m + self.opt_state.v + [self.adam_step_t],
            bucket=int(r.n_batches),
        )

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        log.info(
            "GNNmini::Engine[torch.GCNSampleimpl] B=%d fanout=%s [%d] Epochs (%d sample "
            "workers, sampling %s) on %s", cfg.batch_size, self.fanouts, cfg.epochs,
            self.sample_workers, self.sample_mode, self.device,
        )
        loss = None
        start_epoch = self.ckpt_begin()
        pipeline = None
        if self._fused is not None and start_epoch < cfg.epochs:
            self._count_fused_cost(start_epoch)
        if self.sample_mode in ("pipelined", "device") and start_epoch < cfg.epochs:
            # a fresh pipeline per run(): a supervised retry re-enters here
            # and schedules from its rollback epoch
            pipeline = SamplePipeline(self.par_sampler, range(start_epoch, cfg.epochs),
                                      device=self.device, metrics=self.metrics,
                                      tracer=self.tracer)
        try:
            for epoch in range(start_epoch, cfg.epochs):
                t0 = get_time()
                dispatch_s = 0.0
                stats = None
                if self._fused is not None:
                    self.adam_step_t.fill_(self.opt_state.step)
                    td = get_time()
                    losses_dev = self._fused.run_epoch(epoch)
                    dispatch_s = get_time() - td
                    self.opt_state.step += self._fused.n_batches
                    self._last_sample_s = 0.0
                    if self._numerics_on:
                        stats = (self._stats_layout, self._fused.stats)
                else:
                    step_losses = []
                    for bi, (nodes, hops, seed_mask, seeds) in enumerate(
                        self._epoch_batches(epoch, pipeline)
                    ):
                        td = get_time()
                        out = self._train_batch(nodes, hops, seed_mask, seeds, epoch, bi)
                        if self._numerics_on:
                            out, stats = out  # the epoch keeps the last batch's
                        step_losses.append(out)
                        dispatch_s += get_time() - td
                    losses_dev = torch.stack(step_losses)
                tw = get_time()
                self._sync()
                device_s = get_time() - tw
                losses = losses_dev.cpu().tolist()
                loss = losses[-1]
                self._after_epoch(epoch, t0, losses, stats, dispatch_s, device_s)
        finally:
            # drain on any exit (early stop, guard trip, worker fault)
            if pipeline is not None:
                pipeline.close()
        self.ckpt_final()
        # release the worker pool; a second run() samples inline, same batches
        self.par_sampler.close()
        if self.skip_final_eval(loss):
            accs = {"train": None, "eval": None, "test": None}
        else:
            accs = {"train": self._evaluate(0), "eval": self._evaluate(1),
                    "test": self._evaluate(2)}
        avg = self.avg_epoch_time()
        log.info("--avg epoch time %.4f s", avg)
        result = {
            "loss": float(loss) if loss is not None else float("nan"),
            "acc": accs,
            "avg_epoch_s": avg,
        }
        self.finalize_metrics(result)
        return result
