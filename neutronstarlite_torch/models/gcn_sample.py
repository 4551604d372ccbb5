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

The stage split of each epoch (``stage_history``: ``sample_wait``,
``step_dispatch``, ``step_device``) and the ``sample.batches``,
``sample.h2d_bytes`` and ``wire.feature_gather_bytes`` counts
(``counts``) are kept as plain numbers under the reference's names; the
metrics stream that carries them is the obs slice's. ``NTS_FINAL_EVAL=0``
(the base's benchmark switch; the reference's sampled trainer ignores it)
skips the end-of-run accuracy pass. Left for later slices: the
``NTS_NUMERICS`` stats step (obs) and ``aot_args`` (tools).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from neutronstarlite_torch.models.base import ToolkitBase, register_algorithm
from neutronstarlite_torch.models.fullbatch import epoch_seed
from neutronstarlite_torch.nn.layers import dropout, dropout_mask
from neutronstarlite_torch.nn.param import AdamConfig, adam_init, adam_update, xavier_uniform
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

log = get_logger("gcn_sample")

# cfg switches of the full-batch routes, which the sampled trainer has no
# use for: refused rather than ignored
_FULL_BATCH_ONLY = ("optim_kernel", "pallas_kernel", "kernel", "kernel_tile", "sublinear")


@register_algorithm(*GCN_SAMPLE_ALGORITHMS)
class GCNSampleTrainer(ToolkitBase):
    weight_mode = "gcn_norm"

    def _finalize_datum(self) -> None:
        # the training batch stream's worker pool forks here, before the
        # first tensor reaches the card (sample/parallel.py)
        cfg = self.cfg
        check_supported(cfg, resident=False)
        used = [k for k in _FULL_BATCH_ONLY if getattr(cfg, k)]
        if used:
            raise ValueError(
                f"{', '.join(used)} select full-batch aggregation routes; the sampled "
                f"trainer ({cfg.algorithm}) aggregates through minibatch_gather: drop them"
            )
        sizes = cfg.layer_sizes()
        fanouts = cfg.fanouts()
        if not fanouts:
            raise ValueError("GCNSAMPLE requires FANOUT in the cfg")
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
        self.counts = {"sample.batches": 0, "sample.h2d_bytes": 0,
                       "wire.feature_gather_bytes": 0}
        self.stage_history: List[Dict[str, float]] = []
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
    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        return a.to(self.compute_dtype) if self.compute_dtype is not None else a

    def _forward(self, weights, nodes, hops, masks=None) -> torch.Tensor:
        """Logits [B, classes] (f32) of one padded batch at ``weights`` (one
        W per layer); ``masks``: one dropout keep-mask per hidden layer, or
        None (eval, or rate 0)."""
        x = self._cast(get_feature(self.feature, nodes[0]))
        last = len(weights) - 1
        for i, (W, (src_l, dst_l, w)) in enumerate(zip(weights, hops)):
            agg = minibatch_gather(src_l, dst_l, w, x, self.node_caps[i + 1])
            h = self._cast(agg) @ self._cast(W)
            if i < last:
                h = torch.relu(h)
                if masks is not None:
                    h = dropout(h, masks[i], self.cfg.drop_rate)
            x = h
        return x.float()

    def _mask_shapes(self):
        return [(self.node_caps[i + 1], self.sizes[i + 1]) for i in range(len(self.sizes) - 2)]

    def _step(self, nodes, hops, seed_mask, seeds, masks, step_t=None) -> torch.Tensor:
        """Loss, gradients and the Adam update of one batch, in place. The
        gradients are taken with respect to fresh leaves that share the
        parameters' storage: a captured step then builds its whole autograd
        graph inside the capture, on the capturing stream."""
        weights = [p.detach().requires_grad_(True) for p in self.flat_params]
        logits = self._forward(weights, nodes, hops, masks)
        loss = self.masked_nll_loss(logits, get_label(self.label, seeds), seed_mask)
        grads = torch.autograd.grad(loss, weights)
        adam_update(self.flat_params, grads, self.opt_state, self.adam_cfg, step_t=step_t)
        return loss.detach()

    def _train_batch(self, nodes, hops, seed_mask, seeds, epoch: int, bi: int) -> torch.Tensor:
        masks = None
        rate = self.cfg.drop_rate
        if rate > 0:
            masks = []
            for i, shape in enumerate(self._mask_shapes()):
                self.drop_gen.manual_seed(epoch_seed(self.seed + 1, epoch * 100003 + bi, i))
                masks.append(dropout_mask(shape, rate, self.drop_gen))
        return self._step(nodes, hops, seed_mask, seeds, masks)

    def _fused_step(self, nodes, hops, seed_mask, seeds, key) -> torch.Tensor:
        """The fused batch update (``FusedEpochRunner``): hashed dropout
        masks and the device update count, so that it can be captured."""
        from neutronstarlite_torch.sample.fused import dropout_keep

        rate = self.cfg.drop_rate
        masks = None
        if rate > 0:
            masks = [dropout_keep(key, i, shape, rate, self.device)
                     for i, shape in enumerate(self._mask_shapes())]
        return self._step(nodes, hops, seed_mask, seeds, masks, step_t=self.adam_step_t)

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
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            arrays = self._to_device(b)
            sample_s += time.perf_counter() - t0
            yield arrays
        self._last_sample_s = sample_s

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _after_epoch(self, epoch: int, t0: float, losses, dispatch_s: float,
                     device_s: float) -> None:
        """Epoch-end bookkeeping: the epoch_loss fault point, the loss
        history, the counts and the stage split, the guards, the checkpoint
        hook."""
        fused = self._fused is not None
        # chaos hook (NTS_FAULT_SPEC): before the loss reaches the history
        epoch_loss = fault_point("epoch_loss", epoch=epoch, value=float(np.mean(losses)))
        dt = time.perf_counter() - t0
        self.epoch_times.append(dt)
        self.loss_history.append(float(epoch_loss))
        n = len(losses)
        self.counts["sample.batches"] += n
        if not fused:
            self.counts["wire.feature_gather_bytes"] += n * self._gather_bytes_per_batch
        if self.sample_mode == "sync":
            # pipelined and device count what their producer staged
            self.counts["sample.h2d_bytes"] += n * self._sample_payload_bytes
        self.stage_history.append({
            "sample_wait": self._last_sample_s,
            "step_dispatch": dispatch_s,
            "step_device": device_s,
        })
        self.emit_epoch(epoch, dt, self.loss_history[-1])
        if epoch % max(1, self.cfg.epochs // 10) == 0 or epoch == self.cfg.epochs - 1:
            log.info("Epoch %d loss %f (%d batches)", epoch, self.loss_history[-1], n)
        self.ckpt_epoch_end(epoch)

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
        if self.sample_mode in ("pipelined", "device") and start_epoch < cfg.epochs:
            # a fresh pipeline per run(): a supervised retry re-enters here
            # and schedules from its rollback epoch
            pipeline = SamplePipeline(self.par_sampler, range(start_epoch, cfg.epochs),
                                      device=self.device)
        try:
            for epoch in range(start_epoch, cfg.epochs):
                t0 = time.perf_counter()
                dispatch_s = 0.0
                if self._fused is not None:
                    self.adam_step_t.fill_(self.opt_state.step)
                    td = time.perf_counter()
                    losses_dev = self._fused.run_epoch(epoch)
                    dispatch_s = time.perf_counter() - td
                    self.opt_state.step += self._fused.n_batches
                    self._last_sample_s = 0.0
                else:
                    step_losses = []
                    for bi, (nodes, hops, seed_mask, seeds) in enumerate(
                        self._epoch_batches(epoch, pipeline)
                    ):
                        td = time.perf_counter()
                        step_losses.append(
                            self._train_batch(nodes, hops, seed_mask, seeds, epoch, bi)
                        )
                        dispatch_s += time.perf_counter() - td
                    losses_dev = torch.stack(step_losses)
                tw = time.perf_counter()
                self._sync()
                device_s = time.perf_counter() - tw
                losses = losses_dev.cpu().tolist()
                loss = losses[-1]
                self._after_epoch(epoch, t0, losses, dispatch_s, device_s)
        finally:
            # drain on any exit (early stop, guard trip, worker fault)
            if pipeline is not None:
                pipeline.close()
                self.counts["sample.h2d_bytes"] += pipeline.h2d_bytes
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
        return {
            "loss": float(loss) if loss is not None else float("nan"),
            "acc": accs,
            "avg_epoch_s": avg,
        }
