"""Full-batch trainer: routing, train step, epoch loop — port of
``neutronstarlite_tpu/models/fullbatch.py``.

Aggregation routes (``build_model``):

- default: ``ops.aggregate.ScatterGraph``, the plain PyTorch scatter;
- ``KERNEL:fused_edge`` (GAT, GGCN): ``ops.fused_edge.FusedEdgePair``, the
  fused score -> softmax -> aggregation over blocked tables (``KERNEL_TILE``
  sets the source-tile height, ``ELL_LEVELS`` the level ladder);
- ``OPTIM_KERNEL:1 PALLAS:1``: ``ops.bsp_ell.BspEllPair``, the block-sparse
  kernel (``KERNEL_TILE`` sets its source-tile height);
- ``OPTIM_KERNEL:1 KERNEL_TILE:<vt>`` without ``PALLAS``:
  ``ops.blocked_ell.BlockedEllPair``, the source-tiled blocked ELL tables in
  plain PyTorch (as in JAX, where it is XLA code);
- ``OPTIM_KERNEL:1 PALLAS:1`` with ``NTS_PALLAS_RESIDENT=1``, and
  ``OPTIM_KERNEL:1`` alone: ``ops.ell.EllPair``, the ELL-level kernel. In
  JAX, OPTIM_KERNEL alone runs the same ELL tables through XLA's gather
  and PALLAS+RESIDENT through the Pallas kernel; both compute the same
  function, which the port runs through its one hand-written kernel.

The OPTIM_KERNEL routes are taken only by trainers that declare
``supports_optim_kernel`` (GCN, GIN, CommNet, GAT), the fused route only by
those that declare ``supports_fused_edge`` (GAT, GGCN); GAT wraps the ELL
tables as ``ops.ell_gat.GatEllPair`` (``adapt_ell_graph``) and refuses the
bsp and blocked tables. Without the fused route GGCN keeps the edge arrays.
``PRECISION`` is read by the GCN family alone; the others log a warning and
run f32.

The step is forward -> masked NLL -> ``backward()`` -> ``adam_update`` (in
place). Each epoch's loss and the training forward's logits come from
before the update, as in JAX; the cadence accuracy lines use those
train-mode logits. Matmuls run in full float32: TF32 is switched off.

The run loop is the reference's: ``ckpt_begin`` (resume or rollback), per
epoch the step, ``fault_point("epoch_loss")``, ``emit_epoch`` (the metrics
stream, then the guards) and ``ckpt_epoch_end``, then ``ckpt_final`` and
``finalize_metrics``. Epoch e's dropout masks come from a generator seeded
from (seed, e) at the start of the epoch, the port's form of JAX's
``fold_in(key, e)``: a resumed or rolled-back run draws the masks of a
straight run, and the checkpoint needs no RNG leaf.

Observability, as in the reference:

- each epoch's stages are ``step_dispatch`` (the host issuing the step) and
  ``step_device`` (the loop's one synchronise); ``NTS_TRACE_STEP=1`` runs
  the epoch as two steps, forward+backward then the optimiser, with a
  synchronise after each (stages ``forward_backward``/``optim``; the cadence
  accuracy lines are skipped);
- ``NTS_NUMERICS=1`` runs ``train_step_stats``, the default step plus the
  tensor-stat reductions on the device (``obs/numerics``), and leaves
  ``train_step`` untouched; the stats reach the host every
  ``NTS_NUMERICS_EVERY`` epochs, outside the timed epoch, as the epoch's
  own records are;
- one step, counted and then undone, gives the ``program_cost`` records
  once per trainer before the first epoch (``obs/cost``);
- ``NTS_PROFILE_DIR`` records a ``torch.profiler`` trace of the epochs from
  the second one on;
- ``NTS_DEBUGINFO=1`` prints the forward / backward / update report after
  training (``models/debuginfo.py``; a trainer with an nn-only forward,
  ``nn_only_forward``, adds the nn / graph split: the distributed ones);
- GAT and GGCN set the ``kernel.path`` and
  ``kernel.edge_hbm_bytes_per_epoch`` gauges (and the fused tables'
  ``kernel.fused_*`` gauges); the edge chain's estimate counts the graph's
  E edges (the reference counts its chunk-padded edge arrays).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict

import numpy as np
import torch

from neutronstarlite_torch.models import debuginfo
from neutronstarlite_torch.models.base import ToolkitBase
from neutronstarlite_torch.nn.param import (
    AdamConfig,
    AdamState,
    adam_init,
    adam_update,
    param_leaves,
    param_tree,
)
from neutronstarlite_torch.obs import numerics
from neutronstarlite_torch.ops.aggregate import ScatterGraph
from neutronstarlite_torch.ops.blocked_ell import BlockedEllPair
from neutronstarlite_torch.ops.bsp_ell import DEFAULT_VT, BspEllPair
from neutronstarlite_torch.ops.ell import EllPair
from neutronstarlite_torch.ops.fused_edge import FusedEdgePair
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.utils.config import check_supported
from neutronstarlite_torch.utils.logging import get_logger
from neutronstarlite_torch.utils.profiling import maybe_trace
from neutronstarlite_torch.utils.timing import get_time

log = get_logger("fullbatch")


def epoch_seed(seed: int, *values: int) -> int:
    """The dropout generator's seed for one epoch (values: the epoch), or
    for one layer of one batch (the sampled trainer), a pure function of
    (seed, values)."""
    words = [int(seed)] + [int(v) for v in values]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


class FullBatchTrainer(ToolkitBase):
    """Template for single-device full-batch models."""

    # models whose only graph op is the weighted aggregation run it through
    # the kernel tables under OPTIM_KERNEL:1; GAT runs its attention over
    # the ELL tables (adapt_ell_graph); the others (GGCN) keep the edge
    # arrays whatever OPTIM_KERNEL says
    supports_optim_kernel = False
    # KERNEL:fused_edge runs the trainer's attention through the fused op
    # (GAT, GGCN)
    supports_fused_edge = False
    # trainers whose forward consumes PRECISION (the GCN family); the others
    # warn and run f32, as in JAX
    supports_precision = False

    def init_params(self, generator: torch.Generator):
        raise NotImplementedError

    def model_forward(self, params, graph, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward_taped(self, params, graph, x: torch.Tensor, tap, train: bool = True):
        """The numerics hook: ``model_forward`` with ``tap(i, h) -> h``
        applied to each layer's output (the GCN family implements it).
        None: the model has no layer taps; the stats step then has no
        ``acts`` groups and the provenance replay is unattributed."""
        return None

    # attention / edge-op families (GAT, GGCN) set the kernel.* gauges
    edge_family = False
    # the step's program_cost label (obs/cost)
    cost_label = "fullbatch.train_step"
    # NTS_NUMERICS=1 runs the stats step (the distributed mirror family, as
    # in JAX, trains on without it)
    supports_numerics = True
    # NTS_DEBUGINFO=1 prints the report after training
    supports_debuginfo = True

    @staticmethod
    def edge_score_channels(f_out: int) -> int:
        """Score-channel width per output width (GAT 1; GGCN f)."""
        return 1

    def adapt_ell_graph(self, compute_graph):
        """Hook: wrap or replace the OPTIM_KERNEL tables with the trainer's
        own (GAT adds its attention slot maps)."""
        return compute_graph

    @classmethod
    def check_cfg(cls, cfg) -> None:
        resident = os.environ.get("NTS_PALLAS_RESIDENT", "0") == "1"
        check_supported(cfg, resident, cls.supports_fused_edge)

    def build_compute_graph(self):
        cfg, g, dev = self.cfg, self.host_graph, self.device
        resident = os.environ.get("NTS_PALLAS_RESIDENT", "0") == "1"
        type(self).check_cfg(cfg)
        if cfg.kernel == "fused_edge":
            pair = FusedEdgePair.from_host(g, vt=cfg.kernel_tile, levels=cfg.ell_levels,
                                           device=dev)
            log.info(
                "KERNEL:fused_edge: blocked streaming SDDMM+softmax+SpMM (%d src "
                "tiles of %d, %d fwd levels, %d table slots)", pair.fwd.n_tiles,
                pair.fwd.vt, len(pair.fwd.nbr), pair.slot_count(),
            )
            return pair
        if not (cfg.optim_kernel and type(self).supports_optim_kernel):
            return ScatterGraph.from_host(g, device=dev)
        if cfg.pallas_kernel and not resident:
            pair = BspEllPair.from_host(g, vt=cfg.kernel_tile or DEFAULT_VT, device=dev)
            log.info(
                "OPTIM_KERNEL: block-sparse aggregation kernel (%d fwd blocks, "
                "dt=%d vt=%d)", pair.fwd.nbr.shape[0], pair.fwd.dt, pair.fwd.vt,
            )
        elif cfg.kernel_tile > 0:
            pair = BlockedEllPair.from_host(g, vt=cfg.kernel_tile, device=dev)
            log.info(
                "OPTIM_KERNEL: blocked ELL aggregation (%d src tiles of %d vertices, "
                "%d stacked levels, %d fwd table slots)", pair.fwd.n_tiles,
                pair.fwd.vt, len(pair.fwd.nbr), pair.fwd.slot_count(),
            )
        else:
            pair = EllPair.from_host(g, device=dev)
            log.info(
                "OPTIM_KERNEL: ELL-level aggregation kernel (%d fwd buckets)",
                len(pair.fwd.nbr),
            )
        return self.adapt_ell_graph(pair)

    def build_model(self) -> None:
        cfg = self.cfg
        if cfg.precision == "bfloat16" and not type(self).supports_precision:
            log.warning(
                "PRECISION:bfloat16 is not implemented for the single-chip %s "
                "trainer; running f32", cfg.algorithm,
            )
        # full-float32 matmuls on the card (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.compute_graph = self.build_compute_graph()
        if type(self).edge_family:
            self._emit_edge_kernel_gauges()
        self.train01 = (self.mask == 0).to(torch.float32)
        self.init_model()
        log.info("matmul precision: float32 (TF32 off), device %s", self.device)

    def _emit_edge_kernel_gauges(self) -> None:
        """``kernel.path`` and ``kernel.edge_hbm_bytes_per_epoch`` (the
        per-epoch bytes of [E, .] edge tensors the chain materializes: per
        layer two feature-wide passes and three score-wide ones, f32; 0 on
        the fused and ELL attention paths), and the fused tables' gauges."""
        cg, m = self.compute_graph, self.metrics
        if isinstance(cg, FusedEdgePair):
            path, edge_bytes = "fused_edge", 0
            m.gauge_set("kernel.fused_levels", len(cg.fwd.nbr))
            m.gauge_set("kernel.fused_slots", cg.slot_count())
            m.gauge_set("kernel.fused_vt", cg.fwd.vt)
        elif isinstance(cg, ScatterGraph):
            path = "eager_edge"
            e = self.host_graph.e_num
            edge_bytes = sum(e * (2 * f + 3 * type(self).edge_score_channels(f)) * 4
                             for f in self.cfg.layer_sizes()[1:])
        else:
            path, edge_bytes = "ell_gat", 0
        m.gauge_set("kernel.path", path)
        m.gauge_set("kernel.edge_hbm_bytes_per_epoch", edge_bytes)

    def init_model(self) -> None:
        """Parameters from the seed, a fresh optimizer and an AdamConfig
        from the cfg (the supervisor's restart after an LR change), on the
        tables already built."""
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(self.seed)
        self.params = [
            {k: (v.to(self.device) if torch.is_tensor(v)
                 else {n: t.to(self.device) for n, t in v.items()})
             for k, v in layer.items()}
            for layer in self.init_params(init_gen)
        ]
        self.flat_params = param_leaves(self.params)
        for p in self.flat_params:
            p.requires_grad_(True)
        self.adam_cfg = AdamConfig(
            alpha=cfg.learn_rate,
            weight_decay=cfg.weight_decay,
            decay_rate=cfg.decay_rate,
            decay_epoch=cfg.decay_epoch,
        )
        self.opt_state = adam_init(self.flat_params)
        self.drop_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)

    def train_step(self):
        """One epoch: returns (loss, train-mode logits), both detached."""
        loss, logits = self._forward_backward()
        self._optim_step()
        return loss, logits

    def train_step_stats(self):
        """``NTS_NUMERICS=1``: ``train_step`` plus the tensor-stat
        reductions on the device; returns (loss, logits, stats). The taps
        only keep references to the layers' outputs, so the step's math is
        the default step's."""
        acts = []

        def tap(i, h):
            acts.append(h)
            return h

        loss, logits = self._forward_backward(tap)
        grads = [p.grad for p in self.flat_params]
        adam_update(self.flat_params, grads, self.opt_state, self.adam_cfg)
        # a narrowed wire (the distributed ring's WIRE_DTYPE) adds its
        # layer-0 payload at the wire dtype and its quantisation error
        wire_dtype = getattr(self, "wire_dtype", None)
        stats = numerics.step_stats(params=self.params,
                                    grads=param_tree(self.params, grads),
                                    acts=acts, logits=logits,
                                    wire=self.feature if wire_dtype is not None else None,
                                    wire_dtype=wire_dtype)
        return loss, logits, stats

    def _forward_backward(self, tap=None):
        """Forward, loss and backward of one epoch, the gradients left on
        the parameters; returns (loss, logits), detached. The step's first
        half (``NTS_TRACE_STEP`` and DEBUGINFO time it alone). ``tap``
        runs ``forward_taped`` (the stats step's activations)."""
        for p in self.flat_params:
            p.grad = None
        logits = None
        if tap is not None:
            logits = self.forward_taped(self.params, self.compute_graph, self.feature, tap)
        if logits is None:
            logits = self.model_forward(self.params, self.compute_graph, self.feature, True)
        loss = self.masked_nll_loss(logits, self.label, self.train01)
        loss.backward()
        return loss.detach(), logits.detach()

    def _optim_step(self) -> None:
        adam_update(self.flat_params, [p.grad for p in self.flat_params],
                    self.opt_state, self.adam_cfg)

    @torch.no_grad()
    def eval_logits(self) -> torch.Tensor:
        return self.model_forward(self.params, self.compute_graph, self.feature, False)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def numerics_replay(self, epoch: int):
        """The non-finite provenance replay: the failing epoch's forward,
        with its dropout masks, layer by layer through ``forward_taped``,
        the chaos poison applied at each layer (``numerics.poison_hook``).
        None when the model has no layer taps."""
        if type(self).forward_taped is FullBatchTrainer.forward_taped:
            return None
        entries = []

        def tap(i, h):
            h = numerics.poison_hook(h, i)
            entries.append((i, "activation", f"acts/l{i}", h))
            return h

        self.drop_gen.manual_seed(epoch_seed(self.seed + 1, epoch))
        with torch.no_grad():
            logits = self.forward_taped(self.params, self.compute_graph, self.feature, tap)
        entries.append((None, "logits", "logits", logits))
        return entries

    def nn_only_forward(self, train: bool = True):
        """DEBUGINFO's nn-only logits: the model with its graph exchange
        disabled, at the true layer widths. A trainer that does not
        override it has no nn / graph split in its report."""
        raise NotImplementedError

    def debug_info(self, n: int = 3) -> str:
        """The DEBUGINFO report: the forward (and, with ``nn_only_forward``,
        the forward without the exchange), forward+backward and the whole
        step, each timed warm (``models/debuginfo.py``). The parameters and
        the optimizer state are put back afterwards."""
        saved = [t.detach().clone() for t in self.flat_params]
        opt = self.opt_state
        saved_opt = AdamState([t.clone() for t in opt.m], [t.clone() for t in opt.v], opt.step)

        def loss_of(logits):
            return self.masked_nll_loss(logits, self.label, self.train01)

        def fwd():
            with torch.no_grad():
                return loss_of(self.model_forward(self.params, self.compute_graph,
                                                  self.feature, True))

        def nn_only():
            with torch.no_grad():
                return loss_of(self.nn_only_forward(True))

        dist_report = type(self).nn_only_forward is not FullBatchTrainer.nn_only_forward
        t_nn = debuginfo.time_median(nn_only, self.device, n) if dist_report else None
        t_fwd = debuginfo.time_median(fwd, self.device, n)
        t_grad = debuginfo.time_median(self._forward_backward, self.device, n)
        t_step = debuginfo.time_median(self.train_step, self.device, n)
        with torch.no_grad():
            for t, v in zip(self.flat_params, saved):
                t.copy_(v)
                t.grad = None
            self.opt_state = saved_opt
        if dist_report:
            return debuginfo.format_dist_report(t_nn, t_fwd, t_grad, t_step)
        return debuginfo.format_report(t_fwd, t_grad, t_step)

    def _epoch_step(self, split: bool):
        """One epoch's step: (loss, logits or None, stats or None, stages)."""
        tracer = self.tracer
        t0 = get_time()
        stats = None
        if split:
            with tracer.annotate("forward_backward"):
                loss, _ = self._forward_backward()
                self._sync()
            t_fb = get_time()
            with tracer.annotate("optim"):
                self._optim_step()
                self._sync()
            return loss, None, None, {"forward_backward": t_fb - t0,
                                      "optim": get_time() - t_fb}
        with tracer.annotate("step_dispatch"):
            if self._numerics_on:
                loss, logits, stats = self.train_step_stats()
            else:
                loss, logits = self.train_step()
        t_disp = get_time()
        with tracer.annotate("step_device"):
            self._sync()
        return loss, logits, stats, {"step_dispatch": t_disp - t0,
                                     "step_device": get_time() - t_disp}

    def end_of_epoch(self, epoch: int, seconds: float, stages: dict) -> None:
        """Hook after each epoch's records, before its checkpoint."""

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        log.info(
            "GNNmini::Engine[torch.%s] running [%d] Epochs on %s",
            type(self).__name__, cfg.epochs, self.device,
        )
        self._numerics_on = numerics.numerics_enabled() and type(self).supports_numerics
        split = os.environ.get("NTS_TRACE_STEP", "0") == "1"
        if split and self._numerics_on:
            log.warning(
                "NTS_TRACE_STEP=1 runs the split two-step epochs, which carry no "
                "numerics output: NTS_NUMERICS=1 emits no tensor_stats this run "
                "(drop one of the two knobs)"
            )
        start_epoch = self.ckpt_begin()
        loss = None
        if start_epoch < cfg.epochs:
            self.current_epoch = start_epoch
            self.drop_gen.manual_seed(epoch_seed(self.seed + 1, start_epoch))
            self.count_program_cost(
                f"{type(self).cost_label}/{type(self).__name__}",
                lambda: self._epoch_step(split),
                self.flat_params + self.opt_state.m + self.opt_state.v,
            )
        with contextlib.ExitStack() as trace:
            for epoch in range(start_epoch, cfg.epochs):
                if epoch == start_epoch + 1:
                    # the steady epochs, from the second one (NTS_PROFILE_DIR)
                    trace.enter_context(maybe_trace(type(self).__name__, self.device))
                self.current_epoch = epoch  # read by steps that depend on it (DepCache)
                self.drop_gen.manual_seed(epoch_seed(self.seed + 1, epoch))
                t0 = get_time()
                with self.tracer.annotate("epoch"):
                    loss, logits, stats, stages = self._epoch_step(split)
                # the stats' fetch and records stay outside the timed epoch
                emit_s = self.maybe_emit_numerics(epoch, stats)
                # chaos hook (NTS_FAULT_SPEC): before the loss reaches the
                # history, the guards or a checkpoint
                loss = fault_point("epoch_loss", epoch=epoch, value=loss)
                dt = get_time() - t0 - emit_s
                self.epoch_times.append(dt)
                self.loss_history.append(float(loss))
                self.emit_epoch(epoch, dt, loss, stages=stages)
                # per-partition hooks (the distributed trainers' liveness and
                # straggler plane): after the epoch's telemetry, before
                # ckpt_epoch_end, so a detection epoch is never saved
                self.end_of_epoch(epoch, dt, stages)
                cadence = epoch % max(1, cfg.epochs // 20) == 0 or epoch == cfg.epochs - 1
                if cadence and logits is not None:
                    h = logits.float().cpu().numpy()
                    for which in (0, 1, 2):
                        self.test(h, which)
                if cadence:
                    log.info("Epoch %d loss %f", epoch, float(loss))
                self.ckpt_epoch_end(epoch)
        self.ckpt_final()
        if os.environ.get("NTS_DEBUGINFO", "0") == "1" and type(self).supports_debuginfo:
            log.info("%s", self.debug_info())
        if self.skip_final_eval(loss):
            accs = {"train": None, "eval": None, "test": None}
        else:
            logits = self.eval_logits().float().cpu().numpy()
            accs = {
                "train": self.test(logits, 0),
                "eval": self.test(logits, 1),
                "test": self.test(logits, 2),
            }
        avg = self.avg_epoch_time()
        log.info(
            "--avg epoch time %.4f s (first %.2f s incl. compile)",
            avg, self.epoch_times[0] if self.epoch_times else 0.0,
        )
        result = {
            "loss": float(loss) if loss is not None else float("nan"),
            "acc": accs,
            "avg_epoch_s": avg,
        }
        self.finalize_metrics(result)
        return result
