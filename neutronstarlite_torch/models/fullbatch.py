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
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import torch

from neutronstarlite_torch.models.base import ToolkitBase
from neutronstarlite_torch.nn.param import AdamConfig, adam_init, adam_update
from neutronstarlite_torch.ops.aggregate import ScatterGraph
from neutronstarlite_torch.ops.blocked_ell import BlockedEllPair
from neutronstarlite_torch.ops.bsp_ell import DEFAULT_VT, BspEllPair
from neutronstarlite_torch.ops.ell import EllPair
from neutronstarlite_torch.ops.fused_edge import FusedEdgePair
from neutronstarlite_torch.utils.config import check_supported
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("fullbatch")


# every family's parameter names, in the order their tensors are flattened
PARAM_NAMES = ("W", "a", "W1", "W2", "C", "H", "Ws", "Wd")


def param_leaves(params: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """Flat list of parameter tensors, layer by layer: the named matrices in
    ``PARAM_NAMES`` order, then bn gamma, beta."""
    unknown = {k for layer in params for k in layer} - set(PARAM_NAMES) - {"bn"}
    if unknown:
        raise ValueError(f"unknown parameter names {sorted(unknown)}")
    out = []
    for layer in params:
        out += [layer[k] for k in PARAM_NAMES if k in layer]
        if "bn" in layer:
            out += [layer["bn"]["gamma"], layer["bn"]["beta"]]
    return out


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

    def adapt_ell_graph(self, compute_graph):
        """Hook: wrap or replace the OPTIM_KERNEL tables with the trainer's
        own (GAT adds its attention slot maps)."""
        return compute_graph

    def build_compute_graph(self):
        cfg, g, dev = self.cfg, self.host_graph, self.device
        resident = os.environ.get("NTS_PALLAS_RESIDENT", "0") == "1"
        check_supported(cfg, resident, type(self).supports_fused_edge)
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
        self.train01 = (self.mask == 0).to(torch.float32)
        self.drop_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        log.info("matmul precision: float32 (TF32 off), device %s", self.device)

    @torch.no_grad()
    def load_params(self, params: List[Dict[str, Any]]) -> None:
        """Overwrite the parameters (same structure and shapes) and reset
        the optimizer state."""
        new = param_leaves(params)
        if len(new) != len(self.flat_params):
            raise ValueError(
                f"expected {len(self.flat_params)} parameter tensors, got {len(new)}"
            )
        for p, q in zip(self.flat_params, new):
            if tuple(p.shape) != tuple(q.shape):
                raise ValueError(f"parameter shape {tuple(q.shape)} != {tuple(p.shape)}")
            p.copy_(q.to(p.device, p.dtype))
        self.opt_state = adam_init(self.flat_params)

    def train_step(self):
        """One epoch: returns (loss, train-mode logits), both detached."""
        for p in self.flat_params:
            p.grad = None
        logits = self.model_forward(self.params, self.compute_graph, self.feature, True)
        loss = self.masked_nll_loss(logits, self.label, self.train01)
        loss.backward()
        adam_update(
            self.flat_params, [p.grad for p in self.flat_params],
            self.opt_state, self.adam_cfg,
        )
        return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_logits(self) -> torch.Tensor:
        return self.model_forward(self.params, self.compute_graph, self.feature, False)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        log.info(
            "GNNmini::Engine[torch.%s] running [%d] Epochs on %s",
            type(self).__name__, cfg.epochs, self.device,
        )
        loss = None
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            loss, logits = self.train_step()
            self._sync()
            dt = time.perf_counter() - t0
            self.epoch_times.append(dt)
            self.loss_history.append(float(loss))
            cadence = epoch % max(1, cfg.epochs // 20) == 0 or epoch == cfg.epochs - 1
            if cadence:
                h = logits.float().cpu().numpy()
                for which in (0, 1, 2):
                    self.test(h, which)
                log.info("Epoch %d loss %f", epoch, float(loss))
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
        return {
            "loss": float(loss) if loss is not None else float("nan"),
            "acc": accs,
            "avg_epoch_s": avg,
        }
