"""Distributed GCN: vertex-sharded full-batch training — port of
``neutronstarlite_tpu/models/gcn_dist.py``.

Features, labels and masks live in the padded ``[P*vp, ...]`` vertex space
(``parallel/dist_graph.py``); parameters are replicated. Each layer's
aggregation is one of the exchanges of ``parallel/dist_ops.py``:

- ``OPTIM_KERNEL:1`` (or ``COMM_LAYER:ell``, ``DIST_PATH:all_gather``):
  all_gather + per-shard ELL tables through the ``ell_level`` kernel;
  ``KERNEL_TILE:<vt>`` takes per-shard blocked ELL tables (plain PyTorch),
  ``PALLAS:1`` per-shard rectangular bsp tables through the ``bsp_ell``
  kernel (``KERNEL_TILE`` its source tile);
- ``COMM_LAYER:ring``: the ring of P - 1 send/recv rounds.

Everything else is plain tensor code over this rank's rows: batch norm
over the valid rows only (padding rows belong to no vertex), matmul, ReLU,
dropout, and the masked NLL loss over the training rows of every shard.
With a process group of P ranks (``parallel/mesh.py``) the batch-norm
statistics and the loss's denominator are summed over the ranks, and so
are the parameters' gradients after the backward (the reference's
``all_reduce_sum``). With ``NTS_DIST_SIMULATE=1`` one process runs the
collective-free twin over all P shards; a PARTITIONS above the world size
without it is refused. Dropout draws the mask of all ``P*vp`` rows from
the epoch's generator and keeps this rank's rows, so the twin and the
ranks drop the same units.

``GCNEAGERDIST`` swaps each layer's order to NN-then-exchange, so every
exchange runs at the layer's output width. ``GINDIST`` and ``COMMNETDIST``
(``gin_dist.py``, ``commnet_dist.py``) replace the per-layer NN only.

Telemetry as in JAX: the ``dist.active_partitions`` gauge, the
``wire.comm_layer`` / ``wire.rows_per_layer`` / ``wire.bytes_per_epoch_fwd``
(and, for the all_gather family, ``wire.peak_resident_rows``) gauges, and
per epoch the ``wire.bytes_fwd`` and ``wire.exchanges`` counters and the
epoch record's ``wire_bytes_fwd``. Only rank 0 writes checkpoints.

Refused in one line, naming the slice that brings them:
``NTS_DEBUGINFO=1``, ``NTS_NUMERICS=1`` and ``NTS_ELASTIC=1`` on a
distributed trainer, ``NTS_WIRE_DTYPE`` and ``NTS_MESH`` (the pipelined
ring), and ``COMM_LAYER:auto`` at P > 1 without ``OPTIM_KERNEL:1`` (JAX
prices the mirror exchange there). ``NTS_PALLAS_RESIDENT=1`` (JAX's
interpret-only resident executor), ``SUBLINEAR:1`` and the all_gather
knobs on the ring are refused too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.models.gcn import init_gcn_params
from neutronstarlite_torch.nn.layers import batch_norm_apply, dropout, dropout_mask
from neutronstarlite_torch.ops.blocked_ell import BlockedEll
from neutronstarlite_torch.ops.bsp_ell import DEFAULT_VT, bsp_aggregate
from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.parallel.dist_blocked import build_dist_blocked
from neutronstarlite_torch.parallel.dist_bsp import build_dist_bsp
from neutronstarlite_torch.parallel.dist_ell import build_dist_ell
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import (
    GatherExchange,
    RingExchange,
    RingTables,
    dist_gather_dst_from_src,
)
from neutronstarlite_torch.tools.wire_accounting import exchange_rows_per_device
from neutronstarlite_torch.utils.config import (
    EDGE_SLICE,
    GCN_DIST_ALGORITHMS,
    GCN_EAGER_DIST_ALGORITHMS,
    PLANE_SLICE,
    RING_SLICE,
    check_supported,
)
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("gcn_dist")


def exchange_widths(eager: bool, sizes):
    """The per-layer exchange widths: each layer's input width in the
    standard order, its output width in the eager order."""
    return list(sizes[1:] if eager else sizes[:-1])


def resolve_comm_layer(cfg, P: int) -> str:
    """``ring`` or ``ell`` (the all_gather family). ``DIST_PATH:all_gather``
    and an explicit ``COMM_LAYER`` win; ``OPTIM_KERNEL:1`` means ell; one
    partition runs the ring (no wire traffic either way)."""
    if cfg.dist_path == "all_gather":
        return "ell"
    if cfg.comm_layer in ("ring", "ell"):
        return cfg.comm_layer
    if cfg.optim_kernel:
        return "ell"
    if P == 1:
        return "ring"
    raise ValueError(
        f"COMM_LAYER:auto at PARTITIONS:{P} without OPTIM_KERNEL:1 picks between "
        f"the ring and the mirror exchange, which comes with {EDGE_SLICE}: set "
        "COMM_LAYER:ring or OPTIM_KERNEL:1"
    )


def check_dist_supported(cfg) -> None:
    """The lifecycle funnel's refusals for the distributed trainers."""
    check_supported(cfg, resident=False)
    for env in ("NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_ELASTIC"):
        if os.environ.get(env, "0") == "1":
            raise ValueError(f"{env}=1 on a distributed trainer comes with {PLANE_SLICE}")
    for env in ("NTS_WIRE_DTYPE", "NTS_MESH"):
        if os.environ.get(env, ""):
            raise ValueError(f"{env} (the pipelined ring) comes with {RING_SLICE}")
    if os.environ.get("NTS_PALLAS_RESIDENT", "0") == "1":
        raise ValueError(
            "NTS_PALLAS_RESIDENT=1 selects JAX's interpret-only per-shard resident "
            "executor, which the port does not carry: OPTIM_KERNEL:1 without PALLAS "
            "already runs the ELL kernel per shard"
        )
    if cfg.sublinear:
        raise ValueError("SUBLINEAR:1 is not implemented on the distributed trainers")


@dataclasses.dataclass
class LayerCtx:
    """What a layer's NN needs besides its parameters: the compute cast,
    the masked cross-rank batch norm and the dropout of a hidden layer's
    output (its mask drawn next from the epoch's generator)."""

    cast: Callable
    bn: Callable  # (bn params, h) -> normalised h
    drop: Callable  # h -> h with dropout (identity in eval)


def gcn_layer_nn(i, n_layers, layer, agg, x_in, ctx: LayerCtx):
    """GCN's per-layer NN over the exchanged aggregate: ``agg @ W`` on the
    last layer, else ``dropout(relu(bn(agg) @ W))``."""
    agg = ctx.cast(agg)
    if i == n_layers - 1:
        return agg @ ctx.cast(layer["W"])
    if "bn" in layer:
        agg = ctx.bn(layer["bn"], agg)
    return ctx.drop(torch.relu(agg @ ctx.cast(layer["W"])))


def dist_gcn_forward(ex, params, x: torch.Tensor, layer_nn, eager: bool,
                     ctx: LayerCtx) -> torch.Tensor:
    """Logits (float32) of this rank's rows (all rows in the twin); ``ex``
    is the exchange (``parallel/dist_ops.py``)."""
    x = ctx.cast(x)
    n_layers = len(params)
    for i, layer in enumerate(params):
        if eager:
            x = dist_gather_dst_from_src(ex, layer_nn(i, n_layers, layer, x, x, ctx))
        else:
            h = dist_gather_dst_from_src(ex, x)
            x = layer_nn(i, n_layers, layer, h, x, ctx)
    return x.float()


@register_algorithm(*GCN_DIST_ALGORITHMS)
class DistGCNTrainer(FullBatchTrainer):
    """Full-batch GCN sharded over PARTITIONS ranks (or their twin)."""

    supports_optim_kernel = True
    supports_precision = True
    cost_label = "dist.train_step"
    layer_nn = staticmethod(gcn_layer_nn)
    eager = False

    def init_params(self, generator: torch.Generator):
        return init_gcn_params(self.cfg.layer_sizes(), generator)

    # ---- build ---------------------------------------------------------------
    def build_model(self) -> None:
        cfg, dev = self.cfg, self.device
        check_dist_supported(cfg)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.group, P = mesh.resolve_group(cfg.partitions, mesh.simulate_requested())
        layer_kind = resolve_comm_layer(cfg, P)
        if layer_kind == "ring" and (cfg.optim_kernel or cfg.kernel_tile):
            raise ValueError(
                "COMM_LAYER:ring runs the ring's scatter; OPTIM_KERNEL, PALLAS and "
                "KERNEL_TILE select the all_gather family's tables: drop one of the two"
            )
        self.comm_layer = layer_kind
        self.metrics.gauge_set("dist.active_partitions", P)
        self.dist = d = DistGraph.build(self.host_graph, P)
        stats, step_stats = d.padding_stats(), d.step_padding_stats()
        log.info(
            "DistGraph [P=%d vp=%d eb=%d]: %d real edges, %.2fx step-major ring padding "
            "(uniform layout would be %.2fx; max block %d, mean %.0f)%s",
            P, d.vp, d.eb, stats["real_edges"], step_stats["waste_ratio"],
            stats["waste_ratio"], stats["max_block"], stats["mean_block"],
            " (sim twin, one process)" if self.group is None
            else f" (rank {self.group.rank} of {self.group.world})",
        )
        shards = range(P) if self.group is None else [self.group.rank]
        if layer_kind == "ring":
            self.compute_graph = RingExchange(RingTables.build(d, shards, dev), self.group)
            log.info("COMM_LAYER ring: %d send/recv rounds per exchange", P - 1)
        else:
            if cfg.pallas_kernel:
                vt = cfg.kernel_tile or DEFAULT_VT
                tables, kernel = build_dist_bsp(d, shards, vt=vt, device=dev), bsp_aggregate
                name, what = "bsp_ell", f"bsp kernel per shard (vt={vt})"
            elif cfg.kernel_tile > 0:
                tables = build_dist_blocked(d, shards, cfg.kernel_tile, device=dev)
                kernel, name = BlockedEll.aggregate, None
                what = f"blocked ELL per shard (vt={cfg.kernel_tile})"
            else:
                tables, kernel = build_dist_ell(d, shards, device=dev), ell_level_aggregate
                name, what = "ell_level", "ELL kernel per shard"
            est = tables.padding_stats(stats["real_edges"])
            self.compute_graph = GatherExchange(tables, kernel, self.group, name)
            log.info(
                "OPTIM_KERNEL: dist all_gather aggregation (%s over [%d, %d] rectangular "
                "tables, %.2fx/%.2fx fwd/bwd slot padding)", what, d.vp, P * d.vp,
                est["fwd_waste_ratio"], est["bwd_waste_ratio"],
            )
        self._set_wire_gauges(layer_kind, P)

        # this rank's rows of the padded vertex space (all of them in the twin)
        self._rows = (slice(None) if self.group is None
                      else slice(self.group.rank * d.vp, (self.group.rank + 1) * d.vp))
        pad, rows = d.pad_vertex_array, self._rows
        self.feature = torch.from_numpy(pad(self.datum.feature)[rows]).to(dev)
        self._label_np = pad(self.datum.label.astype(np.int64))[rows]
        self._mask_np = pad(self.datum.mask, fill=-1)[rows]  # -1: no split
        self.label = torch.from_numpy(self._label_np).to(dev)
        self.valid = torch.from_numpy(d.valid_mask()[rows]).to(dev)
        self.train01 = torch.from_numpy(
            pad((self.datum.mask == 0).astype(np.float32))[rows]).to(dev)
        n_train = self.train01.sum()
        self._train_count = torch.clamp(
            n_train if self.group is None else self.group.sum_(n_train), min=1.0)
        self.init_model()
        log.info("matmul precision: float32 (TF32 off), device %s", dev)

    def _set_wire_gauges(self, layer_kind: str, P: int) -> None:
        cfg, vp = self.cfg, self.dist.vp
        rows = exchange_rows_per_device(P, vp)
        widths = exchange_widths(type(self).eager, cfg.layer_sizes())
        itemsize = 2 if cfg.precision == "bfloat16" else 4
        self._wire_exchanges_per_epoch = len(widths)
        self._wire_bytes_fwd_per_epoch = rows * sum(widths) * itemsize
        m = self.metrics
        m.gauge_set("wire.comm_layer", layer_kind)
        m.gauge_set("wire.rows_per_layer", rows)
        m.gauge_set("wire.bytes_per_epoch_fwd", self._wire_bytes_fwd_per_epoch)
        if layer_kind == "ell":
            m.gauge_set("wire.peak_resident_rows", P * vp)

    # ---- the step --------------------------------------------------------------
    def _layer_ctx(self, train: bool) -> LayerCtx:
        bf16 = self.cfg.precision == "bfloat16"

        def cast(a):
            return a.to(torch.bfloat16) if bf16 else a

        reduce = self.group.sum if self.group is not None else None
        rate = self.cfg.drop_rate if train else 0.0
        P, vp = self.dist.partitions, self.dist.vp

        def bn(p, h):
            return batch_norm_apply({k: cast(v) for k, v in p.items()}, h,
                                    valid_mask=self.valid, reduce=reduce)

        def drop(h):
            mask = dropout_mask((P * vp, h.shape[1]), rate, self.drop_gen)
            return dropout(h, mask if mask is None else mask[self._rows], rate)

        return LayerCtx(cast=cast, bn=bn, drop=drop)

    def model_forward(self, params, graph, x, train: bool):
        return dist_gcn_forward(graph, params, x, type(self).layer_nn, type(self).eager,
                                self._layer_ctx(train))

    def masked_nll_loss(self, logits, label, mask01):
        """This rank's share of the loss: its training rows' NLL over the
        training rows of every rank."""
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(1, label[:, None])[:, 0]
        return -(picked * mask01).sum() / self._train_count

    def _forward_backward(self):
        loss, logits = super()._forward_backward()
        if self.group is not None:
            grads = [p.grad for p in self.flat_params]
            flat = self.group.sum_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            loss = self.group.sum_(loss.clone())
        return loss, logits

    # ---- reporting ---------------------------------------------------------------
    def emit_epoch(self, epoch, seconds, loss=None, stages=None, **extra):
        """The epoch record plus the live wire counters (JAX's
        ``record_epoch_wire``)."""
        self.metrics.counter_add("wire.bytes_fwd", self._wire_bytes_fwd_per_epoch)
        self.metrics.counter_add("wire.exchanges", self._wire_exchanges_per_epoch)
        return super().emit_epoch(epoch, seconds, loss, stages=stages,
                                  wire_bytes_fwd=self._wire_bytes_fwd_per_epoch, **extra)

    def test(self, logits: np.ndarray, which: int) -> float:
        """Accuracy over mask class ``which`` of every rank's rows (padding
        rows belong to no split)."""
        sel = self._mask_np == which
        counts = torch.tensor(
            [float((logits[sel].argmax(axis=1) == self._label_np[sel]).sum()),
             float(sel.sum())], dtype=torch.float64)
        if self.group is not None:
            counts = self.group.sum_(counts.to(self.device)).cpu()
        correct, n = int(counts[0]), int(counts[1])
        acc = correct / n if n else 0.0
        name = {0: "Train", 1: "Eval", 2: "Test"}[which]
        log.info("%s Acc: %f %d %d", name, acc, n, correct)
        return acc

    def save(self, path: str, epoch: int) -> None:
        """The parameters are replicated: rank 0 writes the checkpoint."""
        if self.group is None or self.group.rank == 0:
            super().save(path, epoch)


@register_algorithm(*GCN_EAGER_DIST_ALGORITHMS)
class DistGCNEagerTrainer(DistGCNTrainer):
    """The reference's distributed eager GCN: per layer, NN first, then the
    exchange, which runs at the layer's output width."""

    eager = True
