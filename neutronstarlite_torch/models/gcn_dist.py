"""Distributed GCN: vertex-sharded full-batch training — port of
``neutronstarlite_tpu/models/gcn_dist.py``.

Features, labels and masks live in the padded ``[P*vp, ...]`` vertex space
(``parallel/dist_graph.py``); parameters are replicated. Each layer's
aggregation is one of the exchanges of ``parallel/``:

- ``OPTIM_KERNEL:1`` (or ``COMM_LAYER:ell``, ``DIST_PATH:all_gather``):
  all_gather + per-shard ELL tables through the ``ell_level`` kernel;
  ``KERNEL_TILE:<vt>`` takes per-shard blocked ELL tables (plain PyTorch),
  ``PALLAS:1`` per-shard rectangular bsp tables through the ``bsp_ell``
  kernel (``KERNEL_TILE`` its source tile) (``dist_ops.GatherExchange``);
- ``COMM_LAYER:ring``: the ring of P - 1 send/recv rounds
  (``dist_ops.RingExchange``);
- ``DIST_PATH:ring_blocked`` (``ring_blocked_sim`` forces the twin): the
  pipelined ring over blocked step tables (``dist_ring_blocked.py``),
  ``KERNEL_TILE`` its source tile (default ``min(vp, 512)``), with the
  wire dtype of ``WIRE_DTYPE`` / ``NTS_WIRE_DTYPE``; ``PALLAS:1`` is
  ignored there with JAX's warning (the step tables are plain PyTorch);
- ``MESH:Pv,Pf`` (``NTS_MESH``): the same ring on the 2D mesh of
  ``parallel/partitioner.py`` (see its docstring for the slab layout and
  the gradient rule);
- ``COMM_LAYER:mirror``: the split mirror's one all_to_all
  (``dist_edge_ops.py``);
- ``COMM_LAYER:auto`` at P > 1 without ``OPTIM_KERNEL:1`` takes the
  mirror when its remote slots per pair ``mb`` (``SplitMirror.
  estimate_mb_remote``) are at most the ring's ``vp``, else the ring, as
  JAX does.

None of these paths runs a hand-written kernel but the all_gather
family's: JAX's ring step is XLA's blocked scan and its mirror segment
sums.

Everything else is plain tensor code over this rank's rows: batch norm
over the valid rows only (padding rows belong to no vertex), matmul, ReLU,
dropout, and the masked NLL loss over the training rows of every shard.
With a process group of P ranks (``parallel/mesh.py``) the batch-norm
statistics and the loss's denominator are summed over the vertex ranks,
and the parameters' gradients and the loss over every rank after the
backward (the reference's ``all_reduce_sum``). With ``NTS_DIST_SIMULATE=1``
one process runs the collective-free twin over all P shards; a PARTITIONS
(or ``Pv*Pf``) above the world size without it (or ``ring_blocked_sim``)
is refused. Dropout draws the mask of all ``P*vp`` rows from the epoch's
generator and keeps this rank's rows, so the twin and the ranks drop the
same units.

``GCNEAGERDIST`` swaps each layer's order to NN-then-exchange, so every
exchange runs at the layer's output width. ``GINDIST`` and ``COMMNETDIST``
(``gin_dist.py``, ``commnet_dist.py``) replace the per-layer NN only.

Telemetry as in JAX: the ``dist.active_partitions`` gauge, the
``wire.comm_layer`` / ``wire.rows_per_layer`` / ``wire.bytes_per_epoch_fwd``
gauges (``wire.peak_resident_rows`` on the all_gather family and the
pipelined ring), per epoch the ``wire.bytes_fwd`` and ``wire.exchanges``
counters and the epoch record's ``wire_bytes_fwd``. The pipelined ring
adds ``ring.transfers``, ``ring.skipped_steps``,
``wire.peak_resident_feature_bytes`` (and on a mesh ``mesh.shape``,
``mesh.pv``, ``mesh.pf``, ``mesh.devices``, ``mesh.slab_cols``) and one
``ring_step`` record per hop per epoch (``ring_wire_plan``);
``NTS_OVERLAP_PROBE=1`` measures the ring's overlap once before the
epochs (the ``ring.probe_*`` gauges and a ``ring_overlap_probe`` span; a
failure is logged, as in JAX). Only world rank 0 writes checkpoints,
which hold the unpadded parameters, so a 2D checkpoint restores into any
layout.

``DIST_PATH:auto``, ``WIRE_DTYPE:auto``, ``MESH:auto`` (and ``NTS_MESH=auto``)
are the autotuner's (``tune/``): resolved at the head of the funnel under
``NTS_TUNE``; with the tuner off ``DIST_PATH:auto`` keeps its legacy
meaning (the ``COMM_LAYER`` rule below) and the other two are refused.

The distributed plane around the step, in JAX's order per epoch (the
``end_of_epoch`` hook, after the epoch's records, before its checkpoint):

- ``NTS_ELASTIC=1`` (resilience/elastic): one ``LivenessMonitor`` per
  attempt; for each live partition the ``partition_step`` fault point
  runs, and that partition's seconds are the epoch's plus what its point
  added; then the straggler detector (obs/skew; armed with elastic, or by
  ``NTS_STRAGGLER=1``) observes the epoch, then the monitor takes the
  heartbeats (dead sim partitions skipped) and may raise ``rank_loss``,
  which the supervisor answers with the survivor replan. GCNDIST,
  GCNEAGERDIST, GINDIST and COMMNETDIST carry it (``supports_elastic``);
  the mirror family refuses it, as JAX does;
- ``NTS_NUMERICS=1``: the stats step, through the per-layer ``tap`` of
  ``dist_gcn_forward`` (activations), with the new parameters, the grads,
  the logits and, on a narrowed wire, the layer-0 payload at the wire
  dtype; ``numerics_replay`` walks the same tap for the non-finite
  provenance;
- ``NTS_QUANT_PROBE=1`` on a narrowed wire (``WIRE_DTYPE:bf16``): the
  layer-0 payload measured once (``ring_schedule.payload_quant_probe``),
  the cached verdict re-emitted each epoch;
- ``NTS_DEBUGINFO=1``: the report with the nn / graph split, the nn-only
  forward being ``dist_gcn_forward`` with the exchange disabled.

``NTS_PALLAS_RESIDENT=1`` (JAX's interpret-only resident executor),
``SUBLINEAR:1`` and the all_gather knobs on the ring and the mirror are
refused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.obs import numerics, skew
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.models.gcn import init_gcn_params
from neutronstarlite_torch.nn.layers import batch_norm_apply, dropout, dropout_mask
from neutronstarlite_torch.nn.param import adam_init, param_leaves
from neutronstarlite_torch.ops.blocked_ell import BlockedEll
from neutronstarlite_torch.ops.bsp_ell import DEFAULT_VT, bsp_aggregate
from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.parallel import partitioner as pmod
from neutronstarlite_torch.parallel.dist_blocked import build_dist_blocked
from neutronstarlite_torch.parallel.dist_bsp import build_dist_bsp
from neutronstarlite_torch.parallel.dist_edge_ops import SplitMirrorExchange
from neutronstarlite_torch.parallel.dist_ell import build_dist_ell
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import (
    GatherExchange,
    RingExchange,
    RingTables,
    dist_gather_dst_from_src,
)
from neutronstarlite_torch.parallel.dist_ring_blocked import (
    RingBlockedExchange,
    RingBlockedPair,
    default_ring_vt,
    measure_overlap,
    ring_wire_plan,
)
from neutronstarlite_torch.parallel.mirror import SplitMirror
from neutronstarlite_torch.parallel.ring_schedule import payload_quant_probe, resolve_wire_dtype
from neutronstarlite_torch.resilience import elastic
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.tools.wire_accounting import exchange_rows_per_device
from neutronstarlite_torch.utils.config import (
    GCN_DIST_ALGORITHMS,
    GCN_EAGER_DIST_ALGORITHMS,
    check_supported,
    check_wire_dtype,
)
from neutronstarlite_torch.utils.logging import get_logger
from neutronstarlite_torch.utils.timing import get_time

log = get_logger("gcn_dist")


def exchange_widths(eager: bool, sizes):
    """The per-layer exchange widths: each layer's input width in the
    standard order, its output width in the eager order."""
    return list(sizes[1:] if eager else sizes[:-1])


def resolve_comm_layer(cfg, host_graph, P: int) -> str:
    """``ring``, ``ell`` (the all_gather family) or ``mirror``.
    ``DIST_PATH:all_gather`` and an explicit ``COMM_LAYER`` win;
    ``OPTIM_KERNEL:1`` means ell; one partition runs the ring (no wire
    traffic either way); else the mirror when its remote slots per pair
    are at most the ring's shard rows (a tie goes to the mirror)."""
    if cfg.dist_path == "all_gather":
        return "ell"
    if cfg.comm_layer in ("ring", "ell", "mirror"):
        return cfg.comm_layer
    if cfg.optim_kernel:
        return "ell"
    if P == 1:
        return "ring"
    mb, vp = SplitMirror.estimate_mb_remote(host_graph, P)
    choice = "mirror" if mb <= vp else "ring"
    log.info("COMM_LAYER auto -> %s (mirror Mb=%d vs ring vp=%d wire rows/remote "
             "chunk/layer)", choice, mb, vp)
    return choice


def check_dist_supported(cfg, supports_fused_edge: bool = False) -> None:
    """The lifecycle funnel's refusals for the distributed trainers."""
    check_supported(cfg, resident=False, supports_fused_edge=supports_fused_edge)
    env_wire = os.environ.get("NTS_WIRE_DTYPE", "").strip().lower()
    if env_wire == "auto":
        raise ValueError(
            "NTS_WIRE_DTYPE must be f32/float32 or bf16/bfloat16 (or empty): the "
            "autotuner resolves WIRE_DTYPE:auto from the cfg, not from the env")
    check_wire_dtype(env_wire)
    pmod.fold_mesh_env(cfg)
    pmod.check_mesh_cfg(cfg)
    if os.environ.get("NTS_PALLAS_RESIDENT", "0") == "1":
        raise ValueError(
            "NTS_PALLAS_RESIDENT=1 selects JAX's interpret-only per-shard resident "
            "executor, which the port does not carry: OPTIM_KERNEL:1 without PALLAS "
            "already runs the ELL kernel per shard"
        )
    if cfg.sublinear:
        raise ValueError("SUBLINEAR:1 is not implemented on the distributed trainers")


def check_mirror_knobs(cfg, what: str, ring: bool = False) -> None:
    """The uniform mirror family's selectors. It runs one exchange, so the
    dense family's selectors, which it would ignore, are refused: MESH, a
    COMM_LAYER other than mirror, a DIST_PATH (but the ring family when
    ``ring``: ``KERNEL:fused_edge`` runs on the ring) and KERNEL_TILE (but
    the ring's source tile). ``OPTIM_KERNEL``/``PALLAS``, which the
    reference's own GAT dist cfgs set and JAX ignores, and ``WIRE_DTYPE``
    warn instead."""
    if cfg.mesh:
        raise ValueError(
            f"MESH:{cfg.mesh} is not available for ALGORITHM {cfg.algorithm!r}: the 2D "
            "(vertex x feature) mesh serves the fuse-op dist family (GCNDIST / GINDIST / "
            "COMMNETDIST and their eager variants)")
    if cfg.comm_layer not in ("", "auto", "mirror"):
        raise ValueError(
            f"COMM_LAYER:{cfg.comm_layer} is not available for ALGORITHM "
            f"{cfg.algorithm!r}: {what} runs the uniform mirror exchange")
    if ring:
        if cfg.dist_path not in ("", "auto", "ring_blocked", "ring_blocked_sim"):
            raise ValueError(
                f"DIST_PATH:{cfg.dist_path} is not available with KERNEL:fused_edge: the "
                "fused edge kernel runs the ring schedule (ring_blocked / ring_blocked_sim)")
    elif cfg.dist_path not in ("", "auto"):
        raise ValueError(
            f"DIST_PATH:{cfg.dist_path} is not available for ALGORITHM {cfg.algorithm!r}: "
            "DIST_PATH selects the dense-feature dist aggregation path and serves the "
            "fuse-op dist family (GCNDIST / GINDIST / COMMNETDIST and their eager "
            "variants)")
    elif cfg.kernel_tile:
        raise ValueError(
            f"KERNEL_TILE sets the fused ring's source tile; {what} of ALGORITHM "
            f"{cfg.algorithm!r} has none: drop it")
    if cfg.optim_kernel or cfg.pallas_kernel:
        log.warning("OPTIM_KERNEL/PALLAS select the all_gather family's tables; ALGORITHM "
                    "%s (%s) ignores them, as JAX does", cfg.algorithm, what)
    if cfg.wire_dtype or os.environ.get("NTS_WIRE_DTYPE"):
        log.warning("WIRE_DTYPE/NTS_WIRE_DTYPE is ignored by %s: the payload ships the "
                    "compute dtype (PRECISION:bfloat16 halves it)", what)


@dataclasses.dataclass
class LayerCtx:
    """What a layer's NN needs besides its parameters: the compute cast,
    the masked cross-rank batch norm (``slab=True`` on an exchange's
    output), the dropout of a hidden layer's output (its mask drawn next
    from the epoch's generator) and the 2D mesh's ``contract``,
    ``scatter`` and ``gather`` (``parallel/partitioner.py``; a matmul and
    identities on the 1D layout). ``out_width`` is the last layer's."""

    cast: Callable
    bn: Callable  # (bn params, h, slab=False) -> normalised h
    drop: Callable  # h -> h with dropout (identity in eval)
    contract: Callable = lambda a, w: a @ w
    scatter: Callable = lambda x: x
    gather: Callable = lambda x, width: x
    out_width: int = 0


def gcn_layer_nn(i, n_layers, layer, agg, x_in, ctx: LayerCtx):
    """GCN's per-layer NN over the exchanged aggregate: ``agg @ W`` on the
    last layer, else ``dropout(relu(bn(agg) @ W))``."""
    agg = ctx.cast(agg)
    if i == n_layers - 1:
        return ctx.contract(agg, ctx.cast(layer["W"]))
    if "bn" in layer:
        agg = ctx.bn(layer["bn"], agg, slab=True)
    return ctx.drop(torch.relu(ctx.contract(agg, ctx.cast(layer["W"]))))


def dist_gcn_forward(ex, params, x: torch.Tensor, layer_nn, eager: bool,
                     ctx: LayerCtx, tap=None, no_exchange: bool = False) -> torch.Tensor:
    """Logits (float32) of this rank's rows (all rows in the twin); ``ex``
    is the exchange. On the 2D mesh's ranks every exchange and every
    layer NN reads slabs (``ctx.scatter`` cuts the replicated outputs of
    the contractions) and the eager order's last exchange is put back
    together (``ctx.gather``). ``tap(i, x) -> x`` sees each layer's output
    (the numerics plane); ``no_exchange`` replaces the exchange by the
    identity (DEBUGINFO's nn-only forward: the same widths and matmuls)."""

    def exchange(v):
        return v if no_exchange else dist_gather_dst_from_src(ex, v)

    x = ctx.cast(x)
    n_layers = len(params)
    for i, layer in enumerate(params):
        if eager:
            y = layer_nn(i, n_layers, layer, x, x, ctx)
            x = exchange(ctx.scatter(y))
        else:
            xs = x if i == 0 else ctx.scatter(x)
            h = exchange(xs)
            x = layer_nn(i, n_layers, layer, h, xs, ctx)
        if tap is not None:
            x = tap(i, x)
    if eager:
        x = ctx.gather(x, ctx.out_width)
    return x.float()


@register_algorithm(*GCN_DIST_ALGORITHMS)
class DistGCNTrainer(FullBatchTrainer):
    """Full-batch GCN sharded over PARTITIONS ranks (or their twin)."""

    supports_optim_kernel = True
    supports_precision = True
    needs_device_graph = False
    supports_dist_path = True  # DIST_PATH, WIRE_DTYPE and MESH
    supports_elastic = True  # NTS_ELASTIC=1: liveness + survivor replan
    cost_label = "dist.train_step"
    # the per-attempt liveness monitor and straggler detector (run) and the
    # quantisation probe (build_model); None when not armed
    _liveness = None
    _straggler = None
    _quant_probe = None
    layer_nn = staticmethod(gcn_layer_nn)
    eager = False
    # layer 0's parameters that carry the input-feature dim (the 2D mesh pads
    # them to a multiple of Pf); GIN and CommNet name theirs
    mesh_pad_keys = ("W", "bn")

    def init_params(self, generator: torch.Generator):
        return init_gcn_params(self.cfg.layer_sizes(), generator)

    @classmethod
    def check_cfg(cls, cfg) -> None:
        check_dist_supported(cfg)

    # ---- build ---------------------------------------------------------------
    def build_model(self) -> None:
        cfg, dev = self.cfg, self.device
        type(self).check_cfg(cfg)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec = pmod.mesh_spec_of(cfg)
        self.mesh_spec, self.partitioner = spec, None
        self.wire_dtype, self._ring_plan = None, None
        ring_sim = mesh.simulate_requested() or cfg.dist_path == "ring_blocked_sim"
        if spec is not None:
            self.partitioner = part = pmod.Partitioner.build(spec, ring_sim)
            grid = part.grid
            self.group = grid.vertex if grid is not None else None
            self.world = grid.world if grid is not None else None
            P, layer_kind = spec.pv, "ring_blocked"
        else:
            if cfg.dist_path in ("ring_blocked", "ring_blocked_sim"):
                self.group, P = mesh.resolve_group(cfg.partitions, ring_sim)
                layer_kind = "ring_blocked"
            else:
                self.group, P = mesh.resolve_group(cfg.partitions, mesh.simulate_requested())
                layer_kind = resolve_comm_layer(cfg, self.host_graph, P)
                if cfg.wire_dtype or os.environ.get("NTS_WIRE_DTYPE"):
                    log.warning(
                        "WIRE_DTYPE/NTS_WIRE_DTYPE only applies to DIST_PATH:ring_blocked; "
                        "the %s exchange ships the compute dtype (use PRECISION:bfloat16 "
                        "to narrow it)", layer_kind,
                    )
            self.world = self.group
        if layer_kind in ("ring", "mirror") and (cfg.optim_kernel or cfg.kernel_tile):
            raise ValueError(
                f"COMM_LAYER:{layer_kind} runs its own exchange; OPTIM_KERNEL, PALLAS and "
                "KERNEL_TILE select the all_gather family's tables: drop one of the two"
            )
        self.comm_layer = layer_kind
        self.metrics.gauge_set("dist.active_partitions", P)
        where = (" (sim twin, one process)" if self.group is None
                 else f" (rank {self.group.rank} of {self.group.world})")
        shards = range(P) if self.group is None else [self.group.rank]
        if layer_kind == "mirror":
            self.dist = sm = SplitMirror.build(self.host_graph, P)
            self.compute_graph = SplitMirrorExchange(sm, self.group, dev)
            log.info(
                "COMM_LAYER mirror (split): remote-only all_to_all (mb=%d remote slots/pair "
                "vs vp=%d shard rows; Er=%d remote + El=%d resident edges)%s",
                sm.mb, sm.vp, sm.er, sm.el, where,
            )
        elif layer_kind == "ring_blocked":
            if cfg.pallas_kernel:
                log.warning(
                    "PALLAS:1 ignored: DIST_PATH:ring_blocked runs the blocked step tables "
                    "in plain PyTorch (no hand-written ring kernel)"
                )
            self.dist = d = DistGraph.build(self.host_graph, P)
            vt = default_ring_vt(d.vp, cfg.kernel_tile)
            pair = RingBlockedPair.build(d, vt, shards, device=dev)
            self.wire_dtype = resolve_wire_dtype(cfg.wire_dtype)
            self.compute_graph = RingBlockedExchange(pair, self.group, self.wire_dtype)
            est = pair.padding_stats()
            log.info(
                "DIST_PATH ring_blocked%s: double-buffered ring (vt=%d, %d/%d work steps, "
                "%d hops, wire dtype %s, %.2fx/%.2fx fwd/bwd slot padding; peak exchange "
                "residency 2*vp=%d rows vs all_gather P*vp=%d)%s%s",
                " (sim)" if self.group is None else "", vt, len(pair.fwd.work_steps()), P,
                pair.fwd.n_transfers(), self.wire_dtype or "compute",
                est["fwd_waste_ratio"], est["bwd_waste_ratio"], 2 * d.vp, P * d.vp,
                f" on mesh {spec.label()}" if spec is not None else "", where,
            )
        else:
            self.dist = d = DistGraph.build(self.host_graph, P)
            stats, step_stats = d.padding_stats(), d.step_padding_stats()
            log.info(
                "DistGraph [P=%d vp=%d eb=%d]: %d real edges, %.2fx step-major ring padding "
                "(uniform layout would be %.2fx; max block %d, mean %.0f)%s",
                P, d.vp, d.eb, stats["real_edges"], step_stats["waste_ratio"],
                stats["waste_ratio"], stats["max_block"], stats["mean_block"], where,
            )
            if layer_kind == "ring":
                self.compute_graph = RingExchange(RingTables.build(d, shards, dev), self.group)
                log.info("COMM_LAYER ring: %d send/recv rounds per exchange", P - 1)
            else:
                self._build_gather(d, P, shards, stats["real_edges"])
        self._set_wire_gauges(layer_kind, P)
        self._place_rows()
        # NTS_QUANT_PROBE=1 on a narrowed wire: measured once per plan
        self._quant_probe = (payload_quant_probe(self.wire_dtype)
                             if self.wire_dtype is not None and numerics.quant_probe_enabled()
                             else None)
        self._quant_probe_stats = None

    def _place_rows(self) -> None:
        """This rank's rows of the padded vertex space (all of them in the
        twin): features, labels, masks, the valid rows and the training
        rows' count over every rank; then the model. ``self.dist`` is the
        layout (any ``PaddedVertexSpace``)."""
        dev = self.device
        vp = self.dist.vp
        self._rows = (slice(None) if self.group is None
                      else slice(self.group.rank * vp, (self.group.rank + 1) * vp))
        pad, rows = self.dist.pad_vertex_array, self._rows
        feat = pad(self.datum.feature)[rows]
        if self.partitioner is not None:
            feat = pmod.pad_feature_cols(feat, self.partitioner.pf)
            if self.partitioner.slabbed:
                feat = feat[:, self.partitioner.slab_cols(feat.shape[1])]
        self.feature = torch.from_numpy(np.ascontiguousarray(feat)).to(dev)
        self._label_np = pad(self.datum.label.astype(np.int64))[rows]
        self._mask_np = pad(self.datum.mask, fill=-1)[rows]  # -1: no split
        self.label = torch.from_numpy(self._label_np).to(dev)
        self.valid = torch.from_numpy(self.dist.valid_mask()[rows]).to(dev)
        self.train01 = torch.from_numpy(
            pad((self.datum.mask == 0).astype(np.float32))[rows]).to(dev)
        n_train = self.train01.sum()
        self._train_count = torch.clamp(
            n_train if self.group is None else self.group.sum_(n_train), min=1.0)
        self.init_model()
        log.info("matmul precision: float32 (TF32 off), device %s", dev)

    def _build_gather(self, d: DistGraph, P: int, shards, real_edges: int) -> None:
        """The all_gather family's per-shard tables and kernel."""
        cfg, dev = self.cfg, self.device
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
        est = tables.padding_stats(real_edges)
        self.compute_graph = GatherExchange(tables, kernel, self.group, name)
        log.info(
            "OPTIM_KERNEL: dist all_gather aggregation (%s over [%d, %d] rectangular "
            "tables, %.2fx/%.2fx fwd/bwd slot padding)", what, d.vp, P * d.vp,
            est["fwd_waste_ratio"], est["bwd_waste_ratio"],
        )

    def _set_wire_gauges(self, layer_kind: str, P: int) -> None:
        cfg, vp = self.cfg, self.dist.vp
        rows = exchange_rows_per_device(layer_kind, P, vp, getattr(self.dist, "mb", 0))
        widths = exchange_widths(type(self).eager, cfg.layer_sizes())
        itemsize = 2 if cfg.precision == "bfloat16" else 4
        if self.wire_dtype is not None:
            itemsize = self.wire_dtype.itemsize  # the wire's own dtype prices it
        self._wire_exchanges_per_epoch = len(widths)
        self._wire_bytes_fwd_per_epoch = rows * sum(widths) * itemsize
        m = self.metrics
        m.gauge_set("wire.comm_layer", layer_kind)
        m.gauge_set("wire.rows_per_layer", rows)
        m.gauge_set("wire.bytes_per_epoch_fwd", self._wire_bytes_fwd_per_epoch)
        if layer_kind == "ring_blocked":
            spec = self.mesh_spec
            plan = self._ring_plan = ring_wire_plan(
                self.compute_graph.tables.fwd, widths, itemsize,
                pf=spec.pf if spec is not None else 1)
            # a trimmed skip suffix ships fewer hops than (P-1)*vp prices
            self._wire_bytes_fwd_per_epoch = sum(s["bytes"] for s in plan["steps"])
            m.gauge_set("wire.rows_per_layer", plan["transfers"] * vp)
            m.gauge_set("wire.bytes_per_epoch_fwd", self._wire_bytes_fwd_per_epoch)
            m.gauge_set("wire.peak_resident_rows", plan["peak_resident_rows"])
            m.gauge_set("ring.skipped_steps", len(plan["skipped_steps"]))
            m.gauge_set("ring.transfers", plan["transfers"])
            m.gauge_set("wire.peak_resident_feature_bytes",
                        plan["peak_resident_feature_bytes"])
            if spec is not None:
                m.gauge_set("mesh.shape", spec.label())
                m.gauge_set("mesh.pv", spec.pv)
                m.gauge_set("mesh.pf", spec.pf)
                m.gauge_set("mesh.devices", spec.devices)
                m.gauge_set("mesh.slab_cols", plan["slab_cols"])
        elif layer_kind == "ell":
            m.gauge_set("wire.peak_resident_rows", P * vp)

    # ---- parameters: the 2D mesh's feature padding ------------------------------
    def _mesh_pad_dims(self):
        """(fin, pf) when the parameters carry the mesh's feature padding."""
        part = getattr(self, "partitioner", None)
        if part is None:
            return None
        fin = self.cfg.layer_sizes()[0]
        if pmod.padded_width(fin, part.pf) == fin:
            return None
        return fin, part.pf

    def init_model(self) -> None:
        super().init_model()
        dims = self._mesh_pad_dims()
        if dims is None:
            return
        # zero rows meet the zero feature columns: the padded model trains
        # the unpadded math on the real coordinates
        with torch.no_grad():
            self.params = pmod.pad_params_feature_dim(
                self.params, type(self).mesh_pad_keys, *dims)
        self.flat_params = param_leaves(self.params)
        for p in self.flat_params:
            p.requires_grad_(True)
        self.opt_state = adam_init(self.flat_params)

    def checkpoint_state(self):
        """The unpadded parameters and Adam moments, so a checkpoint
        restores into any mesh layout."""
        state = super().checkpoint_state()
        dims = self._mesh_pad_dims()
        if dims is None:
            return state
        keys = type(self).mesh_pad_keys
        opt = state["opt"]
        return {"params": pmod.unpad_params_feature_dim(state["params"], keys, *dims),
                "opt": dataclasses.replace(
                    opt, m=pmod.unpad_params_feature_dim(opt.m, keys, *dims),
                    v=pmod.unpad_params_feature_dim(opt.v, keys, *dims))}

    def _apply_restored(self, state) -> None:
        dims = self._mesh_pad_dims()
        if dims is not None:
            keys = type(self).mesh_pad_keys
            opt = state["opt"]
            state = {"params": pmod.pad_params_feature_dim(state["params"], keys, *dims),
                     "opt": dataclasses.replace(
                         opt, m=pmod.pad_params_feature_dim(opt.m, keys, *dims),
                         v=pmod.pad_params_feature_dim(opt.v, keys, *dims))}
        super()._apply_restored(state)

    # ---- the step --------------------------------------------------------------
    def _layer_ctx(self, train: bool) -> LayerCtx:
        bf16 = self.cfg.precision == "bfloat16" and type(self).supports_precision

        def cast(a):
            return a.to(torch.bfloat16) if bf16 else a

        reduce = self.group.sum if self.group is not None else None
        rate = self.cfg.drop_rate if train else 0.0
        P, vp = self.dist.partitions, self.dist.vp
        part = self.partitioner

        def bn(p, h, slab=False):
            if slab and part is not None:
                p = {k: part.slab_vector(v) for k, v in p.items()}
            return batch_norm_apply({k: cast(v) for k, v in p.items()}, h,
                                    valid_mask=self.valid, reduce=reduce)

        def drop(h):
            mask = dropout_mask((P * vp, h.shape[1]), rate, self.drop_gen)
            return dropout(h, mask if mask is None else mask[self._rows], rate)

        ctx = LayerCtx(cast=cast, bn=bn, drop=drop,
                       out_width=self.cfg.layer_sizes()[-1])
        if part is not None:
            ctx.contract, ctx.scatter, ctx.gather = part.contract, part.scatter, part.gather
        return ctx

    def model_forward(self, params, graph, x, train: bool):
        return dist_gcn_forward(graph, params, x, type(self).layer_nn, type(self).eager,
                                self._layer_ctx(train))

    def forward_taped(self, params, graph, x, tap, train: bool = True):
        return dist_gcn_forward(graph, params, x, type(self).layer_nn, type(self).eager,
                                self._layer_ctx(train), tap=tap)

    def nn_only_forward(self, train: bool = True):
        return dist_gcn_forward(self.compute_graph, self.params, self.feature,
                                type(self).layer_nn, type(self).eager, self._layer_ctx(train),
                                no_exchange=True)

    def masked_nll_loss(self, logits, label, mask01):
        """This rank's share of the loss: its training rows' NLL over the
        training rows of every vertex shard (and, on a 2D mesh's ranks,
        over the Pf ranks that hold the same rows)."""
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(1, label[:, None])[:, 0]
        loss = -(picked * mask01).sum() / self._train_count
        if self.partitioner is not None and self.partitioner.slabbed:
            loss = loss / self.partitioner.pf
        return loss

    def _forward_backward(self, tap=None):
        loss, logits = super()._forward_backward(tap)
        if self.world is not None:
            grads = [p.grad for p in self.flat_params]
            flat = self.world.sum_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            loss = self.world.sum_(loss.clone())
        return loss, logits

    def run(self):
        elastic_on = elastic.elastic_enabled() and type(self).supports_elastic
        P = self.dist.partitions
        # one monitor per attempt: a retry, or a replan (which renumbers the
        # survivors), starts with fresh miss counts for its plan
        self._liveness = elastic.LivenessMonitor(P) if elastic_on else None
        self._straggler = (
            skew.StragglerDetector(P, registry=self.metrics,
                                   on_straggler=elastic.note_straggler)
            if type(self).supports_elastic and skew.straggler_enabled(default=elastic_on)
            else None)
        if self._ring_plan is not None and os.environ.get("NTS_OVERLAP_PROBE", "0") == "1":
            try:
                self._run_overlap_probe()
            except Exception as e:  # telemetry never stops a run
                log.warning("overlap probe failed (%s); continuing without ring.probe_* "
                            "gauges", e)
        return super().run()

    def _run_overlap_probe(self) -> None:
        """``NTS_OVERLAP_PROBE=1``: the first layer's exchange timed in its
        three modes (``dist_ring_blocked.measure_overlap``), kept as gauges
        and one span."""
        h = self.tracer.begin("ring_overlap_probe", cat="probe")
        try:
            probe = measure_overlap(self.compute_graph.tables.fwd, self.feature, self.group,
                                    self.wire_dtype)
        except BaseException as e:
            self.tracer.end(h, error=type(e).__name__)
            raise
        self.tracer.end(h, **probe)
        m = self.metrics
        if probe["efficiency"] is not None:
            m.gauge_set("ring.overlap_efficiency", probe["efficiency"])
        m.gauge_set("ring.probe_overlap_s", probe["overlap_s"])
        m.gauge_set("ring.probe_compute_s", probe["compute_s"])
        m.gauge_set("ring.probe_exchange_s", probe["exchange_s"])
        m.gauge_set("ring.probe_simulated", bool(probe["simulated"]))
        log.info(
            "ring overlap probe%s: overlapped %.3f ms, compute-only %.3f ms, exchange-only "
            "%.3f ms -> efficiency %s%s",
            " (sim)" if probe["simulated"] else "", probe["overlap_s"] * 1e3,
            probe["compute_s"] * 1e3, probe["exchange_s"] * 1e3,
            f"{probe['efficiency']:.2f}" if probe["efficiency"] is not None else "n/a",
            " (the twin's exchange is a slice of x: this measures the schedule's "
            "overhead, not wire time)" if probe["simulated"] else "",
        )

    def end_of_epoch(self, epoch: int, seconds: float, stages: dict) -> None:
        """The per-partition plane: each live partition's ``partition_step``
        point (its seconds: the epoch's plus what the point added; the twin
        runs every partition in one step), the straggler detector, then the
        heartbeats, which may raise ``rank_loss``."""
        if self._liveness is None and self._straggler is None:
            return
        P = self.dist.partitions
        part_seconds = {}
        for p in elastic.alive_partitions(P):
            tp = get_time()
            fault_point("partition_step", epoch=epoch, partition=p)
            part_seconds[p] = seconds + (get_time() - tp)
        if self._straggler is not None:
            self._straggler.observe_epoch(epoch, part_seconds)
        if self._liveness is not None:
            self._liveness.epoch_end(epoch, alive=elastic.alive_partitions(P),
                                     step_seconds=(stages or {}).get("step_device", seconds),
                                     partition_seconds=part_seconds)

    def maybe_emit_numerics(self, epoch: int, stats_dev) -> float:
        """The stats step's records, then ``NTS_QUANT_PROBE``'s verdict: the
        layer-0 payload (the features, the same every epoch) is measured
        once and re-emitted each epoch; a failed probe warns."""
        spent = super().maybe_emit_numerics(epoch, stats_dev)
        if self._quant_probe is None:
            return spent
        t0 = get_time()
        try:
            if self._quant_probe_stats is None:
                self._quant_probe_stats = {
                    k: (v.item() if torch.is_tensor(v) else v)
                    for k, v in self._quant_probe(self.feature).items()}
            numerics.emit_payload_stats(self.metrics, self._quant_probe_stats, epoch)
        except Exception as e:  # a probe never stops a run
            log.warning("wire quant probe failed at epoch %d: %s", epoch, e)
        return spent + get_time() - t0

    # ---- reporting ---------------------------------------------------------------
    def emit_epoch(self, epoch, seconds, loss=None, stages=None, **extra):
        """The epoch record plus the live wire counters (JAX's
        ``record_epoch_wire``) and, on the pipelined ring, one ``ring_step``
        record per hop (its bytes over the epoch's forward exchanges; the
        hop's own time is not separable: ``seconds`` is null, as in JAX)."""
        self.metrics.counter_add("wire.bytes_fwd", self._wire_bytes_fwd_per_epoch)
        self.metrics.counter_add("wire.exchanges", self._wire_exchanges_per_epoch)
        rec = super().emit_epoch(epoch, seconds, loss, stages=stages,
                                 wire_bytes_fwd=self._wire_bytes_fwd_per_epoch, **extra)
        if self._ring_plan is not None:
            span = getattr(self, "_last_epoch_span", None)
            for hop in self._ring_plan["steps"]:
                self.metrics.event(
                    "ring_step", epoch=epoch, step=hop["step"], bytes=int(hop["bytes"]),
                    skipped=hop["skipped"], seconds=None, slab_cols=int(hop["slab_cols"]),
                    epoch_span=span.span_id if span else None,
                )
        return rec

    def test(self, logits: np.ndarray, which: int) -> float:
        """Accuracy over mask class ``which`` of every vertex shard's rows
        (padding rows belong to no split)."""
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
        """The parameters are replicated: world rank 0 writes the npz
        checkpoint; every rank takes part in a sharded save."""
        if self.world is None or self.world.rank == 0 or self._ckpt_backend() == "orbax":
            super().save(path, epoch)


@register_algorithm(*GCN_EAGER_DIST_ALGORITHMS)
class DistGCNEagerTrainer(DistGCNTrainer):
    """The reference's distributed eager GCN: per layer, NN first, then the
    exchange, which runs at the layer's output width."""

    eager = True
