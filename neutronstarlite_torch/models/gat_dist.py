"""Distributed GAT over the mirror-slot exchange — port of
``neutronstarlite_tpu/models/gat_dist.py``.

Per layer (parameters replicated, ``W`` and ``a`` as the single-device GAT):
``h = x @ W``, the decomposed attention halves ``al = h @ a[:f]`` (source)
and ``ar = h @ a[f:]`` (destination), then one of two routes:

- the mirror chain (default): one ``all_to_all`` ships the payload ``[h ||
  al]`` (f'+1 columns) to the mirror rows, then per rank the masked edge
  chain ``leaky_relu(al[src] + ar[dst], 0.01)`` -> per-destination softmax ->
  gated sum of h (``parallel/dist_edge_ops.dist_gated_chain``); the ranks
  run it a destination-aligned chunk at a time (``NTS_EDGE_CHUNK`` target
  edges per chunk, default 1,000,000), each chunk recomputed in the
  backward, and the twin runs it whole, as JAX does;
- ``KERNEL:fused_edge``: the fused op on the ring
  (``parallel/dist_fused_edge.py``, ``DIST_PATH`` empty, ``ring_blocked`` or
  ``ring_blocked_sim``; ``KERNEL_TILE`` its source tile, default
  ``min(vp, 512)``). ``WIRE_DTYPE`` is ignored there with JAX's warning: the
  payload ships the compute dtype.

Every layer's output is f32 (``PRECISION:bfloat16`` runs the matmuls, the
exchange and the chain in bf16, with f32 sums); ReLU and dropout (the mask
of all P*vp rows drawn from the epoch's generator, this rank's rows kept)
follow every layer but the last. ``GGCNDIST`` (``ggcn_dist.py``) swaps the
layer only.

The distributed plane as in JAX: ``NTS_DEBUGINFO=1`` prints the report
with the nn / graph split (the nn-only forward replaces each layer's graph
op by a zero aggregate of its shape; GGCNDIST's likewise); ``NTS_NUMERICS``
and ``NTS_QUANT_PROBE`` are not read (the trainer runs its default step),
and ``NTS_ELASTIC=1`` refuses at the funnel (``supports_elastic``).

Refused as in JAX: ``MESH``, and ``DIST_PATH`` on the mirror chain (it is
no dense-feature path); besides, ``COMM_LAYER`` other than mirror and
``KERNEL_TILE`` on the chain, which would be ignored. ``OPTIM_KERNEL`` and
``PALLAS`` (set by the reference's own GAT dist cfgs) are ignored with a
warning, as JAX ignores them. These are ``gcn_dist.check_mirror_knobs``;
the distributed plane's other refusals are ``check_dist_supported``.

Telemetry as in JAX: ``wire.comm_layer`` (mirror or ring_fused),
``wire.rows_per_layer``, ``wire.bytes_per_epoch_fwd``, ``wire.simulated``
and the per-epoch wire counters; ``kernel.path`` (eager_edge or
fused_edge) and ``kernel.edge_hbm_bytes_per_epoch`` (0 on the ring), and
on the ring ``kernel.fused_vt``, ``kernel.fused_levels`` and
``kernel.fused_slots`` (the port's own tables: each rank's levels and
slots, where JAX's count its stacked padding).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.models.gat import LEAKY_SLOPE, init_gat_params
from neutronstarlite_torch.models.gcn_dist import (
    DistGCNTrainer,
    check_dist_supported,
    check_mirror_knobs,
)
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.parallel.dist_edge_ops import UniformMirror, dist_gated_chain
from neutronstarlite_torch.parallel.dist_fused_edge import (
    RingFusedEdgePair,
    dist_fused_edge_aggregate,
    fused_wire_cols,
)
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ring_blocked import default_ring_vt
from neutronstarlite_torch.parallel.mirror import MirrorGraph
from neutronstarlite_torch.tools.wire_accounting import exchange_rows_per_device
from neutronstarlite_torch.utils.config import GAT_DIST_ALGORITHMS
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("gat_dist")

DEFAULT_EDGE_CHUNK = 1_000_000


def edge_chunk() -> int:
    """``NTS_EDGE_CHUNK``: the chunked chain's target edges per chunk."""
    return int(os.environ.get("NTS_EDGE_CHUNK", DEFAULT_EDGE_CHUNK))


class FusedRing:
    """``KERNEL:fused_edge``'s exchange: the ring tables and the group."""

    def __init__(self, pair: RingFusedEdgePair, group):
        self.pair, self.group = pair, group


@register_algorithm(*GAT_DIST_ALGORITHMS)
class DistGATTrainer(DistGCNTrainer):
    """Vertex-sharded full-batch GAT over PARTITIONS ranks (or their twin)."""

    weight_mode = "ones"  # the softmax supplies the edge weights
    supports_optim_kernel = False
    supports_fused_edge = True
    supports_dist_path = False  # one exchange: the mirror, or the ring when fused
    supports_elastic = False  # no survivor replan on the mirror family (JAX's rule)
    supports_numerics = False  # JAX's edge-family dist trainers run no stats step
    forward_taped = FullBatchTrainer.forward_taped  # no layer taps, no replay
    slope = LEAKY_SLOPE

    def init_params(self, generator: torch.Generator):
        return init_gat_params(self.cfg.layer_sizes(), generator)

    @staticmethod
    def mirror_payload_width(f_out: int) -> int:
        """Columns per mirror row: [h || h.a_src]."""
        return f_out + 1

    @staticmethod
    def edge_score_channels(f_out: int) -> int:
        """The score halves' width C (GAT's score is a scalar)."""
        return 1

    def halves(self, layer, h: torch.Tensor, cast):
        """(source half, destination half) of the decomposed edge score."""
        f = h.shape[1]
        return h @ cast(layer["a"][:f]), h @ cast(layer["a"][f:])

    @classmethod
    def check_cfg(cls, cfg) -> None:
        fused = cfg.kernel == "fused_edge"
        check_dist_supported(cfg, supports_fused_edge=True)
        check_mirror_knobs(cfg, "the fused edge ring" if fused else "the edge chain", fused)

    # ---- build ---------------------------------------------------------------
    def build_model(self) -> None:
        cfg, dev = self.cfg, self.device
        fused = cfg.kernel == "fused_edge"
        type(self).check_cfg(cfg)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mesh_spec = self.partitioner = None
        self.wire_dtype, self._ring_plan = None, None
        sim = mesh.simulate_requested() or (fused and cfg.dist_path == "ring_blocked_sim")
        self.group, P = mesh.resolve_group(cfg.partitions, sim)
        self.world = self.group
        self.metrics.gauge_set("dist.active_partitions", P)
        where = (" (sim twin, one process)" if self.group is None
                 else f" (rank {self.group.rank} of {self.group.world})")
        shards = range(P) if self.group is None else [self.group.rank]
        m = self.metrics
        if fused:
            self.dist = d = DistGraph.build(self.host_graph, P)
            vt = default_ring_vt(d.vp, cfg.kernel_tile)
            pair = RingFusedEdgePair.build(d, vt, shards, device=dev)
            self.compute_graph = FusedRing(pair, self.group)
            self.comm_layer = "ring_fused"
            m.gauge_set("kernel.path", "fused_edge")
            m.gauge_set("kernel.fused_vt", vt)
            m.gauge_set("kernel.fused_levels", pair.levels())
            m.gauge_set("kernel.fused_slots", pair.slot_count())
            m.gauge_set("kernel.edge_hbm_bytes_per_epoch", 0)
            log.info(
                "KERNEL:fused_edge on the ring: vt=%d, %d/%d work steps, %d hops, %d table "
                "slots%s", vt, len(pair.fwd.work), P, pair.fwd.n_transfers(),
                pair.slot_count(), where)
        else:
            self.dist = mg = MirrorGraph.build(self.host_graph, P)
            chunk = edge_chunk() if self.group is not None else None
            self.compute_graph = ex = UniformMirror(mg, self.group, dev, chunk=chunk)
            self.comm_layer = "mirror"
            m.gauge_set("kernel.path", "eager_edge")
            m.gauge_set("kernel.edge_hbm_bytes_per_epoch", sum(
                mg.el * (2 * f + 3 * type(self).edge_score_channels(f)) * 4
                for f in cfg.layer_sizes()[1:]))
            log.info("mirror exchange: mb=%d slots/pair, vp=%d, El=%d edges/rank%s",
                     mg.mb, mg.vp, mg.el, where)
            if ex.chunk_list is not None:
                ch = ex.chunk_list
                log.info("gated edge chain: %d chunk(s) x %d edges (dp=%d), recomputed per "
                         "chunk", ch.n_chunks, ch.slot.shape[2], ch.dp)
        self._set_edge_wire_gauges(fused, P)
        self._place_rows()

    def _set_edge_wire_gauges(self, fused: bool, P: int) -> None:
        cfg, d = self.cfg, self.dist
        sizes = cfg.layer_sizes()
        if fused:
            rows = exchange_rows_per_device("ring", P, d.vp)
            cols = sum(fused_wire_cols(f, type(self).edge_score_channels(f))["fwd"]
                       for f in sizes[1:])
        else:
            rows = exchange_rows_per_device("mirror", P, d.vp, d.mb)
            cols = sum(type(self).mirror_payload_width(f) for f in sizes[1:])
        itemsize = 2 if cfg.precision == "bfloat16" else 4
        self._wire_exchanges_per_epoch = len(sizes) - 1
        self._wire_bytes_fwd_per_epoch = rows * cols * itemsize
        m = self.metrics
        m.gauge_set("wire.comm_layer", self.comm_layer)
        m.gauge_set("wire.rows_per_layer", rows)
        m.gauge_set("wire.bytes_per_epoch_fwd", self._wire_bytes_fwd_per_epoch)
        m.gauge_set("wire.simulated", int(self.group is None))

    # ---- the step --------------------------------------------------------------
    def edge_layer(self, graph, h: torch.Tensor, src_half: torch.Tensor,
                   dst_half: torch.Tensor) -> torch.Tensor:
        """The layer's graph op: [rows, f] in h's dtype -> f32 [rows, f]."""
        if isinstance(graph, FusedRing):
            return dist_fused_edge_aggregate(graph.pair, graph.group, h, src_half, dst_half,
                                             type(self).slope)
        payload = torch.cat([h, src_half.to(h.dtype)], dim=1)
        return dist_gated_chain(graph, payload, dst_half, h.shape[1], type(self).slope)

    def model_forward(self, params, graph, x, train: bool, nn_only: bool = False):
        """``nn_only``: each layer's graph op replaced by a zero aggregate
        of its shape (DEBUGINFO's nn-only forward)."""
        ctx = self._layer_ctx(train)
        n = len(params)
        for i, layer in enumerate(params):
            xc = ctx.cast(x)
            h = xc @ ctx.cast(layer["W"])
            src_half, dst_half = self.halves(layer, h, ctx.cast)
            if nn_only:
                out = torch.zeros_like(h, dtype=torch.float32)
            else:
                out = self.edge_layer(graph, h, src_half, dst_half).float()
            x = out if i == n - 1 else ctx.drop(F.relu(out))
        return x

    def nn_only_forward(self, train: bool = True):
        return self.model_forward(self.params, self.compute_graph, self.feature, train,
                                  nn_only=True)
