"""Distributed GCN over the uniform mirror exchange, with DepCache — port
of ``neutronstarlite_tpu/models/gcn_dist_cache.py``.

GCN in the standard order (aggregate, then the layer's NN: ``gcn_dist``'s
``gcn_layer_nn``), each layer's aggregation the weighted sum over the
mirror rows of ``parallel/feature_cache.CachedMirrorGraph``:

- with ``PROC_REP:0`` no slot is hot and every layer fetches all its
  mirror rows (the communication-only GCN);
- with ``PROC_REP:1`` the slots whose source's out-degree is at least
  ``REP_THRESHOLD`` (``auto``: the smallest threshold whose replicated
  layer-0 rows plus one historical cache per deeper layer fit
  ``CACHE_BUDGET_MIB`` per rank) are hot. Layer 0's hot rows are raw
  features, replicated once at build (exact), so only the cold rows cross
  the wire. With ``CACHE_REFRESH:R`` > 1 the deeper layers' hot rows come
  from a cache refilled by an eval-mode forward (dropout off) on every
  epoch e with e % R == 0 (and on the first epoch a process trains), and
  no gradient flows through them; R = 1 fetches them fresh.

``PRECISION:bfloat16`` warns and runs f32, as JAX does (the cached slot
layout has no bf16 form). Telemetry as in JAX: ``wire.comm_layer``
(``mirror+depcache``), ``wire.rows_per_layer_full`` / ``_partial`` (P-1
chunks of mb / mf rows), ``wire.simulated``, and per epoch the wire
counters priced by what that epoch fetched (a refresh epoch adds a full
eval forward) and the epoch record's ``cache_refresh``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.gcn_dist import (
    DistGCNTrainer,
    check_dist_supported,
    check_mirror_knobs,
    gcn_layer_nn,
)
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.parallel.dist_edge_ops import (
    UniformMirror,
    dist_aggregate_dst_fuse_weight,
    dist_get_dep_nbr,
)
from neutronstarlite_torch.parallel.feature_cache import (
    CacheExchange,
    CachedMirrorGraph,
    dist_get_dep_nbr_partial,
)
from neutronstarlite_torch.tools.wire_accounting import exchange_rows_per_device
from neutronstarlite_torch.utils.config import GCN_CACHE_DIST_ALGORITHMS
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("gcn_dist_cache")


def extract_hot(cmg: CachedMirrorGraph, mirrors: torch.Tensor) -> torch.Tensor:
    """The hot slots of full mirror rows: ``[n*P*mb, f] -> [n*P*mc, f]``."""
    P, mb, mc, f = cmg.partitions, cmg.mb, cmg.mc, mirrors.shape[1]
    return mirrors.view(-1, P, mb, f)[:, :, :mc].reshape(-1, f)


@register_algorithm(*GCN_CACHE_DIST_ALGORITHMS)
class DistGCNCacheTrainer(DistGCNTrainer):
    """GCN over the mirror-slot exchange with replicated and cached rows."""

    supports_optim_kernel = False
    supports_precision = False  # warns and runs f32
    supports_dist_path = False  # the DepCache exchange is the only one

    @classmethod
    def check_cfg(cls, cfg) -> None:
        check_dist_supported(cfg)
        check_mirror_knobs(cfg, "the DepCache GCN")

    def build_model(self) -> None:
        cfg, dev = self.cfg, self.device
        type(self).check_cfg(cfg)
        if cfg.precision == "bfloat16":
            log.warning("PRECISION:bfloat16 is not implemented for the DepCache trainer "
                        "(%s); running f32", cfg.algorithm)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mesh_spec = self.partitioner = None
        self.wire_dtype, self._ring_plan = None, None
        self.group, P = mesh.resolve_group(cfg.partitions, mesh.simulate_requested())
        self.world = self.group
        self.comm_layer = "mirror+depcache"
        self.metrics.gauge_set("dist.active_partitions", P)

        g = self.host_graph
        if not cfg.process_rep:
            threshold = int(g.out_degree.max()) + 1  # no hot slot
        elif cfg.rep_threshold < 0:
            # the budget covers every per-slot allocation: the replicated
            # layer-0 rows and one historical cache per deeper layer
            threshold = CachedMirrorGraph.choose_replication_threshold(
                g, P, feature_size=sum(cfg.layer_sizes()[:-1]),
                budget_bytes=cfg.cache_budget_mib << 20)
        else:
            threshold = cfg.rep_threshold
        self.dist = cmg = CachedMirrorGraph.build(g, P, threshold)
        self.threshold = threshold
        self.cache_refresh = max(int(cfg.cache_refresh), 1)
        self.compute_graph = UniformMirror(cmg, self.group, dev)
        self.cache_exchange = CacheExchange(cmg, self.group, dev)
        self._use_hist = self.cache_refresh > 1 and cmg.mc > 0
        self.caches: Optional[List[torch.Tensor]] = None
        self._step_caches = None
        self._refresh = False
        self.cached0 = None
        if cmg.mc > 0:
            rows = cmg.replicate_rows(self.datum.feature)
            if self.group is not None:
                rows = rows[self.group.rank]
            self.cached0 = torch.from_numpy(
                np.ascontiguousarray(rows).reshape(-1, rows.shape[-1])).to(dev)
            log.info("DepCache: %d%% of mirror slots replicated (threshold %d, mc=%d mf=%d "
                     "vs dense mb=%d)", int(100 * cmg.cached_fraction), threshold, cmg.mc,
                     cmg.mf, cmg.mb)
        log.info("GCN DepCache: P=%d, mc=%d mf=%d el=%d, refresh=%d%s", P, cmg.mc, cmg.mf,
                 cmg.el, self.cache_refresh,
                 " (sim twin, one process)" if self.group is None
                 else f" (rank {self.group.rank} of {self.group.world})")

        self._wire_widths = cfg.layer_sizes()[:-1]
        self._rows_full = exchange_rows_per_device("mirror", P, cmg.vp, cmg.mb)
        self._rows_partial = exchange_rows_per_device("mirror", P, cmg.vp, cmg.mf)
        m = self.metrics
        m.gauge_set("wire.comm_layer", self.comm_layer)
        m.gauge_set("wire.rows_per_layer_full", self._rows_full)
        m.gauge_set("wire.rows_per_layer_partial", self._rows_partial)
        m.gauge_set("wire.simulated", int(self.group is None))
        self._set_epoch_wire(False, False)
        self._place_rows()

    def _set_epoch_wire(self, use_cached: bool, refresh: bool) -> None:
        """This epoch's forward wire bytes at the f32 slot layout: layer 0
        serves its hot rows from the replica, the deeper layers from the
        cache when it is active; a refresh adds a full-fetch forward."""
        widths = self._wire_widths
        l0 = self._rows_partial if self.cached0 is not None else self._rows_full
        deep = self._rows_partial if use_cached else self._rows_full
        n = 4 * (l0 * widths[0] + deep * sum(widths[1:]))
        if refresh:
            n += 4 * self._rows_full * sum(widths)
        self._wire_bytes_fwd_per_epoch = n
        self._wire_exchanges_per_epoch = len(widths) * (2 if refresh else 1)

    # ---- the step --------------------------------------------------------------
    def cache_forward(self, params, x, caches, train: bool, fill: bool):
        """(logits, new caches): ``caches[i-1]`` serves layer i's hot rows
        when given; ``fill`` makes the full-fetch layers emit their hot
        slots as the new caches."""
        ctx = self._layer_ctx(train)
        ex, ce, cmg = self.compute_graph, self.cache_exchange, self.dist
        n = len(params)
        new: List[torch.Tensor] = []
        for i, layer in enumerate(params):
            cr = self.cached0 if i == 0 else (caches[i - 1] if caches is not None else None)
            if cr is not None and cmg.mc > 0:
                mir = dist_get_dep_nbr_partial(ce, x, cr)
            else:
                mir = dist_get_dep_nbr(ex, x)
            if i > 0 and fill:
                new.append(extract_hot(cmg, mir).detach())
            h = dist_aggregate_dst_fuse_weight(ex, ex.edges.weight, mir)
            x = gcn_layer_nn(i, n, layer, h, x, ctx)
        return x.float(), new

    def model_forward(self, params, graph, x, train: bool):
        return self.cache_forward(params, x, self._step_caches if train else None, train,
                                  False)[0]

    def _forward_backward(self):
        """The refresh (an eval-mode forward) when due, then the step with
        the caches when they are active."""
        epoch = getattr(self, "current_epoch", 0)
        refresh = self._use_hist and (epoch % self.cache_refresh == 0 or self.caches is None)
        if refresh:
            with torch.no_grad():
                self.caches = self.cache_forward(self.params, self.feature, None, False,
                                                 True)[1]
        use_cached = self._use_hist and self.caches is not None
        self._refresh = refresh
        self._set_epoch_wire(use_cached, refresh)
        self._step_caches = self.caches if use_cached else None
        try:
            return super()._forward_backward()
        finally:
            self._step_caches = None

    def emit_epoch(self, epoch, seconds, loss=None, stages=None, **extra):
        return super().emit_epoch(epoch, seconds, loss, stages=stages,
                                  cache_refresh=bool(self._refresh), **extra)
