"""Distributed CommNet — port of ``neutronstarlite_tpu/models/commnet_dist.py``.

The CommNet communication step over the distributed GCN's exchange
(``models/gcn_dist.py``): ``relu(agg @ C + x @ H)``, dropout on hidden
layers only.
"""

from __future__ import annotations

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.commnet import init_commnet_params
from neutronstarlite_torch.models.gcn_dist import DistGCNTrainer, LayerCtx
from neutronstarlite_torch.utils.config import COMMNET_DIST_ALGORITHMS


def commnet_layer_nn(i, n_layers, layer, agg, x_in, ctx: LayerCtx):
    agg, x_in = ctx.cast(agg), ctx.cast(x_in)
    h = torch.relu(ctx.contract(agg, ctx.cast(layer["C"]))
                   + ctx.contract(x_in, ctx.cast(layer["H"])))
    return ctx.drop(h) if i < n_layers - 1 else h


@register_algorithm(*COMMNET_DIST_ALGORITHMS)
class DistCommNetTrainer(DistGCNTrainer):
    """Vertex-sharded full-batch CommNet."""

    layer_nn = staticmethod(commnet_layer_nn)
    mesh_pad_keys = ("C", "H")  # both matmuls contract the feature axis

    def init_params(self, generator: torch.Generator):
        return init_commnet_params(self.cfg.layer_sizes(), generator)
