"""Distributed GIN — port of ``neutronstarlite_tpu/models/gin_dist.py``.

The GIN per-layer NN over the distributed GCN's exchange
(``models/gcn_dist.py``): ``bn(relu(relu((agg + x) @ W1) @ W2))`` on
hidden layers (no inner ReLU after W2 on the last), batch norm over the
valid rows of every rank on every layer, dropout on hidden layers only.
On the 2D mesh only the first matmul contracts the feature axis.
"""

from __future__ import annotations

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.gcn_dist import DistGCNTrainer, LayerCtx
from neutronstarlite_torch.models.gin import init_gin_params
from neutronstarlite_torch.utils.config import GIN_DIST_ALGORITHMS


def gin_layer_nn(i, n_layers, layer, agg, x_in, ctx: LayerCtx):
    agg, x_in = ctx.cast(agg), ctx.cast(x_in)
    # the first matmul contracts the exchanged (on a 2D mesh, slabbed)
    # width; W2 the replicated hidden width
    h = torch.relu(ctx.contract(agg + x_in, ctx.cast(layer["W1"]))) @ ctx.cast(layer["W2"])
    if i < n_layers - 1:
        h = torch.relu(h)
    h = ctx.bn(layer["bn"], h)
    return ctx.drop(h) if i < n_layers - 1 else h


@register_algorithm(*GIN_DIST_ALGORITHMS)
class DistGINTrainer(DistGCNTrainer):
    """Vertex-sharded full-batch GIN."""

    layer_nn = staticmethod(gin_layer_nn)
    mesh_pad_keys = ("W1",)  # the one parameter with the input-feature dim

    def init_params(self, generator: torch.Generator):
        return init_gin_params(self.cfg.layer_sizes(), generator)
