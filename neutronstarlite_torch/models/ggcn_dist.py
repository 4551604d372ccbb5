"""Distributed GGCN over the mirror-slot exchange — port of
``neutronstarlite_tpu/models/ggcn_dist.py``.

The gated GCN's layer on ``DistGATTrainer``'s routes: ``h = x @ W``, the
decomposed edge NN ``hs = h @ Ws`` (source half) and ``hd = h @ Wd``
(destination half, kept local), an f'-wide gate ``leaky_relu(hs[src] +
hd[dst], 0.2)`` softmaxed per destination and per channel, the gated sum of
h. The mirror payload is ``[h || hs]`` (2f' columns); the fused ring runs
with C = f' channels.
"""

from __future__ import annotations

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.gat_dist import DistGATTrainer
from neutronstarlite_torch.models.ggcn import GGCN_LEAKY_SLOPE, init_ggcn_params
from neutronstarlite_torch.utils.config import GGCN_DIST_ALGORITHMS


@register_algorithm(*GGCN_DIST_ALGORITHMS)
class DistGGCNTrainer(DistGATTrainer):
    """Vertex-sharded full-batch GGCN over PARTITIONS ranks (or their twin)."""

    slope = GGCN_LEAKY_SLOPE

    def init_params(self, generator: torch.Generator):
        return init_ggcn_params(self.cfg.layer_sizes(), generator)

    @staticmethod
    def mirror_payload_width(f_out: int) -> int:
        """Columns per mirror row: [h || Ws.h]."""
        return 2 * f_out

    @staticmethod
    def edge_score_channels(f_out: int) -> int:
        """The gate is per channel: C = f'."""
        return f_out

    def halves(self, layer, h: torch.Tensor, cast):
        return h @ cast(layer["Ws"]), h @ cast(layer["Wd"])
