"""GIN — port of ``neutronstarlite_tpu/models/gin.py``.

Per layer: ``h = relu((agg + x) @ W1) @ W2``, relu on every layer but the
last, then batch norm on every layer (the last included), then dropout
(not after the last). Parameters per layer: ``W1`` [d_l, d_{l+1}], ``W2``
[d_{l+1}, d_{l+1}] and ``bn`` at d_{l+1}. The one graph op is
``gather_dst_from_src``, so GIN runs on every aggregation route.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.nn.layers import (
    batch_norm_apply,
    batch_norm_init,
    dropout,
    dropout_mask,
)
from neutronstarlite_torch.nn.param import xavier_uniform
from neutronstarlite_torch.ops.aggregate import gather_dst_from_src
from neutronstarlite_torch.utils.config import GIN_ALGORITHMS


def init_gin_params(sizes: List[int], generator: torch.Generator) -> List[Dict[str, Any]]:
    return [
        {
            "W1": xavier_uniform(sizes[i], sizes[i + 1], generator),
            "W2": xavier_uniform(sizes[i + 1], sizes[i + 1], generator),
            "bn": batch_norm_init(sizes[i + 1], generator.device),
        }
        for i in range(len(sizes) - 1)
    ]


def gin_forward(graph, params, x, drop_rate: float, train: bool, generator) -> torch.Tensor:
    n = len(params)
    for i, layer in enumerate(params):
        last = i == n - 1
        agg = gather_dst_from_src(graph, x)
        h = torch.relu((agg + x) @ layer["W1"]) @ layer["W2"]
        if not last:
            h = torch.relu(h)
        h = batch_norm_apply(layer["bn"], h)
        if train and not last:
            h = dropout(h, dropout_mask(h.shape, drop_rate, generator), drop_rate)
        x = h
    return x


@register_algorithm(*GIN_ALGORITHMS)
class GINTrainer(FullBatchTrainer):
    supports_optim_kernel = True

    def init_params(self, generator: torch.Generator):
        return init_gin_params(self.cfg.layer_sizes(), generator)

    def model_forward(self, params, graph, x, train: bool):
        return gin_forward(graph, params, x, self.cfg.drop_rate if train else 0.0,
                           train, self.drop_gen)
