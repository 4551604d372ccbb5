"""CommNet — port of ``neutronstarlite_tpu/models/commnet.py``.

Per layer: ``relu(agg @ C + x @ H)`` (relu on the last layer too, as in
JAX), dropout after every layer but the last. Parameters per layer: ``C``
and ``H``, both [d_l, d_{l+1}]. The one graph op is
``gather_dst_from_src``, so CommNet runs on every aggregation route.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.nn.layers import dropout, dropout_mask
from neutronstarlite_torch.nn.param import xavier_uniform
from neutronstarlite_torch.ops.aggregate import gather_dst_from_src
from neutronstarlite_torch.utils.config import COMMNET_ALGORITHMS


def init_commnet_params(sizes: List[int], generator: torch.Generator) -> List[Dict[str, Any]]:
    return [
        {
            "C": xavier_uniform(sizes[i], sizes[i + 1], generator),
            "H": xavier_uniform(sizes[i], sizes[i + 1], generator),
        }
        for i in range(len(sizes) - 1)
    ]


def commnet_forward(graph, params, x, drop_rate: float, train: bool,
                    generator) -> torch.Tensor:
    n = len(params)
    for i, layer in enumerate(params):
        agg = gather_dst_from_src(graph, x)
        h = torch.relu(agg @ layer["C"] + x @ layer["H"])
        if train and i < n - 1:
            h = dropout(h, dropout_mask(h.shape, drop_rate, generator), drop_rate)
        x = h
    return x


@register_algorithm(*COMMNET_ALGORITHMS)
class CommNetTrainer(FullBatchTrainer):
    supports_optim_kernel = True

    def init_params(self, generator: torch.Generator):
        return init_commnet_params(self.cfg.layer_sizes(), generator)

    def model_forward(self, params, graph, x, train: bool):
        return commnet_forward(graph, params, x, self.cfg.drop_rate if train else 0.0,
                               train, self.drop_gen)
