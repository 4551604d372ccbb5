"""GGCN (gated GCN) — port of ``neutronstarlite_tpu/models/ggcn.py``.

Per layer: ``h = x @ W``; the edge NN ``W_e . [h_src || h_dst]`` decomposed
as ``hs = h @ Ws`` and ``hd = h @ Wd`` (vertex-level matmuls), an f'-wide
gate score ``leaky_relu(hs[src] + hd[dst], 0.2)`` per edge, a softmax per
destination and per channel, the gated sum of h over in-edges, then relu
on every layer but the last and dropout after it. Parameters per layer:
``W`` [d_l, d_{l+1}], ``Ws`` and ``Wd`` [d_{l+1}, d_{l+1}].

Two routes compute the same layer:

- ``ggcn_layer``, the edge chain (``ops/edge.py``) over a ``ScatterGraph``:
  its [E, f'] gate needs the edge arrays, so ``OPTIM_KERNEL`` does not
  change it;
- ``ggcn_layer_fused`` under ``KERNEL:fused_edge``, over
  ``ops.fused_edge.FusedEdgePair``: the per-channel softmax runs as the
  fused online softmax with C = f' channels, no [E, .] tensor.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.nn.layers import dropout, dropout_mask
from neutronstarlite_torch.nn.param import xavier_uniform
from neutronstarlite_torch.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax
from neutronstarlite_torch.ops.fused_edge import FusedEdgePair, fused_edge_attention_aggregate
from neutronstarlite_torch.utils.config import GGCN_ALGORITHMS

GGCN_LEAKY_SLOPE = 0.2  # the reference passes 0.2 explicitly


def init_ggcn_params(sizes: List[int], generator: torch.Generator) -> List[Dict[str, Any]]:
    return [
        {
            "W": xavier_uniform(sizes[i], sizes[i + 1], generator),
            "Ws": xavier_uniform(sizes[i + 1], sizes[i + 1], generator),
            "Wd": xavier_uniform(sizes[i + 1], sizes[i + 1], generator),
        }
        for i in range(len(sizes) - 1)
    ]


def ggcn_layer(graph, layer, x, last: bool) -> torch.Tensor:
    h = x @ layer["W"]
    hs = h @ layer["Ws"]
    hd = h @ layer["Wd"]
    m = torch.nn.functional.leaky_relu(hs[graph.csc_src] + hd[graph.csc_dst],
                                       GGCN_LEAKY_SLOPE)  # [E, f'] gate score
    out = aggregate_edge_to_dst_weighted(graph, edge_softmax(graph, m), h)
    return out if last else torch.relu(out)


def ggcn_layer_fused(fep: FusedEdgePair, layer, x, last: bool) -> torch.Tensor:
    h = x @ layer["W"]
    hs = h @ layer["Ws"]  # [V, f'] source half of the decomposed edge NN
    hd = h @ layer["Wd"]
    out = fused_edge_attention_aggregate(fep, h, hs, hd, GGCN_LEAKY_SLOPE)
    return out if last else torch.relu(out)


def ggcn_forward(graph, params, x, drop_rate: float, train: bool, generator) -> torch.Tensor:
    layer_fn = ggcn_layer_fused if isinstance(graph, FusedEdgePair) else ggcn_layer
    n = len(params)
    for i, layer in enumerate(params):
        x = layer_fn(graph, layer, x, i == n - 1)
        if train and i < n - 1:
            x = dropout(x, dropout_mask(x.shape, drop_rate, generator), drop_rate)
    return x


@register_algorithm(*GGCN_ALGORITHMS)
class GGCNTrainer(FullBatchTrainer):
    weight_mode = "ones"  # the learned gate supplies the edge weights
    supports_fused_edge = True  # KERNEL:fused_edge -> the fused op, C = f'
    edge_family = True  # sets the kernel.* edge-traffic gauges

    @staticmethod
    def edge_score_channels(f_out: int) -> int:
        """The gate is per channel: the edge score tensors are f'-wide."""
        return f_out

    def init_params(self, generator: torch.Generator):
        return init_ggcn_params(self.cfg.layer_sizes(), generator)

    def model_forward(self, params, graph, x, train: bool):
        return ggcn_forward(graph, params, x, self.cfg.drop_rate if train else 0.0,
                            train, self.drop_gen)
