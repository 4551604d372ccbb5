"""GAT — port of ``neutronstarlite_tpu/models/gat.py``.

Per layer: ``h = x @ W``, the decomposed attention ``a . [h_src || h_dst]
= h_src . a[:f] + h_dst . a[f:]`` (two per-vertex scalars), a
per-destination softmax of ``leaky_relu(al[src] + ar[dst], 0.01)``, the
weighted aggregation of h, then relu on every layer but the last and
dropout after it. Parameters per layer: ``W`` [d_l, d_{l+1}] and ``a``
[2 d_{l+1}, 1].

Two routes compute the same layer:

- ``gat_layer``, the edge chain over a ``ScatterGraph`` (``ops/edge.py``):
  [E, 1] scores, ``edge_softmax``, ``aggregate_edge_to_dst_weighted``;
- ``gat_layer_ell`` under ``OPTIM_KERNEL:1``, over ``ops.ell_gat.GatEllPair``:
  dense [rows, K] scores and softmax, and the aggregation on the ELL-level
  kernel with the alphas as runtime weights;
- ``gat_layer_fused`` under ``KERNEL:fused_edge``, over
  ``ops.fused_edge.FusedEdgePair``: scores, online softmax and aggregation
  streamed over blocked tables with C = 1, no [E, .] tensor.

The trainer builds its graph with unit edge weights (``weight_mode``): the
softmax supplies the weights. The bsp and blocked tables (``PALLAS:1``,
``KERNEL_TILE`` under ``OPTIM_KERNEL``) are refused, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from neutronstarlite_torch.models.base import register_algorithm
from neutronstarlite_torch.models.fullbatch import FullBatchTrainer
from neutronstarlite_torch.nn.layers import dropout, dropout_mask
from neutronstarlite_torch.nn.param import xavier_uniform
from neutronstarlite_torch.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax
from neutronstarlite_torch.ops.ell import EllPair
from neutronstarlite_torch.ops.ell_gat import GatEllPair, gat_ell_attention_aggregate
from neutronstarlite_torch.ops.fused_edge import FusedEdgePair, fused_edge_attention_aggregate
from neutronstarlite_torch.utils.config import GAT_ALGORITHMS
from neutronstarlite_torch.utils.profiling import annotate

LEAKY_SLOPE = 0.01  # torch::leaky_relu's default, as the reference's edge NN


def init_gat_params(sizes: List[int], generator: torch.Generator) -> List[Dict[str, Any]]:
    return [
        {
            "W": xavier_uniform(sizes[i], sizes[i + 1], generator),
            "a": xavier_uniform(2 * sizes[i + 1], 1, generator),
        }
        for i in range(len(sizes) - 1)
    ]


def gat_layer(graph, W, a, x, last: bool) -> torch.Tensor:
    h = x @ W
    f = h.shape[1]
    al = h @ a[:f]  # [V, 1]
    ar = h @ a[f:]
    score = torch.nn.functional.leaky_relu(al[graph.csc_src] + ar[graph.csc_dst], LEAKY_SLOPE)
    out = aggregate_edge_to_dst_weighted(graph, edge_softmax(graph, score), h)
    return out if last else torch.relu(out)


def gat_layer_ell(gep: GatEllPair, W, a, x, last: bool) -> torch.Tensor:
    h = x @ W
    f = h.shape[1]
    with annotate("nts.gat.project"):
        al = (h @ a[:f])[:, 0]
        ar = (h @ a[f:])[:, 0]
    out = gat_ell_attention_aggregate(gep, h, al, ar, LEAKY_SLOPE)
    return out if last else torch.relu(out)


def gat_layer_fused(fep: FusedEdgePair, W, a, x, last: bool) -> torch.Tensor:
    h = x @ W
    f = h.shape[1]
    al = h @ a[:f]  # [V, 1] source half of the decomposed attention
    ar = h @ a[f:]
    out = fused_edge_attention_aggregate(fep, h, al, ar, LEAKY_SLOPE)
    return out if last else torch.relu(out)


def gat_forward(graph, params, x, drop_rate: float, train: bool, generator) -> torch.Tensor:
    if isinstance(graph, FusedEdgePair):
        layer_fn = gat_layer_fused
    elif isinstance(graph, GatEllPair):
        layer_fn = gat_layer_ell
    else:
        layer_fn = gat_layer
    n = len(params)
    for i, layer in enumerate(params):
        x = layer_fn(graph, layer["W"], layer["a"], x, i == n - 1)
        if train and i < n - 1:
            x = dropout(x, dropout_mask(x.shape, drop_rate, generator), drop_rate)
    return x


@register_algorithm(*GAT_ALGORITHMS)
class GATTrainer(FullBatchTrainer):
    weight_mode = "ones"  # the softmax supplies the edge weights
    supports_optim_kernel = True  # OPTIM_KERNEL:1 -> the ELL attention
    supports_fused_edge = True  # KERNEL:fused_edge -> the fused op, C = 1
    edge_family = True  # sets the kernel.* edge-traffic gauges

    def init_params(self, generator: torch.Generator):
        return init_gat_params(self.cfg.layer_sizes(), generator)

    def adapt_ell_graph(self, compute_graph):
        if self.cfg.pallas_kernel or not isinstance(compute_graph, EllPair):
            raise ValueError(
                "OPTIM_KERNEL GAT uses the plain ELL tables; KERNEL_TILE/PALLAS "
                f"layouts ({type(compute_graph).__name__}) are not supported with "
                f"ALGORITHM:{self.cfg.algorithm}"
            )
        with self.timers.phase("slot_maps"):
            return GatEllPair.from_pair(compute_graph, self.host_graph)

    def model_forward(self, params, graph, x, train: bool):
        return gat_forward(graph, params, x, self.cfg.drop_rate if train else 0.0,
                           train, self.drop_gen)
