"""GCN, standard and transform-first (EAGER) order — port of
``neutronstarlite_tpu/models/gcn.py``.

Per layer: aggregate neighbours, then ``dropout(relu(bn(h) @ W))`` (last
layer: ``h @ W``); the EAGER order swaps the two, NN first. Parameters are a
list of ``{"W": [in, out], "bn": {"gamma", "beta"}}`` dicts in the JAX
layout (``h @ W``); bn exists on every layer but the last, at the layer's
input width.

``PRECISION:bfloat16`` as ``gcn_forward`` does it: the activations are cast
once at the input, W and the BN parameters are cast at use, the logits come
back as float32. ``SUBLINEAR`` recomputes every non-final layer in the
backward (``torch.utils.checkpoint``); the dropout masks are drawn before
the checkpointed layer, so the recomputation reuses them.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

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
from neutronstarlite_torch.utils.config import GCN_ALGORITHMS, GCN_EAGER_ALGORITHMS


def init_gcn_params(sizes: List[int], generator: torch.Generator) -> List[Dict[str, Any]]:
    params = []
    for i in range(len(sizes) - 1):
        layer: Dict[str, Any] = {"W": xavier_uniform(sizes[i], sizes[i + 1], generator)}
        if i < len(sizes) - 2:
            layer["bn"] = batch_norm_init(sizes[i], generator.device)
        params.append(layer)
    return params


def gcn_forward(
    graph,
    params,
    x: torch.Tensor,
    drop_rate: float,
    train: bool,
    generator: torch.Generator,
    eager: bool = False,
    compute_dtype=None,
    sublinear: bool = False,
) -> torch.Tensor:
    """Logits [V, classes] (float32) for all vertices."""

    def cast(a):
        return a.to(compute_dtype) if compute_dtype is not None else a

    x = cast(x)
    n_layers = len(params)
    for i, layer in enumerate(params):
        last = i == n_layers - 1
        mask = None
        if not last and train:
            mask = dropout_mask((x.shape[0], layer["W"].shape[1]), drop_rate, generator)

        def nn(h, layer=layer, last=last, mask=mask):
            if last:
                return h @ cast(layer["W"])
            if "bn" in layer:
                h = batch_norm_apply({k: cast(v) for k, v in layer["bn"].items()}, h)
            h = torch.relu(h @ cast(layer["W"]))
            return dropout(h, mask, drop_rate)

        def layer_step(h, nn=nn):
            if eager:
                return gather_dst_from_src(graph, nn(h))
            return nn(gather_dst_from_src(graph, h))

        if sublinear and not last:
            x = checkpoint(layer_step, x, use_reentrant=False)
        else:
            x = layer_step(x)
    return x.float()


@register_algorithm(*GCN_ALGORITHMS)
class GCNTrainer(FullBatchTrainer):
    eager = False

    def init_params(self, generator: torch.Generator):
        return init_gcn_params(self.cfg.layer_sizes(), generator)

    def model_forward(self, params, graph, x, train: bool):
        dtype = torch.bfloat16 if self.cfg.precision == "bfloat16" else None
        return gcn_forward(
            graph, params, x, self.cfg.drop_rate if train else 0.0, train,
            self.drop_gen, eager=self.eager, compute_dtype=dtype,
            sublinear=self.cfg.sublinear,
        )


@register_algorithm(*GCN_EAGER_ALGORITHMS)
class GCNEagerTrainer(GCNTrainer):
    """Transform-then-propagate order (the reference's GCN_CPU_EAGER)."""

    eager = True
