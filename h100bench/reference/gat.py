"""Plain single-head GAT (Velickovic et al.; NeutronStar's GAT layer): per
layer ``h = x @ W``, edge score ``leaky_relu(h[u] . a[:f] + h[v] . a[f:],
0.01)`` for each edge u -> v, softmax over each destination's in-edges
(parallel edges each count), ``out[v] = sum alpha_uv h[u]``, relu on every
layer but the last, then dropout (mask of the layer's output shape)."""

from __future__ import annotations

import torch

from h100bench.reference import common

SLOPE = 0.01


def init_params(sizes, gen: torch.Generator):
    """Per layer W [f_in, f_out] and the attention vector a [2 f_out, 1]
    (both Xavier, drawn in that order)."""
    return [{"W": common.xavier(sizes[i], sizes[i + 1], gen),
             "a": common.xavier(2 * sizes[i + 1], 1, gen)} for i in range(len(sizes) - 1)]


def edge_softmax(score: torch.Tensor, dst: torch.Tensor, v: int) -> torch.Tensor:
    """Softmax over each destination's in-edges, computed in float64: a
    hub's 1.9M near-equal terms added one by one in float32 come out 1 %
    high, as each addition rounds the same way."""
    s64 = score.double()
    peak = torch.full((v,), -torch.inf, dtype=torch.float64, device=score.device)
    peak = peak.scatter_reduce(0, dst, s64.detach(), "amax", include_self=True)
    ex = torch.exp(s64 - peak[dst])
    total = torch.zeros(v, dtype=torch.float64, device=score.device).index_add(0, dst, ex)
    return (ex / total[dst]).to(score.dtype)


def make_forward(s: common.Structure, src, dst, x, cfg: dict, drop_gen, q: common.Rounding):
    rate = float(cfg["cfg"]["drop_rate"])

    def forward(params, step):
        h_in = q(x)
        n = len(params)
        for i, layer in enumerate(params):
            h = q(h_in @ q(layer["W"]))
            f = h.shape[1]
            a = q(layer["a"])
            al, ar = q(h @ a[:f])[:, 0], q(h @ a[f:])[:, 0]
            score = q(torch.nn.functional.leaky_relu(al[src] + ar[dst], SLOPE))
            alpha = q(edge_softmax(score, dst, s.v))
            out = q(common.Aggregate.apply(h, common.slot_values(s, alpha), s))
            if i < n - 1:
                out = q(torch.relu(out))
                out = common.dropout(out, common.dropout_masks(drop_gen, out.shape, rate),
                                     rate, q)
            h_in = out
        return h_in

    return forward
