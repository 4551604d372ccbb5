"""Plain GCN (Kipf and Welling; NeutronStar's GCN layer order): per layer
aggregate the in-neighbours with the weights ``1 / sqrt(d_out(u) d_in(v))``
(degrees clamped to 1), then ``dropout(relu(bn(h) @ W))``; the last layer
is ``h @ W``. Each training forward draws one dropout mask per layer but
the last, of the layer's output shape, before the layer."""

from __future__ import annotations

import torch

from h100bench.reference import common


def init_params(sizes, gen: torch.Generator):
    """Per layer W [f_in, f_out] (Xavier) and, on every layer but the last,
    batch norm at the layer's input width (gamma 1, beta 0)."""
    out = []
    for i in range(len(sizes) - 1):
        layer = {"W": common.xavier(sizes[i], sizes[i + 1], gen)}
        if i < len(sizes) - 2:
            layer["bn"] = {"gamma": torch.ones(sizes[i], device=gen.device),
                           "beta": torch.zeros(sizes[i], device=gen.device)}
        out.append(layer)
    return out


def edge_weights(src: torch.Tensor, dst: torch.Tensor, v: int) -> torch.Tensor:
    d_out = torch.bincount(src, minlength=v).clamp_(min=1).to(torch.float64)
    d_in = torch.bincount(dst, minlength=v).clamp_(min=1).to(torch.float64)
    return (1.0 / torch.sqrt(d_out[src] * d_in[dst])).to(torch.float32)


def make_forward(s: common.Structure, src, dst, x, cfg: dict, drop_gen, q: common.Rounding):
    vals = common.slot_values(s, edge_weights(src, dst, s.v))
    rate = float(cfg["cfg"]["drop_rate"])
    eps = float(cfg["bn_eps"])

    def forward(params, step):
        h = q(x)
        n = len(params)
        for i, layer in enumerate(params):
            last = i == n - 1
            mask = None if last else common.dropout_masks(
                drop_gen, (h.shape[0], layer["W"].shape[1]), rate)
            h = q(common.Aggregate.apply(h, vals, s))
            if last:
                h = q(h @ q(layer["W"]))
            else:
                bn = layer["bn"]
                h = common.batch_norm(h, bn["gamma"], bn["beta"], eps, q)
                h = q(torch.relu(q(h @ q(layer["W"]))))
                h = common.dropout(h, mask, rate, q)
        return h

    return forward
