"""The plain reference's GCN and GAT steps against a dense-adjacency
formula, autograd on dense matrices, at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from h100bench import inputs
from h100bench.reference import common, drive

V, E = 40, 400
CFG = {
    "vertices": V, "edges": E, "family": "gcn", "bn_eps": 1e-5,
    "cfg": {"layer_string": "12-8-5", "drop_rate": 0.5, "learn_rate": 0.01,
            "weight_decay": 1e-4, "decay_rate": 0.97, "decay_epoch": 2},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-9},
    "graph": {"generator": "power_law", "exponent": 3.0, "self_loops": True},
    "features": {"scale": 1.0}, "split": [6, 2, 2],
}


def dense_counts(inp):
    c = torch.zeros((V, V), dtype=torch.float64)
    c.index_put_((torch.from_numpy(inp.dst.astype(np.int64)),
                  torch.from_numpy(inp.src.astype(np.int64))),
                 torch.ones(E, dtype=torch.float64), accumulate=True)
    return c.float()


def dense_gcn(inp, c, gen):
    d_out = c.sum(0).clamp(min=1)  # edges leaving u
    d_in = c.sum(1).clamp(min=1)
    a = c / torch.sqrt(d_in[:, None] * d_out[None, :])
    x = torch.from_numpy(inp.feature)

    def forward(params, step):
        h = x
        for i, layer in enumerate(params):
            last = i == len(params) - 1
            mask = None if last else common.dropout_masks(gen, (V, layer["W"].shape[1]), 0.5)
            h = a @ h
            if last:
                return h @ layer["W"]
            mean, var = h.mean(0), h.var(0, correction=0)
            h = (h - mean) / torch.sqrt(var + 1e-5) * layer["bn"]["gamma"] + layer["bn"]["beta"]
            h = torch.relu(h @ layer["W"])
            h = torch.where(mask, h * 2.0, torch.zeros(()))
    return forward


def dense_gat(inp, c, gen):
    x = torch.from_numpy(inp.feature)
    live = c > 0

    def forward(params, step):
        h_in = x
        for i, layer in enumerate(params):
            h = h_in @ layer["W"]
            f = h.shape[1]
            s = torch.nn.functional.leaky_relu(
                (h @ layer["a"][f:]) + (h @ layer["a"][:f]).T, 0.01)  # [dst, src]
            s = s.masked_fill(~live, -torch.inf)
            ex = c * torch.exp(s - s.amax(1, keepdim=True).detach())
            out = (ex / ex.sum(1, keepdim=True)) @ h
            if i < len(params) - 1:
                out = torch.relu(out)
                out = torch.where(common.dropout_masks(gen, out.shape, 0.5), out * 2.0,
                                  torch.zeros(()))
            h_in = out
        return h_in
    return forward


@pytest.mark.parametrize("family", ["gcn", "gat"])
def test_reference_against_the_dense_formula(family):
    cfg = dict(CFG, family=family)
    inp = inputs.make_inputs(cfg, 2 ** 31 + 7, "cpu")
    ref = drive.run(cfg, inp, 5, 3, "cpu")
    gen = torch.Generator().manual_seed(6)
    make = dense_gcn if family == "gcn" else dense_gat
    dense = common.train_steps(make(inp, dense_counts(inp), gen), drive.to_device(inp.params, "cpu"),
                               torch.from_numpy(inp.label).long(),
                               torch.from_numpy(inp.mask == 0).float(), cfg, 3, common.Rounding())
    assert ref.losses == pytest.approx(dense.losses, rel=1e-5)
    for a, b in zip(ref.grads + ref.p_end, dense.grads + dense.p_end):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert ref.losses[0] != ref.losses[2]  # the steps train


def test_parallel_edges_and_inputs_repeat():
    a = inputs.make_inputs(CFG, 2 ** 31 + 11, "cpu")
    b = inputs.make_inputs(CFG, 2 ** 31 + 11, "cpu")
    assert (a.src == b.src).all() and (a.feature == b.feature).all()
    assert len(a.src) == E and (a.src[-V:] == np.arange(V)).all()
    assert sorted(np.bincount(a.mask, minlength=3)) == sorted([24, 8, 8])
    s = common.build_structure(torch.from_numpy(a.src.astype(np.int64)),
                               torch.from_numpy(a.dst.astype(np.int64)), V)
    assert s.col.shape[0] <= E and int(s.crow[-1]) == s.col.shape[0]


def test_fp8_control_rounds_value_and_gradient():
    q = common.Rounding("fp8")
    t = torch.tensor([1.0 + 1.0 / 64], requires_grad=True)
    y = q(t)
    assert float(y.detach()) == 1.0
    y.backward(torch.tensor([1.0 + 1.0 / 64]))
    assert float(t.grad) == 1.0
