"""Runs the plain reference over a run's inputs: the family's forward
(``reference/<family>.py``) through ``common.train_steps``."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from h100bench.reference import common


def to_device(params, device):
    return [{k: ({n: t.to(device).clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.to(device).clone()) for k, v in layer.items()} for layer in params]


def run(cfg: dict, inp, seed: int, steps: int, device, mode: str = "exact",
        loss_fn=common.masked_nll) -> common.Readings:
    """``steps`` training steps of the reference from the run's inputs, in
    the precision ``mode`` (``common.Rounding``). The dropout masks come
    from a generator on ``device`` seeded with ``seed + 1``, as the
    trainer seeds its own."""
    family = importlib.import_module(f"h100bench.reference.{cfg['family']}")
    v = inp.v
    src = torch.from_numpy(inp.src.view(np.int32)).to(device).to(torch.int64)
    dst = torch.from_numpy(inp.dst.view(np.int32)).to(device).to(torch.int64)
    s = common.build_structure(src, dst, v)
    x = torch.from_numpy(inp.feature).to(device)
    label = torch.from_numpy(inp.label).to(device).to(torch.int64)
    train01 = torch.from_numpy(inp.mask == 0).to(device).to(torch.float32)
    drop_gen = torch.Generator(device=device)
    drop_gen.manual_seed(int(seed) + 1)
    q = common.Rounding(mode)
    forward = family.make_forward(s, src, dst, x, cfg, drop_gen, q)
    return common.train_steps(forward, to_device(inp.params, device), label, train01,
                              cfg, steps, q, loss_fn)
