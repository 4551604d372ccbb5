"""Everything a run feeds the program and the reference, made from the seed.

One ``torch.Generator`` on the run's device draws, in this order: the
edge list (the configuration's ``graph``), the features, the labels, the
train / validation / test split and the initial parameters. The same seed
on the same device gives the same inputs, bit for bit. The edge list and
the per-vertex arrays go to the host (the program builds its graph there);
the parameters stay on the device, with a host copy for the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    v: int
    src: np.ndarray  # [E] uint32
    dst: np.ndarray  # [E] uint32
    feature: np.ndarray  # [V, f0] float32
    label: np.ndarray  # [V] int32
    mask: np.ndarray  # [V] int32: 0 train, 1 validation, 2 test
    params: List[Dict[str, Any]]  # the port's layout, float32 host tensors


def power_law_edges(v: int, e: int, spec: dict, gen: torch.Generator):
    """``e`` directed edges: endpoints ``floor(v * u**exponent)`` (mass on
    low ids, so a few hubs), ids then permuted, and the ``v`` self loops
    last when ``self_loops`` (they count in ``e``). int64 on the device."""
    dev = gen.device
    loops = v if spec.get("self_loops", True) else 0
    n = e - loops
    if n < 0:
        raise ValueError(f"{e} edges are fewer than the {v} self loops")
    a = float(spec.get("exponent", 3.0))
    ends = []
    for _ in range(2):
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        ends.append((u.pow_(a).mul_(v)).to(torch.int64).clamp_(max=v - 1))
    perm = torch.randperm(v, generator=gen, device=dev)
    src, dst = perm[ends[0]], perm[ends[1]]
    if loops:
        ids = torch.arange(v, device=dev)
        src, dst = torch.cat([src, ids]), torch.cat([dst, ids])
    return src, dst


def split_mask(v: int, split: List[int], gen: torch.Generator) -> torch.Tensor:
    """Train / validation / test ids in the configuration's proportions,
    as exact counts (the same for every seed), at random vertices."""
    total = sum(split)
    n_train = round(v * split[0] / total)
    n_val = round(v * split[1] / total)
    mask = torch.full((v,), 2, dtype=torch.int32, device=gen.device)
    perm = torch.randperm(v, generator=gen, device=gen.device)
    mask[perm[:n_train]] = 0
    mask[perm[n_train:n_train + n_val]] = 1
    return mask


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    v, e = int(cfg["vertices"]), int(cfg["edges"])
    sizes = [int(s) for s in cfg["cfg"]["layer_string"].split("-")]
    spec = cfg["graph"]
    if spec["generator"] != "power_law":
        raise ValueError(f"unknown graph generator {spec['generator']!r}")
    src, dst = power_law_edges(v, e, spec, gen)
    src = src.to(torch.int32).cpu().numpy().view(np.uint32)
    dst = dst.to(torch.int32).cpu().numpy().view(np.uint32)
    feat = torch.randn((v, sizes[0]), generator=gen, device=device)
    feat.mul_(float(cfg["features"]["scale"]))
    label = torch.randint(0, sizes[-1], (v,), generator=gen, device=device,
                          dtype=torch.int32)
    mask = split_mask(v, cfg["split"], gen)
    family = importlib.import_module(f"h100bench.reference.{cfg['family']}")
    params = family.init_params(sizes, gen)
    host = [{k: ({n: t.cpu() for n, t in t_.items()} if isinstance(t_, dict) else t_.cpu())
             for k, t_ in layer.items()} for layer in params]
    return Inputs(v=v, src=src, dst=dst, feature=feat.cpu().numpy(),
                  label=label.cpu().numpy(), mask=mask.cpu().numpy(), params=host)
