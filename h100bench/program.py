"""The system under test: ``neutronstarlite_torch`` built through its normal
path, ``ToolkitBase.from_arrays`` over a host graph from
``graph.storage.build_graph`` (the native builder), then ``load_params``
with the benchmark's weights. The window drives the trainer's public
``train_step()``."""

from __future__ import annotations

import time
from typing import Dict

import torch

from h100bench.reference.common import Readings


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: dict, inp, seed: int, device, spans: Dict[str, float]):
    """The trainer, with ``graph_build_s`` and ``model_build_s`` in ``spans``."""
    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models.base import get_algorithm
    from neutronstarlite_torch.utils.config import InputInfo

    icfg = InputInfo(vertices=inp.v, **cfg["cfg"])
    cls = get_algorithm(icfg.algorithm)
    t0 = time.perf_counter()
    graph = build_graph(inp.src, inp.dst, inp.v, weight=cls.weight_mode)
    spans["graph_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    datum = GNNDatum(feature=inp.feature, label=inp.label, mask=inp.mask)
    trainer = cls.from_arrays(icfg, inp.src, inp.dst, datum, seed=seed, device=device,
                              host_graph=graph)
    trainer.load_params(inp.params)
    sync(device)
    spans["model_build_s"] = time.perf_counter() - t0
    return trainer


def counters(trainer) -> Dict[str, float]:
    """The program's counters: the kernel wrappers' launch counts and the
    run registry's counters (``wire.*`` and the rest)."""
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    out = {"ell_level.launches": float(ell_level_aggregate.launches),
           "bsp_ell.launches": float(bsp_aggregate.launches)}
    out.update({k: float(v) for k, v in
                trainer.metrics.snapshot(include_hists=False)["counters"].items()})
    return out


def _host(ts):
    return [t.detach().float().cpu().clone() for t in ts]


def checked_steps(trainer, steps: int, beta1: float) -> Readings:
    """The first ``steps`` training steps through ``train_step()``: each
    loss and training-mode logits, the first gradient as Adam took it (its
    first moment over ``1 - beta1``), the parameters before and after."""
    p0 = _host(trainer.flat_params)
    losses, logits, grads = [], [], None
    for _ in range(steps):
        loss, out = trainer.train_step()
        losses.append(float(loss))
        logits.append(out.detach().float().cpu())
        if grads is None:
            grads = [m / (1.0 - beta1) for m in _host(trainer.opt_state.m)]
    return Readings(losses=losses, logits=logits, grads=grads, p0=p0,
                    p_end=_host(trainer.flat_params))
