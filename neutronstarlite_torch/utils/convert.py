"""Carry parameters across from the JAX package.

``params_from_jax(params, trainer)`` takes a JAX trainer's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray,
trainer.params)``): a list of per-layer dicts whose names are those of
every family (GCN ``W`` + ``bn``; GAT ``W``, ``a``; GIN ``W1``, ``W2``,
``bn``; CommNet ``C``, ``H``; GGCN ``W``, ``Ws``, ``Wd``), bn being
``{"gamma", "beta"}``; the sampled GCN trainer's is a list of ``{"W"}``.
It returns the port's parameters, converted by name with no transpose: the
port computes ``h @ W`` in the JAX layout too. Given a trainer, it also
writes them into it (``ToolkitBase.load_params``). The parity tests start both packages
from the same initial parameters this way, since torch cannot reproduce
JAX's random draws. ``gcn_params_from_jax`` is the same function under
its first name.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params, trainer=None) -> List[Dict[str, Any]]:
    out = []
    for layer in params:
        out.append({
            k: ({n: _t(t) for n, t in v.items()} if isinstance(v, dict) else _t(v))
            for k, v in layer.items()
        })
    if trainer is not None:
        trainer.load_params(out)
    return out


gcn_params_from_jax = params_from_jax
