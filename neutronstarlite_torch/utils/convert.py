"""Carry GCN parameters across from the JAX package.

``gcn_params_from_jax(params, trainer)`` takes the JAX trainer's parameter
pytree as numpy arrays — ``[{"W": [in, out], "bn": {"gamma", "beta"}}, ...]``
(``jax.tree.map(np.asarray, trainer.params)``) — and returns the port's
parameters. W keeps the JAX ``[in, out]`` layout (the port computes
``h @ W`` too), so the conversion is by name, with no transpose. Given a
trainer, it also writes them into it (``FullBatchTrainer.load_params``).
The parity tests start both packages from the same initial parameters
this way, since torch cannot reproduce JAX's random draws.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def gcn_params_from_jax(params, trainer=None) -> List[Dict[str, Any]]:
    out = []
    for layer in params:
        new: Dict[str, Any] = {"W": _t(layer["W"])}
        if "bn" in layer:
            new["bn"] = {"gamma": _t(layer["bn"]["gamma"]), "beta": _t(layer["bn"]["beta"])}
        out.append(new)
    if trainer is not None:
        trainer.load_params(out)
    return out
