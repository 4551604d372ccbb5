"""Batch-norm and dropout — port of ``neutronstarlite_tpu/nn/layers.py``.

``batch_norm_apply`` uses full-batch training-mode statistics in training
and in evaluation alike (the reference's full-batch toolkits never switch
BN to eval mode). The variance is the population variance
(``correction=0``, as ``jnp.var``), not torch's default unbiased one. The
statistics are taken in float32 and cast back to the input dtype, as
``jnp.mean``/``jnp.var`` do for bfloat16 input.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def batch_norm_init(width: int, device) -> Dict[str, torch.Tensor]:
    return {
        "gamma": torch.ones(width, dtype=torch.float32, device=device),
        "beta": torch.zeros(width, dtype=torch.float32, device=device),
    }


def batch_norm_apply(
    p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Full-batch batch-norm over the vertex axis; ``p`` already in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=0, keepdim=True).to(x.dtype)
    var = xf.var(dim=0, keepdim=True, correction=0).to(x.dtype)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * p["gamma"] + p["beta"]


def dropout_mask(
    shape, rate: float, generator: torch.Generator
) -> Optional[torch.Tensor]:
    """Boolean keep-mask drawn from ``generator`` (None when rate <= 0)."""
    if rate <= 0.0:
        return None
    keep = torch.full(shape, 1.0 - rate, dtype=torch.float32, device=generator.device)
    return torch.bernoulli(keep, generator=generator).bool()


def dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Apply a keep-mask from ``dropout_mask``: survivors scaled by 1/keep.
    The mask is drawn outside this function so that a recomputed layer
    (SUBLINEAR) reuses it."""
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
