"""Batch-norm and dropout — port of ``neutronstarlite_tpu/nn/layers.py``.

``batch_norm_apply`` uses full-batch training-mode statistics in training
and in evaluation alike (the reference's full-batch toolkits never switch
BN to eval mode). The variance is the population variance
(``correction=0``, as ``jnp.var``), not torch's default unbiased one. The
statistics are taken in float32 and cast back to the input dtype, as
``jnp.mean``/``jnp.var`` do for bfloat16 input. The distributed trainers
pass a valid mask (padded rows excluded) and a cross-rank sum; their
masked statistics are f32 too, where JAX sums the masked ones in the
input dtype.
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
    p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5,
    valid_mask: Optional[torch.Tensor] = None, reduce=None,
) -> torch.Tensor:
    """Full-batch batch-norm over the vertex axis; ``p`` already in x.dtype.

    ``valid_mask`` [V] (1 real, 0 padding) keeps the padded rows of the
    distributed layout out of the statistics; ``reduce`` sums a tensor over
    the ranks that hold the other rows (the distributed trainers'
    differentiable all-reduce; None when this process holds every row)."""
    xf = x.float()
    if valid_mask is None:
        mean = xf.mean(dim=0, keepdim=True).to(x.dtype)
        var = xf.var(dim=0, keepdim=True, correction=0).to(x.dtype)
    else:
        total = reduce if reduce is not None else (lambda t: t)
        m = valid_mask[:, None].float()
        n = torch.clamp(total(m.sum()), min=1.0)
        mean32 = total((xf * m).sum(dim=0, keepdim=True)) / n
        var = (total(((xf - mean32) ** 2 * m).sum(dim=0, keepdim=True)) / n).to(x.dtype)
        mean = mean32.to(x.dtype)
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
