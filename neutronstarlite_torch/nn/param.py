"""Parameter init and the hand-written Adam — port of ``neutronstarlite_tpu/nn/param.py``.

Xavier-uniform init with scale sqrt(6/(w+h)), drawn from an explicit
``torch.Generator``. Adam exactly as the JAX module writes it (the
reference's ``Parameter`` update): the L2 term folded into the gradient,
the step size ``alpha * decay_rate^(t // decay_epoch)``, the bias-corrected
``lr_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)`` and ``eps`` outside the
square root. This is not ``torch.optim.Adam``. The scalar schedule is
computed in float32, as the JAX step computes it; the update is in place.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


def xavier_uniform(w: int, h: int, generator: torch.Generator) -> torch.Tensor:
    """[w, h] float32 uniform in [-s, s], s = sqrt(6/(w+h)), on the
    generator's device."""
    scale = float(np.sqrt(6.0 / (w + h)))
    out = torch.empty((w, h), dtype=torch.float32, device=generator.device)
    return out.uniform_(-scale, scale, generator=generator)


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    alpha: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-9
    weight_decay: float = 0.0001
    decay_rate: float = 0.97
    decay_epoch: int = 100  # <= 0 disables the schedule


@dataclasses.dataclass
class AdamState:
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int = 0


def adam_init(params: List[torch.Tensor]) -> AdamState:
    return AdamState(
        m=[torch.zeros_like(p) for p in params],
        v=[torch.zeros_like(p) for p in params],
    )


def adam_lr(step: int, cfg: AdamConfig) -> float:
    """The bias-corrected step size of update number ``step`` (1-based),
    in float32."""
    f32 = np.float32
    if cfg.decay_epoch and cfg.decay_epoch > 0:
        alpha = f32(cfg.alpha) * np.power(f32(cfg.decay_rate), f32(step // cfg.decay_epoch))
    else:
        alpha = f32(cfg.alpha)
    bias1 = f32(1.0) - np.power(f32(cfg.beta1), f32(step))
    bias2 = f32(1.0) - np.power(f32(cfg.beta2), f32(step))
    return float(f32(alpha * np.sqrt(bias2) / bias1))


@torch.no_grad()
def adam_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: AdamState,
    cfg: AdamConfig,
) -> None:
    """One Adam step, in place on ``params`` and ``state``."""
    state.step += 1
    lr_t = adam_lr(state.step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    for p, g, m, v in zip(params, grads, state.m, state.v):
        g = g + cfg.weight_decay * p
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * g * g)
        p.sub_(lr_t * m / (torch.sqrt(v) + cfg.epsilon))
