"""Parameter init and the hand-written Adam — port of ``neutronstarlite_tpu/nn/param.py``.

``param_leaves``/``param_tree`` flatten a trainer's parameter list (per
layer a dict of named tensors, bn a ``{"gamma", "beta"}`` dict) and back.
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
from typing import Any, Dict, List, Optional

import numpy as np
import torch


# every family's parameter names, in the order their tensors are flattened
PARAM_NAMES = ("W", "a", "W1", "W2", "C", "H", "Ws", "Wd")


def param_leaves(params: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """Flat list of parameter tensors, layer by layer: the named matrices in
    ``PARAM_NAMES`` order, then bn gamma, beta."""
    unknown = {k for layer in params for k in layer} - set(PARAM_NAMES) - {"bn"}
    if unknown:
        raise ValueError(f"unknown parameter names {sorted(unknown)}")
    out = []
    for layer in params:
        out += [layer[k] for k in PARAM_NAMES if k in layer]
        if "bn" in layer:
            out += [layer["bn"]["gamma"], layer["bn"]["beta"]]
    return out


def param_tree(params: List[Dict[str, Any]], flat: List[Any]) -> List[Dict[str, Any]]:
    """``flat`` (in ``param_leaves`` order) in the structure of ``params``:
    the inverse of ``param_leaves``."""
    it = iter(flat)
    out = []
    for layer in params:
        tree = {k: next(it) for k in PARAM_NAMES if k in layer}
        if "bn" in layer:
            tree["bn"] = {"gamma": next(it), "beta": next(it)}
        out.append(tree)
    return out


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
    """The moments in ``param_leaves`` order and the update count."""

    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int = 0

    def as_tree(self, unflatten) -> "AdamState":
        """The reference's checkpoint form (its ``AdamState`` pytree): ``m``
        and ``v`` in the parameters' structure (``unflatten`` maps a flat
        list onto it; the tensors are shared, not copied), then ``step`` as
        the int32 scalar leaf JAX stores after them."""
        return AdamState(m=unflatten(self.m), v=unflatten(self.v), step=np.int32(self.step))


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


def adam_lr_device(t: torch.Tensor, cfg: AdamConfig) -> torch.Tensor:
    """``adam_lr`` computed on the device from a 0-dim int64 update count,
    so that a captured step reads its schedule from the device."""
    tf = t.float()
    alpha = cfg.alpha
    if cfg.decay_epoch and cfg.decay_epoch > 0:
        n_decays = torch.div(t, cfg.decay_epoch, rounding_mode="floor").float()
        alpha = cfg.alpha * torch.pow(cfg.decay_rate, n_decays)
    bias1 = 1.0 - torch.pow(cfg.beta1, tf)
    bias2 = 1.0 - torch.pow(cfg.beta2, tf)
    return alpha * torch.sqrt(bias2) / bias1


@torch.no_grad()
def adam_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: AdamState,
    cfg: AdamConfig,
    step_t: Optional[torch.Tensor] = None,
) -> None:
    """One Adam step, in place on ``params`` and ``state``. With ``step_t``
    (a 0-dim int64 device tensor) the update count is that tensor, advanced
    in place, and ``state.step`` is left to the caller."""
    if step_t is None:
        state.step += 1
        lr_t = adam_lr(state.step, cfg)
    else:
        step_t.add_(1)
        lr_t = adam_lr_device(step_t, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    for p, g, m, v in zip(params, grads, state.m, state.v):
        g = g + cfg.weight_decay * p
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * g * g)
        p.sub_(lr_t * m / (torch.sqrt(v) + cfg.epsilon))
