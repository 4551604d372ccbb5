"""The comparison that decides ``correct``: the program's checked steps
against the plain reference's, number by number, each under its limit.

- ``loss_gap``: the largest relative gap of a checked step's loss.
- ``logits_gap``: the first step's training-mode logits (both sides from
  the same parameters): the norm of their difference over the
  reference's norm.
- ``grad_gap``: over the parameter leaves, the largest gap between the
  norms of the first step's gradient as the optimizer took it (the
  program's worked out from its Adam state after one step), over the
  larger of the reference leaf's norm and the median leaf's.
- ``grad_diff``: the median leaf's norm of the two gradients' difference,
  over the larger of its reference norm and the median leaf's. A gap of
  norms is blind to unbiased rounding and to a gradient that turns
  without growing; the difference is not.
- ``change_gap``: the gap of norms of the parameters' change over the
  checked steps; leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone and are left out.

A cell's limits (``workloads/<cell>.json``) name the numbers it compares.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

NAMES = ("loss_gap", "logits_gap", "grad_gap", "grad_diff", "change_gap")
STILL = 1e-3  # a leaf whose gradient norm is under this share of the median's


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def _worse(worst: float, gap: float) -> float:
    return max(worst, gap) if math.isfinite(gap) else math.inf


def worst_leaf(prog: List[torch.Tensor], ref: List[torch.Tensor], keep=None) -> float:
    """The worst leaf's gap of norms, over the larger of the reference
    leaf's norm and the median leaf's."""
    rn = [_norm(t) for t in ref]
    med = _median(rn)
    worst = 0.0
    for i, (p, n) in enumerate(zip(prog, rn)):
        if keep is not None and not keep[i]:
            continue
        gap = abs(_norm(p) - n)
        scale = max(n, med)
        worst = _worse(worst, gap / scale if scale > 0 else gap)
    return worst


def median_leaf(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The median leaf's norm of the difference over the larger of its
    reference norm and the median leaf's."""
    rn = [_norm(t) for t in ref]
    med = _median(rn)
    diffs = [_norm(p - r) / max(n, med) if max(n, med) > 0 else _norm(p - r)
             for p, r, n in zip(prog, ref, rn)]
    return math.inf if any(not math.isfinite(d) for d in diffs) else _median(diffs)


def numbers(prog, ref) -> Dict[str, float]:
    """Both sides are ``reference.common.Readings``."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError("the two sides checked different numbers of steps")
    loss = 0.0
    for a, b in zip(prog.losses, ref.losses):
        loss = _worse(loss, abs(a - b) / abs(b) if b else abs(a - b))
    a, b = prog.logits[0], ref.logits[0]
    logits = _worse(0.0, _norm(a - b) / max(_norm(b), 1e-30))
    gnorm = [_norm(g) for g in ref.grads]
    med = _median(gnorm)
    keep = [g >= STILL * med for g in gnorm]
    change_p = [e - s for s, e in zip(prog.p0, prog.p_end)]
    change_r = [e - s for s, e in zip(ref.p0, ref.p_end)]
    return {"loss_gap": loss, "logits_gap": logits,
            "grad_gap": worst_leaf(prog.grads, ref.grads),
            "grad_diff": median_leaf(prog.grads, ref.grads),
            "change_gap": worst_leaf(change_p, change_r, keep)}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in nums and nums[name] <= limits[name] for name in limits)
