"""Shared parts of the plain reference: the sparse aggregation, batch norm,
dropout, the masked loss, Adam and the three-step driver.

The aggregation ``out[v] = sum over edges (u -> v) of w_e * x[u]`` runs as
a sparse CSR matrix times a dense one. Parallel edges are merged into one
slot whose value is the sum of their weights; the structure (slots in
destination order, and the same slots in source order for the transpose)
is worked out once from the edge list. Values may be computed per edge at
run time (GAT's attention); the gradient then flows back to each edge.

``Rounding`` is the precision hook: ``exact`` leaves every tensor as it is
(the reference); ``fp8`` rounds each operation's result, and its gradient,
to float8 e4m3 (the control for a bfloat16 program); ``tf32`` runs the
dense matrix products in TF32 (the control for a float32 program).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

CHUNK_ELEMS = 1 << 27  # bound on one gathered [slots, f] piece


@dataclasses.dataclass
class Structure:
    """Merged slots of an edge list in destination-major (forward) order,
    the permutation to source-major (transpose) order, and each edge's
    slot."""

    v: int
    crow: torch.Tensor  # [V+1] int32, forward (row = destination)
    col: torch.Tensor  # [S] int32, the source of each slot
    row: torch.Tensor  # [S] int64, the destination of each slot
    crow_t: torch.Tensor  # [V+1] int32, transpose (row = source)
    col_t: torch.Tensor  # [S] int32
    to_t: torch.Tensor  # [S] int64: transpose slot j holds forward slot to_t[j]
    slot_of_edge: torch.Tensor  # [E] int64


def build_structure(src: torch.Tensor, dst: torch.Tensor, v: int) -> Structure:
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    key = dst * v + src
    uniq, slot_of_edge = torch.unique(key, sorted=True, return_inverse=True)
    row, col = uniq // v, uniq % v
    crow = torch.zeros(v + 1, dtype=torch.int64, device=src.device)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=v), 0)
    to_t = torch.argsort(col * v + row)
    crow_t = torch.zeros(v + 1, dtype=torch.int64, device=src.device)
    crow_t[1:] = torch.cumsum(torch.bincount(col, minlength=v), 0)
    return Structure(v=v, crow=crow.to(torch.int32), col=col.to(torch.int32), row=row,
                     crow_t=crow_t.to(torch.int32), col_t=row[to_t].to(torch.int32),
                     to_t=to_t, slot_of_edge=slot_of_edge)


def slot_values(s: Structure, w_edge: torch.Tensor) -> torch.Tensor:
    """Per-slot values: the sum of the weights of the slot's edges, added
    in float64 (many near-equal terms added one by one in float32 round
    the same way each time)."""
    out = torch.zeros(s.col.shape[0], dtype=torch.float64, device=w_edge.device)
    return out.index_add(0, s.slot_of_edge, w_edge.double()).to(w_edge.dtype)


def _spmm(crow, col, vals, x, v):
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, col, vals, (v, x.shape[0]), check_invariants=False)
        return a @ x


class Aggregate(torch.autograd.Function):
    """``A(vals) @ x``; differentiable in x (the transpose) and in the slot
    values (the slot's destination gradient dotted with its source row)."""

    @staticmethod
    def forward(ctx, x, vals, s: Structure):
        ctx.s = s
        ctx.save_for_backward(x, vals)
        return _spmm(s.crow, s.col, vals, x, s.v)

    @staticmethod
    def backward(ctx, g):
        x, vals = ctx.saved_tensors
        s = ctx.s
        g = g.contiguous()
        gx = gv = None
        if ctx.needs_input_grad[0]:
            gx = _spmm(s.crow_t, s.col_t, vals[s.to_t], g, s.v)
        if ctx.needs_input_grad[1]:
            gv = torch.empty_like(vals)
            step = max(1, CHUNK_ELEMS // max(x.shape[1], 1))
            for lo in range(0, vals.shape[0], step):
                r = s.row[lo:lo + step]
                c = s.col[lo:lo + step].to(torch.int64)
                gv[lo:lo + step] = (g[r] * x[c]).sum(dim=1)
        return gx, gv, None


class Rounding:
    """The precision in which the reference computes (see the module)."""

    def __init__(self, mode: str = "exact"):
        if mode not in ("exact", "fp8", "tf32"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.mode == "fp8" else t

    def matmul_tf32(self) -> bool:
        return self.mode == "tf32"


def xavier(rows: int, cols: int, gen: torch.Generator) -> torch.Tensor:
    """Xavier-uniform [rows, cols] float32 on the generator's device."""
    s = math.sqrt(6.0 / (rows + cols))
    return torch.empty((rows, cols), device=gen.device).uniform_(-s, s, generator=gen)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8(t)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def batch_norm(x, gamma, beta, eps: float, q: Rounding):
    """Full-batch batch norm over the vertex axis, population variance."""
    mean = q(x.mean(dim=0, keepdim=True))
    var = q(x.var(dim=0, keepdim=True, correction=0))
    xn = q(q(x - mean) * q(torch.rsqrt(var + eps)))
    return q(q(xn * q(gamma)) + q(beta))


def dropout_masks(gen: torch.Generator, shape, rate: float) -> Optional[torch.Tensor]:
    """A keep-mask: Bernoulli(1 - rate) per element from ``gen``."""
    if rate <= 0.0:
        return None
    keep = torch.full(shape, 1.0 - rate, dtype=torch.float32, device=gen.device)
    return torch.bernoulli(keep, generator=gen).bool()


def dropout(x, mask, rate: float, q: Rounding):
    if mask is None:
        return x
    return q(torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                              device=x.device)))


def masked_nll(logits, label, train01):
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(1, label[:, None])[:, 0]
    return -(picked * train01).sum() / train01.sum().clamp(min=1.0)


def leaves(params: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """The parameters in order: per layer W, a, then batch norm's gamma, beta."""
    out = []
    for layer in params:
        out += [layer[k] for k in ("W", "a") if k in layer]
        if "bn" in layer:
            out += [layer["bn"]["gamma"], layer["bn"]["beta"]]
    return out


@dataclasses.dataclass
class Adam:
    """NeutronStar's Adam: L2 folded into the gradient, the step size
    ``alpha * decay^(t // decay_epoch) * sqrt(1 - b2^t) / (1 - b1^t)``,
    eps outside the square root."""

    alpha: float
    weight_decay: float
    decay_rate: float
    decay_epoch: int
    beta1: float
    beta2: float
    epsilon: float

    def step(self, params, grads, m, v, t: int) -> List[torch.Tensor]:
        """Update in place; returns the gradients as the optimizer takes them."""
        alpha = self.alpha * (self.decay_rate ** (t // self.decay_epoch)
                              if self.decay_epoch > 0 else 1.0)
        lr = alpha * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        taken = []
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                g = g + self.weight_decay * p
                taken.append(g)
                mi.mul_(self.beta1).add_((1.0 - self.beta1) * g)
                vi.mul_(self.beta2).add_((1.0 - self.beta2) * g * g)
                p.sub_(lr * mi / (torch.sqrt(vi) + self.epsilon))
        return taken


def adam_from(cfg: dict) -> Adam:
    c, a = cfg["cfg"], cfg["adam"]
    return Adam(alpha=c["learn_rate"], weight_decay=c["weight_decay"],
                decay_rate=c["decay_rate"], decay_epoch=c["decay_epoch"],
                beta1=a["beta1"], beta2=a["beta2"], epsilon=a["epsilon"])


@dataclasses.dataclass
class Readings:
    """What a training run is judged by: each checked step's loss and
    training-mode logits, the first step's gradient as the optimizer took
    it (per leaf), the parameters before the first step and after the last
    checked one (host float32 tensors)."""

    losses: List[float]
    logits: List[torch.Tensor]
    grads: List[torch.Tensor]
    p0: List[torch.Tensor]
    p_end: List[torch.Tensor]


def train_steps(
    forward: Callable, params: List[Dict[str, Any]], label, train01, cfg: dict,
    steps: int, q: Rounding, loss_fn: Callable = masked_nll,
) -> Readings:
    """``steps`` full-batch steps: forward (``forward(params, step)`` gives
    the logits), masked NLL, backward, Adam; on the params' device."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    p0 = [p.detach().cpu().clone() for p in flat]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    adam = adam_from(cfg)
    losses, logits, first = [], [], None
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = q.matmul_tf32()
    try:
        for t in range(1, steps + 1):
            for p in flat:
                p.grad = None
            out = forward(params, t)
            loss = loss_fn(out, label, train01)
            loss.backward()
            losses.append(float(loss.detach()))
            logits.append(out.detach().float().cpu())
            taken = adam.step(flat, [p.grad for p in flat], m, v, t)
            if first is None:
                first = [g.detach().cpu().clone() for g in taken]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return Readings(losses=losses, logits=logits, grads=first, p0=p0,
                    p_end=[p.detach().cpu().clone() for p in flat])
