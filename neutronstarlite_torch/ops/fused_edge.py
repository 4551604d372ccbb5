"""Fused score -> per-destination softmax -> aggregation over blocked ELL
tables — port of ``neutronstarlite_tpu/ops/fused_edge.py``.

The edge chain (``ops/edge.py``) holds [E, .] score, alpha and product
tensors; this op holds none. The source space is cut into tiles of ``vt``
rows (``ops/blocked_ell.py``); per (source tile, destination run) the
tables hold tile-local source ids, and the per-destination softmax is
ONLINE, as in flash attention: a running (max m, normaliser l, weighted
accumulator acc) per destination is carried across the tiles in JAX's
order, each block rescaling the carried state by exp(m_old - m_new). The
largest intermediate is one row chunk's ``[rows, K, max(f, C)]`` slab,
bounded by ``ops/ell.py::_PLAIN_CHUNK_ELEMS``; the state is V-sized.

The backward (``FusedEdgeAttention``, JAX's custom_vjp) recomputes the
softmax blockwise from the saved (m, l) in three passes:

- A, over the forward tables: T1[d] = sum over in-edges of s * gs, with gs
  the per-edge score cotangent <g[d], h[src]> (summed over f when C == 1);
- B, over the forward tables: grad_adst[d] = sum over in-edges of
  s * (gs - T1[d]) * leaky_relu'(q);
- C, over the TRANSPOSED tables (rows are sources, tiles are destination
  slabs): grad_h[src] += s * g[dst] and grad_asrc[src] += the same score
  gradient.

One code path serves both families through the width C of the score
halves ``asrc``/``adst`` [V, C]: GAT is C = 1 (one score per edge, the
product summed over f), GGCN is C = f' (a score and a softmax per
channel). Numeric policy: f32 state and products whatever the input dtype,
one cast at the end. A destination with no real in-edge gives exact zeros.
Padding slots take the ``NEG_INF`` score, so ``exp`` never meets inf - inf;
padding rows are not visited (``BlockedEll.blocks``), and each destination
is written once per (tile, level), so there are no float atomics and two
calls are bitwise equal.

Like the JAX module, this is plain tensor code (no ``pallas_call``): it
launches neither hand-written kernel, and each block is ~20 small ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.ops.blocked_ell import BlockedEll

# masked-slot score (as ops/ell_gat.NEG_INF): exp(NEG_INF - finite) is 0
NEG_INF = -1e30

DEFAULT_FUSED_VT = 4096  # source-tile rows


def default_fused_vt(v_num: int, kernel_tile: int = 0) -> int:
    """KERNEL_TILE when set, else the default tile height capped by V."""
    return int(kernel_tile) or min(int(v_num), DEFAULT_FUSED_VT)


@dataclasses.dataclass
class FusedEdgePair:
    """Forward (CSC, source-tiled) + transposed (CSR, destination-tiled)
    unit-weight blocked tables: the weights only mark the real slots."""

    fwd: BlockedEll
    bwd: BlockedEll

    @staticmethod
    def from_host(g: CSCGraph, vt: int = 0, levels: str = "", device="cpu") -> "FusedEdgePair":
        vt = default_fused_vt(g.v_num, vt)
        levels = levels or "binned"
        ones = np.ones(g.e_num, np.float32)
        return FusedEdgePair(
            fwd=BlockedEll.build(g.v_num, g.column_offset, g.row_indices, ones, vt,
                                 levels, device),
            bwd=BlockedEll.build(g.v_num, g.row_offset, g.column_indices, ones, vt,
                                 levels, device),
        )

    def slot_count(self) -> int:
        return self.fwd.slot_count() + self.bwd.slot_count()


def _safe_l(l: torch.Tensor) -> torch.Tensor:
    return torch.where(l > 0, l, 1.0)


# ---- forward: one streamed pass, online softmax ----------------------------


def fused_init_state(v_num: int, C: int, f: int, device) -> tuple:
    """(m, l, acc): running per-destination max, normaliser and weighted
    accumulator."""
    return (
        torch.full((v_num, C), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((v_num, C), dtype=torch.float32, device=device),
        torch.zeros((v_num, f), dtype=torch.float32, device=device),
    )


def fused_forward_into(fe: BlockedEll, state, h, asrc, adst, slope: float):
    """Fold the tables' blocks into the carried (m, l, acc): per block the
    scores, the block max, the rescale of the carried state by
    exp(m_old - m_new), and the exp-scores and weighted features folded
    in."""
    m, l, acc = state
    vt = fe.vt
    ad = adst.float()
    for lo, nb, mk, dr in fe.blocks(max(h.shape[1], asrc.shape[1])):
        real = (mk != 0)[:, :, None]
        q = asrc[lo:lo + vt][nb].float() + ad[dr][:, None, :]
        z = torch.where(real, F.leaky_relu(q, slope), NEG_INF)
        m_old = m[dr]
        m_new = torch.maximum(m_old, z.amax(dim=1))
        p = torch.where(real, torch.exp(z - m_new[:, None, :]), 0.0)
        scale = torch.exp(m_old - m_new)  # a first block: exp(-inf) = 0
        row_acc = (h[lo:lo + vt][nb].float() * p).sum(dim=1)  # C = 1 broadcasts over f
        l[dr] = l[dr] * scale + p.sum(dim=1)
        acc[dr] = acc[dr] * scale + row_acc
        m[dr] = m_new
    return m, l, acc


def fused_finalize(state, dtype) -> torch.Tensor:
    """acc / l; no in-edges -> exact zeros."""
    _, l, acc = state
    return torch.where(l > 0, acc / _safe_l(l), 0.0).to(dtype)


# ---- backward: three streamed passes ---------------------------------------


def _score_grad(s, gs, t1_b, q, real, slope: float):
    """The softmax Jacobian s * (gs - T1[dst]) through the leaky_relu."""
    dq = torch.where(q >= 0, 1.0, slope)
    return torch.where(real, s * (gs - t1_b) * dq, 0.0)


def _forward_blocks(fe: BlockedEll, h, asrc, adst, m, l, g, slope: float):
    """Passes A and B share this: per block of the forward tables, the
    destination rows, mask, pre-activation q, recomputed softmax s, the
    score cotangent gs."""
    C, vt = asrc.shape[1], fe.vt
    ad, ls, gf = adst.float(), _safe_l(l), g.float()
    for lo, nb, mk, dr in fe.blocks(max(h.shape[1], C)):
        real = (mk != 0)[:, :, None]
        q = asrc[lo:lo + vt][nb].float() + ad[dr][:, None, :]
        s = torch.where(
            real, torch.exp(F.leaky_relu(q, slope) - m[dr][:, None, :]) / ls[dr][:, None, :], 0.0
        )
        gs = gf[dr][:, None, :] * h[lo:lo + vt][nb].float()
        if C == 1:
            gs = gs.sum(dim=2, keepdim=True)
        yield dr, real, q, s, gs


def fused_bwd_t1_into(fe: BlockedEll, t1, h, asrc, adst, m, l, g, slope: float):
    """Pass A: T1[d] = sum over in-edges of s * gs, into ``t1`` [V, C]."""
    for dr, _, _, s, gs in _forward_blocks(fe, h, asrc, adst, m, l, g, slope):
        t1[dr] = t1[dr] + (s * gs).sum(dim=1)
    return t1


def fused_bwd_gadst_into(fe: BlockedEll, gad, h, asrc, adst, m, l, t1, g, slope: float):
    """Pass B (T1 complete): grad_adst[d] = sum over in-edges of the score
    gradient, into ``gad`` [V, C]."""
    for dr, real, q, s, gs in _forward_blocks(fe, h, asrc, adst, m, l, g, slope):
        gad[dr] = gad[dr] + _score_grad(s, gs, t1[dr][:, None, :], q, real, slope).sum(dim=1)
    return gad


def fused_bwd_src_into(feT: BlockedEll, state, h, asrc, adst, m, l, t1, g, slope: float):
    """Pass C over the transposed tables, tiled by destination: the
    destination side (adst, m, l, T1, g) is sliced per tile, and the
    source-space gradients grad_h[src] += s * g[dst] and grad_asrc[src] +=
    the score gradient accumulate into ``state`` ([S, f], [S, C]); the
    rows are unique sources per (tile, level)."""
    gh, gas = state
    C, vt = asrc.shape[1], feT.vt
    ad, lf, gf = adst.float(), _safe_l(l), g.float()
    hp, ap = h.float(), asrc.float()
    for lo, nb, mk, dr in feT.blocks(max(h.shape[1], C)):
        sl = slice(lo, lo + vt)
        real = (mk != 0)[:, :, None]
        q = ap[dr][:, None, :] + ad[sl][nb]
        s = torch.where(real, torch.exp(F.leaky_relu(q, slope) - m[sl][nb]) / lf[sl][nb], 0.0)
        gv = gf[sl][nb]  # [n, K, f] cotangent rows of the destinations
        gs = gv * hp[dr][:, None, :]
        if C == 1:
            gs = gs.sum(dim=2, keepdim=True)
        gz = _score_grad(s, gs, t1[sl][nb], q, real, slope)
        gh[dr] = gh[dr] + (s * gv).sum(dim=1)
        gas[dr] = gas[dr] + gz.sum(dim=1)
    return gh, gas


# ---- the paired op ----------------------------------------------------------


class FusedEdgeAttention(torch.autograd.Function):
    """Forward: one streamed pass; backward: passes A, B, C. Returns the
    gradients of h, asrc and adst."""

    @staticmethod
    def forward(ctx, h, asrc, adst, pair: FusedEdgePair, slope: float):
        state = fused_init_state(pair.fwd.v_num, asrc.shape[1], h.shape[1], h.device)
        state = fused_forward_into(pair.fwd, state, h, asrc, adst, slope)
        ctx.save_for_backward(h, asrc, adst)
        ctx.pair, ctx.slope, ctx.stats = pair, slope, state[:2]
        return fused_finalize(state, h.dtype)

    @staticmethod
    def backward(ctx, g):
        h, asrc, adst = ctx.saved_tensors
        m, l = ctx.stats
        pair, slope = ctx.pair, ctx.slope
        f, C = h.shape[1], asrc.shape[1]
        V, S = pair.fwd.v_num, pair.bwd.v_num

        def zeros(n, c):
            return torch.zeros((n, c), dtype=torch.float32, device=h.device)

        t1 = fused_bwd_t1_into(pair.fwd, zeros(V, C), h, asrc, adst, m, l, g, slope)
        gad = fused_bwd_gadst_into(pair.fwd, zeros(V, C), h, asrc, adst, m, l, t1, g, slope)
        gh, gas = fused_bwd_src_into(pair.bwd, (zeros(S, f), zeros(S, C)), h, asrc, adst,
                                     m, l, t1, g, slope)
        return gh.to(h.dtype), gas.to(asrc.dtype), gad.to(adst.dtype), None, None


def fused_edge_attention_aggregate(
    pair: FusedEdgePair, h: torch.Tensor, asrc: torch.Tensor, adst: torch.Tensor,
    slope: float,
) -> torch.Tensor:
    """score = leaky_relu(asrc[src] + adst[dst]) -> softmax per destination
    (per channel when C > 1) -> sum of s * h[src]; [V, f] -> [V, f], no
    [E, .] tensors. Gradients flow to h, asrc and adst."""
    return FusedEdgeAttention.apply(h, asrc, adst, pair, float(slope))
