"""The fused edge op on the ring (``KERNEL:fused_edge`` on GATDIST and
GGCNDIST) — port of ``neutronstarlite_tpu/parallel/dist_fused_edge.py``.

The mirror chain (``dist_edge_ops.dist_gated_chain``) ships the payload
once and then holds ``[El, .]`` edge tensors per rank; this op holds none.
It runs the single-device fused passes (``ops/fused_edge.py``) on the
ring schedule of ``dist_ring_blocked.py``:

- each rank's adjacency splits by source partition into P step tables
  (``RingBlockedEll``, unit weights = the validity mask), so step s
  consumes the ``[vp, f + C]`` shard ``[h || asrc]`` held at that step with
  shard-local source ids;
- the online-softmax state (m, l, acc) is the ring's carry: each step
  rescales it as a new source tile does on one device, so the
  per-destination softmax spans the partitions with no extra exchange;
- each hop starts before the step's tables run and is waited for after
  (``mesh.ProcessGroup.shift_start`` / ``shift_wait``), as on
  ``DIST_PATH:ring_blocked``;
- the backward runs three rings: two forward rings recirculate
  ``[h || asrc]`` (pass A builds the per-destination sum T1, pass B the
  dst-half gradient), and one reverse ring over the transposed step
  tables circulates the destination side ``[g || m || l || T1 || adst]``
  (f32) while the source-side gradients accumulate on the rank.

``group=None`` is the collective-free twin (``DIST_PATH:ring_blocked_sim``
or ``NTS_DIST_SIMULATE=1``): per rank the same step order and f32 carries,
the shards cut from the full arrays, so gloo ranks are held to it. Pass C
of the twin needs every rank's T1, which the ranks receive on the reverse
ring: the twin finishes T1 for all ranks first.

Wire per layer: forward (P-1)*vp rows of f + C columns; backward 2*(P-1)*vp
rows of f + C and (P-1)*vp rows of f + 4C (``fused_wire_cols``). Plain
PyTorch, as in JAX (XLA's scan): it launches no hand-written kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from neutronstarlite_torch.ops.fused_edge import (
    fused_bwd_gadst_into,
    fused_bwd_src_into,
    fused_bwd_t1_into,
    fused_finalize,
    fused_forward_into,
    fused_init_state,
)
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ring_blocked import RingBlockedEll
from neutronstarlite_torch.parallel.ring_schedule import ring_source


@dataclasses.dataclass
class RingFusedEdgePair:
    """The forward ring's step tables and the reverse ring's transposed
    ones, unit weights (the attention family's graph has weight 1)."""

    fwd: RingBlockedEll
    bwd: RingBlockedEll

    @staticmethod
    def build(dist: DistGraph, vt: int, ranks, device="cpu") -> "RingFusedEdgePair":
        ranks = list(ranks)
        return RingFusedEdgePair(
            fwd=RingBlockedEll.build(dist, vt, ranks, transpose=False, direction=1,
                                     device=device),
            bwd=RingBlockedEll.build(dist, vt, ranks, transpose=True, direction=-1,
                                     device=device),
        )

    @property
    def partitions(self) -> int:
        return self.fwd.partitions

    @property
    def vp(self) -> int:
        return self.fwd.vp

    def levels(self) -> int:
        """Level tables over the steps, each step's counted over every rank
        held (JAX stacks the ranks' levels per step)."""
        return sum(len({int(n.shape[-1]) for steps in self.fwd.tables.values()
                        if steps[s] is not None for n in steps[s].nbr})
                   for s in self.fwd.work)

    def slot_count(self) -> int:
        return self.fwd.slot_count() + self.bwd.slot_count()


def fused_wire_cols(f: int, C: int) -> dict:
    """Columns per exchanged row per layer: the forward ring ships
    [h || asrc]; the backward ships it twice more plus one reverse ring of
    [g || m || l || T1 || adst]."""
    return {"fwd": f + C, "bwd": 2 * (f + C) + (f + 4 * C)}


def _ring(rbe: RingBlockedEll, group, payload: torch.Tensor, step_fn, carry):
    """The double-buffered hop loop of all four rings on a rank: start the
    hop of the held shard, run the step's tables on it, wait for the hop."""
    steps = rbe.tables[group.rank]
    n_hops = rbe.n_transfers()
    cur = payload
    for s in range(rbe.partitions):
        send = s < n_hops
        if send:
            hop = group.shift_start(cur, rbe.direction)
        if steps[s] is not None:
            carry = step_fn(steps[s], carry, cur)
        if send:
            cur = group.shift_wait(hop)
    return carry


def _sim_ring(rbe: RingBlockedEll, parts, p: int, step_fn, carry):
    """The twin of ``_ring`` for rank p: the same steps, the held shard
    ``parts(q)`` cut from the full arrays."""
    P = rbe.partitions
    for s in rbe.work:
        carry = step_fn(rbe.tables[p][s], carry, parts(ring_source(p, s, P, rbe.direction)))
    return carry


def _fwd_step(f: int, adst, slope: float):
    def step(table, state, cur):
        return fused_forward_into(table, state, cur[:, :f], cur[:, f:], adst, slope)
    return step


def _t1_step(f: int, adst, m, l, g, slope: float):
    def step(table, t1, cur):
        return fused_bwd_t1_into(table, t1, cur[:, :f], cur[:, f:], adst, m, l, g, slope)
    return step


def _gad_step(f: int, adst, m, l, t1, g, slope: float):
    def step(table, gad, cur):
        return fused_bwd_gadst_into(table, gad, cur[:, :f], cur[:, f:], adst, m, l, t1, g,
                                    slope)
    return step


def _src_step(f: int, C: int, h, asrc, slope: float):
    def step(table, state, cur):
        gp, mp, lp = cur[:, :f], cur[:, f:f + C], cur[:, f + C:f + 2 * C]
        tp, ap = cur[:, f + 2 * C:f + 3 * C], cur[:, f + 3 * C:]
        return fused_bwd_src_into(table, state, h, asrc, ap, mp, lp, tp, gp, slope)
    return step


def _zeros(n: int, c: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n, c), dtype=torch.float32, device=like.device)


def ring_fused_forward(pair: RingFusedEdgePair, group, h, asrc, adst, slope: float):
    """(out, m, l) of the rank's ``vp`` rows (every rank's in the twin)."""
    vp, f, C = pair.vp, h.shape[1], asrc.shape[1]
    if group is not None:
        payload = torch.cat([h, asrc.to(h.dtype)], dim=1)
        state = _ring(pair.fwd, group, payload, _fwd_step(f, adst, slope),
                      fused_init_state(vp, C, f, h.device))
        return fused_finalize(state, h.dtype), state[0], state[1]
    outs, ms, ls = [], [], []
    payload = torch.cat([h, asrc.to(h.dtype)], dim=1)
    for p in range(pair.partitions):
        state = _sim_ring(pair.fwd, lambda q: payload[q * vp:(q + 1) * vp], p,
                          _fwd_step(f, adst[p * vp:(p + 1) * vp], slope),
                          fused_init_state(vp, C, f, h.device))
        outs.append(fused_finalize(state, h.dtype))
        ms.append(state[0])
        ls.append(state[1])
    return torch.cat(outs), torch.cat(ms), torch.cat(ls)


def ring_fused_backward(pair: RingFusedEdgePair, group, h, asrc, adst, m, l, g,
                        slope: float):
    """(grad_h, grad_asrc, grad_adst) through the three rings."""
    vp, f, C = pair.vp, h.shape[1], asrc.shape[1]
    fwd_payload = torch.cat([h, asrc.to(h.dtype)], dim=1)
    if group is not None:
        t1 = _ring(pair.fwd, group, fwd_payload, _t1_step(f, adst, m, l, g, slope),
                   _zeros(vp, C, h))
        gad = _ring(pair.fwd, group, fwd_payload, _gad_step(f, adst, m, l, t1, g, slope),
                    _zeros(vp, C, h))
        # l ships raw: pass C guards it itself
        rev = torch.cat([g.float(), m, l, t1, adst.float()], dim=1)
        gh, gas = _ring(pair.bwd, group, rev, _src_step(f, C, h, asrc, slope),
                        (_zeros(vp, f, h), _zeros(vp, C, h)))
        return gh.to(h.dtype), gas.to(asrc.dtype), gad.to(adst.dtype)
    P = pair.partitions

    def part(t, p):
        return t[p * vp:(p + 1) * vp]

    t1s, gads = [], []
    for p in range(P):
        ad, mp, lp, gp = part(adst, p), part(m, p), part(l, p), part(g, p)
        parts = lambda q: fwd_payload[q * vp:(q + 1) * vp]  # noqa: E731
        t1 = _sim_ring(pair.fwd, parts, p, _t1_step(f, ad, mp, lp, gp, slope),
                       _zeros(vp, C, h))
        gads.append(_sim_ring(pair.fwd, parts, p, _gad_step(f, ad, mp, lp, t1, gp, slope),
                              _zeros(vp, C, h)))
        t1s.append(t1)
    rev = torch.cat([g.float(), m, l, torch.cat(t1s), adst.float()], dim=1)
    ghs, gass = [], []
    for p in range(P):
        gh, gas = _sim_ring(pair.bwd, lambda q: rev[q * vp:(q + 1) * vp], p,
                            _src_step(f, C, part(h, p), part(asrc, p), slope),
                            (_zeros(vp, f, h), _zeros(vp, C, h)))
        ghs.append(gh)
        gass.append(gas)
    return (torch.cat(ghs).to(h.dtype), torch.cat(gass).to(asrc.dtype),
            torch.cat(gads).to(adst.dtype))


class RingFusedEdge(torch.autograd.Function):
    """The fused chain on the ring; gradients to h, asrc and adst."""

    @staticmethod
    def forward(ctx, h, asrc, adst, pair, group, slope: float):
        out, m, l = ring_fused_forward(pair, group, h, asrc, adst, slope)
        ctx.save_for_backward(h, asrc, adst, m, l)
        ctx.pair, ctx.group, ctx.slope = pair, group, slope
        return out

    @staticmethod
    def backward(ctx, g):
        h, asrc, adst, m, l = ctx.saved_tensors
        gh, gas, gad = ring_fused_backward(ctx.pair, ctx.group, h, asrc, adst, m, l,
                                           g.contiguous(), ctx.slope)
        return gh, gas, gad, None, None, None


def dist_fused_edge_aggregate(pair: RingFusedEdgePair, group, h: torch.Tensor,
                              asrc: torch.Tensor, adst: torch.Tensor,
                              slope: float) -> torch.Tensor:
    """score = leaky_relu(asrc[src] + adst[dst]) -> softmax per destination
    (per channel when C > 1) -> sum of s * h[src], over the ring: the
    rank's ``[vp, .]`` rows (the twin's ``[P*vp, .]``) -> ``[vp, f]``."""
    return RingFusedEdge.apply(h.contiguous(), asrc.contiguous(), adst.contiguous(), pair,
                               group, float(slope))
