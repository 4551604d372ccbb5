"""GAT attention over the ELL tables — port of ``neutronstarlite_tpu/ops/ell_gat.py``.

A destination's in-edges occupy one padded row [K] of the forward (CSC)
ELL tables (``ops/ell.py``), so per layer

- edge scores   e[r, k] = leaky_relu(al[nbr[r, k]] + ar[row_vertex[r]])
- edge softmax  alpha[r, k] = masked softmax over the row's live slots
- aggregation   out[r] = sum_k alpha[r, k] * h[nbr[r, k]]

are dense [rows, K] operations with no [E] tensor and no scatter. The
aggregation is the ELL-level kernel (``ops/ell_kernel.py``,
``csrc/ell_level.cu``) on runtime weights: its forward over the CSC tables
with the alphas, its h-gradient over the CSR tables with the same alphas
laid out there through ``bwd_alpha_idx`` (each backward slot's flat
forward slot). The alphas' gradient ``grad_alpha[r, k] =
g[row_vertex[r]] . h[nbr[r, k]]`` (an SDDMM, f32 products and sums) is on a
CUDA tensor the kernel ``csrc/ell_gat.cu`` (f32 only: GAT's trainers run
f32): one launch per call over the forward aggregation's cached work list
at the same width, counted by ``GatEllPair.grad_alpha_launches``. On a
CPU tensor it is the plain version ``grad_alpha_level``, chunked PyTorch
per level. The JAX package computes it in plain jnp: the kernel replaces
no Pallas kernel.

``GatEllPair`` adds the two maps to an ``EllPair``; they are built on the
host and are bitwise the JAX package's. ``GatherAlLevels`` is the
src-half gather ``al[nbr]`` with a scatter-free transpose over the
backward tables: each backward row collects one vertex's forward slots,
so the sum is a row reduction in a fixed order (autograd's indexed
backward would add with atomics in a varying order).

Profiler scopes (``utils/profiling.annotate``, open while a profiler
records): ``nts.gat.scores``, ``nts.gat.softmax``, ``nts.gat.transpose``
(both slot-map transposes) and ``nts.gat.grad_alpha`` (the kernel's
launch, or the plain pieces); the aggregation's own is ``nts.ell.aggregate``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.ops import _build
from neutronstarlite_torch.ops.ell import _PLAIN_CHUNK_ELEMS, EllBuckets, EllPair
from neutronstarlite_torch.ops.ell_kernel import EllWeightedAggregate, work_list
from neutronstarlite_torch.utils.profiling import annotate

NEG_INF = -1e30  # masked-slot score (a finite sentinel, not inf)


def _flat_slot_layout(buckets: EllBuckets):
    """(level_base, level_rows, level_K, row_vertex) of the concatenated
    per-level tables; row_vertex[r] is the vertex of concatenated row r."""
    level_rows = [n.shape[0] for n in buckets.nbr]
    level_K = [n.shape[1] for n in buckets.nbr]
    bases, base = [], 0
    for rows, k in zip(level_rows, level_K):
        bases.append(base)
        base += rows * k
    inv = buckets.inv_perm.cpu().numpy()
    row_vertex = np.empty(buckets.v_num, dtype=np.int64)
    row_vertex[inv] = np.arange(buckets.v_num)
    return bases, level_rows, level_K, row_vertex


def _edge_flat_slots(offsets, adj_dst, buckets: EllBuckets):
    """The flat slot (in the concatenated [rows, K] tables) of every edge
    of the direction's adjacency; a row's slots hold its edges in
    adjacency order."""
    bases, level_rows, level_K, _ = _flat_slot_layout(buckets)
    inv = buckets.inv_perm.cpu().numpy().astype(np.int64)
    row_starts = np.cumsum([0] + level_rows)
    level_of_row = np.searchsorted(row_starts, np.arange(row_starts[-1]), side="right") - 1
    k_within = np.arange(len(adj_dst)) - offsets[adj_dst]
    rows = inv[adj_dst]
    lv = level_of_row[rows]
    local_row = rows - row_starts[lv]
    return (np.asarray(bases)[lv] + local_row * np.asarray(level_K)[lv] + k_within).astype(
        np.int64
    )


@dataclasses.dataclass
class GatEllPair:
    """ELL tables plus the maps GAT's runtime weights need.

    ``fwd_row_vertex`` [V] int32: the destination vertex of concatenated
    forward row r. ``bwd_alpha_idx[l]`` [Nk_b, K_b] int32: the flat forward
    slot of each backward slot's edge (padding slots hold 0 and are masked
    by the backward table's zero weight). The rest is derived from those on
    the device: ``fwd_real`` (the forward tables' live slots), the
    backward map and mask flattened over all levels, and ``fwd_levels``
    [n_levels, 4] int64, each forward level's (nbr pointer, rows_vertex
    pointer, flat slot base, K): how the grad_alpha kernel finds the
    tables. ``grad_alpha_launches`` counts the kernel's launches."""

    pair: EllPair
    fwd_row_vertex: torch.Tensor
    bwd_alpha_idx: List[torch.Tensor]
    fwd_real: List[torch.Tensor] = dataclasses.field(repr=False)
    bwd_idx_flat: torch.Tensor = dataclasses.field(repr=False)
    bwd_real_flat: torch.Tensor = dataclasses.field(repr=False)
    fwd_levels: torch.Tensor = dataclasses.field(repr=False)
    grad_alpha_launches: int = 0

    @staticmethod
    def from_host(g: CSCGraph, device="cpu") -> "GatEllPair":
        return GatEllPair.from_pair(EllPair.from_host(g, device=device), g)

    @staticmethod
    def from_pair(pair: EllPair, g: CSCGraph) -> "GatEllPair":
        """Add the attention slot maps to a built EllPair (on its device)."""
        dev = pair.fwd.inv_perm.device
        bases_f, level_rows_f, level_K_f, fwd_row_vertex = _flat_slot_layout(pair.fwd)
        bases_b, level_rows_b, level_K_b, _ = _flat_slot_layout(pair.bwd)
        total_f = sum(r * k for r, k in zip(level_rows_f, level_K_f))
        total_b = sum(r * k for r, k in zip(level_rows_b, level_K_b))
        # the slot maps are int32 (half the index bytes of int64)
        if max(total_f, total_b) >= 2 ** 31:
            raise ValueError(
                f"GatEllPair slot space exceeds int32: fwd {total_f} / bwd "
                f"{total_b} padded slots >= 2^31"
            )
        fwd_slot_of_csc = _edge_flat_slots(
            g.column_offset, g.dst_of_edge.astype(np.int64), pair.fwd
        )
        # CSR edge -> CSC edge (multigraph-safe: a stable sort by (src, dst)
        # orders both edge lists the same way)
        a = np.lexsort((g.dst_of_edge.astype(np.int64), g.row_indices.astype(np.int64)))
        b = np.lexsort((g.column_indices.astype(np.int64), g.src_of_edge.astype(np.int64)))
        csc_of_csr = np.empty(g.e_num, dtype=np.int64)
        csc_of_csr[b] = a
        bwd_slot_of_csr = _edge_flat_slots(
            g.row_offset, g.src_of_edge.astype(np.int64), pair.bwd
        )
        flat_idx = np.zeros(total_b, dtype=np.int32)  # padding -> forward slot 0
        flat_idx[bwd_slot_of_csr] = fwd_slot_of_csc[csc_of_csr]
        idx_flat = torch.from_numpy(flat_idx).to(dev)
        bwd_alpha_idx = [
            idx_flat[base:base + rows * k].view(rows, k)
            for base, rows, k in zip(bases_b, level_rows_b, level_K_b)
        ]
        real_b = [w.reshape(-1) != 0 for w in pair.bwd.wgt]
        fwd_levels = torch.tensor(
            [[n.data_ptr(), rv.data_ptr(), base, n.shape[1]]
             for n, rv, base in zip(pair.fwd.nbr, pair.fwd.rows_vertex, bases_f)],
            dtype=torch.int64,
        ).reshape(-1, 4).to(dev)
        return GatEllPair(
            pair=pair,
            fwd_row_vertex=torch.from_numpy(fwd_row_vertex.astype(np.int32)).to(dev),
            bwd_alpha_idx=bwd_alpha_idx,
            fwd_real=[w != 0 for w in pair.fwd.wgt],
            bwd_idx_flat=idx_flat,
            bwd_real_flat=(torch.cat(real_b) if real_b
                           else torch.zeros(0, dtype=torch.bool, device=dev)),
            fwd_levels=fwd_levels,
        )

    def row_starts(self) -> List[int]:
        return np.cumsum([0] + [n.shape[0] for n in self.pair.fwd.nbr]).tolist()

    def transpose_alphas(self, alphas) -> List[torch.Tensor]:
        """The forward slots' weights laid out over the backward tables:
        slot (r, k) of backward level l gets alpha at ``bwd_alpha_idx``,
        0 on padding. One flat buffer, one contiguous view per level."""
        bwd = self.pair.bwd
        if not alphas:
            return []
        with annotate("nts.gat.transpose"):
            alpha_flat = torch.cat([a.reshape(-1) for a in alphas])
            if alpha_flat.numel():
                vals = alpha_flat.index_select(0, self.bwd_idx_flat)
                flat = torch.where(self.bwd_real_flat, vals, torch.zeros_like(vals))
            else:
                flat = alpha_flat.new_zeros(self.bwd_idx_flat.shape)
            return [part.view(n.shape) for part, n in
                    zip(torch.split(flat, [n.numel() for n in bwd.nbr]), bwd.nbr)]

    def grad_alphas(self, g: torch.Tensor, h: torch.Tensor) -> List[torch.Tensor]:
        """grad_alpha[r, k] = g[row_vertex[r]] . h[nbr[r, k]] per forward
        level, 0 on padding: the kernel on f32 CUDA tensors, the plain
        ``grad_alpha_level`` on CPU tensors (f32 products, cast to g's
        dtype)."""
        fwd = self.pair.fwd
        with annotate("nts.gat.grad_alpha"):
            if g.device.type == "cpu":
                return [a.to(g.dtype) for a in self.plain_grad_alphas(g, h)]
            flat = self._grad_alpha_kernel(g, h)
            return [part.view(n.shape) for part, n in
                    zip(torch.split(flat, [n.numel() for n in fwd.nbr]), fwd.nbr)]

    def plain_grad_alphas(self, g: torch.Tensor, h: torch.Tensor) -> List[torch.Tensor]:
        """The plain version on any device: ``grad_alpha_level`` per forward
        level, f32."""
        g_rows, starts = g[self.fwd_row_vertex], self.row_starts()
        return [grad_alpha_level(g_rows[starts[i]:starts[i + 1]], h, nbr, real)
                for i, (nbr, real) in enumerate(zip(self.pair.fwd.nbr, self.fwd_real))]

    def _grad_alpha_kernel(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The flat f32 slots of every forward level from ``csrc/ell_gat.cu``:
        one zero fill, then one launch over the forward aggregation's work
        list at h's width."""
        fwd = self.pair.fwd
        if g.device.type != "cuda":
            raise ValueError(f"grad_alphas runs on cuda or cpu tensors, got {g.device}")
        f = h.shape[1] if h.dim() == 2 else -1
        if g.dim() != 2 or g.shape != (fwd.v_num, f) or h.shape[0] != fwd.n_src:
            raise ValueError(f"grad_alphas needs g [{fwd.v_num}, f] and h [{fwd.n_src}, f], "
                             f"got {tuple(g.shape)} and {tuple(h.shape)}")
        for t in (g, h):
            if t.dtype != torch.float32:
                raise TypeError(f"grad_alphas on cuda takes float32, got {t.dtype}")
            if not t.is_contiguous() or t.device != self.fwd_levels.device:
                raise ValueError("grad_alphas needs contiguous g and h on the tables' device")
        out = torch.zeros(sum(n.numel() for n in fwd.nbr), dtype=torch.float32,
                          device=g.device)
        if f == 0:
            return out
        work = work_list(fwd, f)
        if not work.n_items:
            return out
        err = _build.load("ell_gat").nts_ell_gat_grad_alpha(
            self.fwd_levels.data_ptr(), work.items.data_ptr(), work.n_items,
            g.data_ptr(), h.data_ptr(), out.data_ptr(), f,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
        _build.check(err, f"ell_gat grad_alpha {work.n_items} items f={f}")
        self.grad_alpha_launches += 1
        return out


class GatherAlLevels(torch.autograd.Function):
    """Per-level ``al[nbr]`` over the forward tables; the transpose sums each
    vertex's slots as a row of the backward tables (``bwd_alpha_idx``)."""

    @staticmethod
    def forward(ctx, al, gep: GatEllPair):
        ctx.gep = gep
        return tuple(al[nbr] for nbr in gep.pair.fwd.nbr)

    @staticmethod
    def backward(ctx, *grads):
        gep = ctx.gep
        fwd, bwd = gep.pair.fwd, gep.pair.bwd
        dtype, dev = next((g.dtype, g.device) for g in grads if g is not None)
        with annotate("nts.gat.transpose"):
            g_flat = torch.cat([
                (g if g is not None else torch.zeros(n.shape, dtype=dtype, device=dev)
                 ).reshape(-1)
                for g, n in zip(grads, fwd.nbr)
            ])
            if g_flat.numel():
                vals = g_flat.index_select(0, gep.bwd_idx_flat)
                vals = torch.where(gep.bwd_real_flat, vals, torch.zeros_like(vals))
            else:
                vals = g_flat.new_zeros(gep.bwd_idx_flat.shape)
            parts = [
                part.view(n.shape).sum(dim=1)
                for part, n in zip(torch.split(vals, [n.numel() for n in bwd.nbr]), bwd.nbr)
            ]
            return torch.cat(parts)[bwd.inv_perm], None


def gat_ell_alpha(gep: GatEllPair, al: torch.Tensor, ar: torch.Tensor, slope: float):
    """Per-level attention weights: the masked softmax of
    leaky_relu(al[src] + ar[dst]) over each destination row's live slots,
    stabilised by the detached row max; a row with no live slot is 0.

    The gathers and each level's scores are the profiler scope
    ``nts.gat.scores``, each level's softmax (an empty level's zeros too)
    ``nts.gat.softmax``: one scope of each per level."""
    fwd = gep.pair.fwd
    starts = gep.row_starts()
    with annotate("nts.gat.scores"):
        al_levels = GatherAlLevels.apply(al, gep)
    alphas = []
    for i, (nbr, real) in enumerate(zip(fwd.nbr, gep.fwd_real)):
        if nbr.shape[1] == 0:
            with annotate("nts.gat.softmax"):
                alphas.append(torch.zeros(nbr.shape, dtype=al.dtype, device=al.device))
            continue
        with annotate("nts.gat.scores"):
            dst_v = gep.fwd_row_vertex[starts[i]:starts[i + 1]]
            e = torch.nn.functional.leaky_relu(al_levels[i] + ar[dst_v][:, None], slope)
            e = e.masked_fill(~real, NEG_INF)
        with annotate("nts.gat.softmax"):
            e = e - e.amax(dim=1, keepdim=True).detach()
            ex = torch.exp(e).masked_fill(~real, 0.0)
            alphas.append(ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-20))
    return alphas


def grad_alpha_level(
    g_lv: torch.Tensor, h: torch.Tensor, nbr: torch.Tensor, real: torch.Tensor
) -> torch.Tensor:
    """[Nk, K] f32 = g_lv[r] . h[nbr[r, k]] where the slot is live, else 0,
    in pieces of rows (and, for a row wider than the budget, of slots)
    whose [rows, slots, f] gather stays within ``_PLAIN_CHUNK_ELEMS``: the
    plain version of ``csrc/ell_gat.cu``."""
    n_rows, k = nbr.shape
    f = h.shape[1]
    out = torch.zeros((n_rows, k), dtype=torch.float32, device=h.device)
    row_step = max(1, _PLAIN_CHUNK_ELEMS // max(k * f, 1))
    k_step = min(k, max(1, _PLAIN_CHUNK_ELEMS // max(f, 1))) if k else 1
    for r0 in range(0, n_rows, row_step):
        gl = g_lv[r0:r0 + row_step].float()[:, :, None]
        for k0 in range(0, k, k_step):
            nb = nbr[r0:r0 + row_step, k0:k0 + k_step]
            out[r0:r0 + row_step, k0:k0 + k_step] = torch.bmm(h[nb].float(), gl)[:, :, 0]
    return out.masked_fill_(~real, 0.0)


def runtime_weighted_aggregate(
    gep: GatEllPair, alphas: List[torch.Tensor], h: torch.Tensor
) -> torch.Tensor:
    """out[v] = sum over v's forward row of alpha * h[nbr]: the ELL kernel on
    runtime weights, differentiable in h and in the alphas."""
    return EllWeightedAggregate.apply(
        h, gep.pair.fwd, gep.pair.bwd, gep.transpose_alphas, gep.grad_alphas, *alphas
    )


def gat_ell_attention_aggregate(
    gep: GatEllPair, h: torch.Tensor, al: torch.Tensor, ar: torch.Tensor, slope: float
) -> torch.Tensor:
    """The whole GAT graph-op chain over the ELL tables: scores -> per-row
    softmax -> weighted aggregate, [V, f] -> [V, f]."""
    return runtime_weighted_aggregate(gep, gat_ell_alpha(gep, al, ar, slope), h)
