"""Uniform neighbour sampling on the device over a fixed-width neighbour table
— port of ``neutronstarlite_tpu/sample/device_sampler.py``.

Layout: a padded neighbour table ``nbr [V, D]`` (int32, D = min(max
in-degree, ``NTS_SAMPLE_DEVICE_MAX_DEG``, 512)) and the effective degree
``eff_deg [V]``. Vertices with more than D in-neighbours are pre-thinned to
D at the table build, uniformly (host-side, seeded, once), as in JAX;
within the table every draw is uniform without replacement: each slot gets
a priority, padding slots are priced above every real one, and the
``fanout`` smallest are kept (the host sampler's construction).

The draw (``_hop``): JAX uses ``jax.random.uniform`` priorities. The port
hashes a counter instead: a 32-bit integer mix (``mix32``) of the draw's key
and each slot's position gives the priority's top bits, and the slot index
fills the low bits, so no two keys of a row tie. It keeps no generator
state, so it can be captured in a CUDA graph (``sample/fused.py``), and it
gives the same draws on the CPU and on the card. Each ``sample_neighbors``
call takes its key from the caller's numpy Generator (the Sampler's
per-batch generator), so ``SAMPLE_PIPELINE:device`` is reproducible per
(epoch, batch), and distribution-equivalent, not bitwise equal, to the host
sampler.

A live graph (``serve/delta.py``): ``reserve_capacity`` adds slack rows
with ``eff_deg`` 0 (a vertex append patches them), and ``apply_delta``
rewrites only the rows whose in-neighbour set changed. Both write into the
table's own storage wherever its shape allows: a CUDA graph captured over
``nbr``/``eff_deg`` (the fused serving buckets) reads them by address, so
a table that JAX would replace by a new array of the same shape is
rewritten in place instead, and a rebuild keeps the physical row capacity
when the post-delta graph fits it (JAX re-arms the margin beyond the new V;
the slack rows are unreachable either way). Only a wider table, or more
vertices than rows, makes new tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("device_sampler")

MASK32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x2C1B3C6D  # odd, < 2**31: x * M stays inside int64
PAD_KEY = 1 << 32  # above every real key: the priority of a padding slot


def mix32(x):
    """A 32-bit integer hash (xor-shift-multiply rounds) of an int or an
    int64 tensor of values in [0, 2**32); the same bits on any device."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def fold(key, *values):
    """A key folded with each value in turn (ints or 0-dim int64 tensors,
    as in ``jax.random.fold_in``): a device scalar in, a device scalar out."""
    for v in values:
        key = mix32(key ^ mix32(v))
    return key


def hash_bits(key, shape, device) -> torch.Tensor:
    """[shape] int64 of 32 hashed bits per element, from the element's
    row-major position and ``key``."""
    n = 1
    for s in shape:
        n *= int(s)
    pos = torch.arange(n, dtype=torch.int64, device=device).view(*shape)
    return mix32(mix32(pos) ^ key)


def _hop(nbr: torch.Tensor, eff_deg: torch.Tensor, key, dsts: torch.Tensor, fanout: int):
    """One uniform without-replacement draw for every dst row: the k
    smallest of per-slot priorities, padding slots priced out at PAD_KEY.
    Returns (src [B, k] int64, valid [B, k] bool), k = min(fanout, D)."""
    rows = nbr[dsts]  # [B, D]
    eff = eff_deg[dsts]  # [B]
    B, D = rows.shape
    slot_bits = max(1, (D - 1).bit_length())
    slot = torch.arange(D, dtype=torch.int64, device=rows.device)
    prio = hash_bits(key, (B, D), rows.device)
    keys = ((prio >> slot_bits) << slot_bits) | slot
    keys = torch.where(slot[None, :] < eff[:, None], keys, PAD_KEY | slot)
    k = min(int(fanout), D)
    chosen, idx = torch.topk(keys, k, dim=1, largest=False, sorted=True)
    src = torch.gather(rows, 1, idx).long()
    return src, chosen < PAD_KEY


def _segment_order(prio: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """The permutation that sorts each destination's run of ``prio`` (the
    runs are consecutive, of lengths ``deg``) stably, runs kept in order:
    ``np.lexsort((prio, dst))`` for a sorted ``dst``, without the global
    two-key sort (a stable sort per run is several times faster on a
    graph of millions of edges, and a delta on a thinned table runs it)."""
    order = np.arange(len(prio), dtype=np.int64)
    ends = np.cumsum(deg)
    for v in np.nonzero(deg > 1)[0].tolist():
        lo, hi = int(ends[v] - deg[v]), int(ends[v])
        order[lo:hi] = lo + np.argsort(prio[lo:hi], kind="stable")
    return order


def default_max_width() -> int:
    raw = os.environ.get("NTS_SAMPLE_DEVICE_MAX_DEG", "")
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            log.warning("NTS_SAMPLE_DEVICE_MAX_DEG=%r is not an int; using 512", raw)
    return 512


class DeviceUniformSampler:
    """Fixed-width neighbour table on the device and the per-hop draw."""

    def __init__(self, nbr: np.ndarray, eff_deg: np.ndarray, width: int, thinned: int,
                 device=None):
        self.width = int(width)
        self.thinned = int(thinned)  # vertices whose neighbour set was capped
        self.nbr = torch.from_numpy(nbr).to(device)  # [V, D] int32
        self.eff_deg = torch.from_numpy(eff_deg).to(device)  # [V] int32
        # row-capacity margin (stream/ingest): slack rows beyond V with
        # eff_deg 0, never drawn from until a vertex append claims them
        self.margin = 0

    def reserve_capacity(self, extra_rows: int) -> None:
        """Pre-size the table with ``extra_rows`` slack rows, so that vertex
        appends within the margin patch rows in place instead of forcing a
        full rebuild (the stream ingestion contract). Slack rows carry
        eff_deg 0, so no draw reads them until a delta's dirty_rows patch
        claims them. New tensors: call it before anything captures them."""
        extra = int(extra_rows)
        if extra <= 0:
            return
        self.margin = max(self.margin, extra)
        self.nbr = torch.cat([self.nbr, self.nbr.new_zeros((extra, self.nbr.shape[1]))])
        self.eff_deg = torch.cat([self.eff_deg, self.eff_deg.new_zeros(extra)])

    @classmethod
    def from_host(cls, graph: CSCGraph, max_width: Optional[int] = None, seed: int = 0,
                  device=None) -> "DeviceUniformSampler":
        cap = default_max_width() if max_width is None else max(int(max_width), 1)
        deg = graph.in_degree.astype(np.int64)
        v_num = graph.v_num
        D = int(min(max(deg.max() if len(deg) else 1, 1), cap))
        total = int(deg.sum())
        # slot of every edge within its destination's run; edge positions
        # go through column_offset
        within = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
        starts = graph.column_offset[:-1].astype(np.int64)
        pos = np.repeat(starts, deg) + within
        src = graph.row_indices[pos].astype(np.int64)
        dst = np.repeat(np.arange(v_num), deg)
        thinned = int((deg > D).sum())
        if thinned:
            # pre-thin over-capacity vertices uniformly (the host sampler's
            # random-priority ranking, seeded once)
            prio = np.random.default_rng(seed).random(total)
            order = _segment_order(prio, deg)  # == np.lexsort((prio, dst)): dst is sorted
            rank = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
            keep = order[rank < D]
            src, dst = src[keep], dst[keep]
            eff = np.minimum(deg, D)
            within = np.arange(len(src)) - np.repeat(np.cumsum(eff) - eff, eff)
            log.warning(
                "device sampler: %d vertices exceed the %d-wide neighbour table; "
                "their neighbour sets are pre-thinned uniformly at build "
                "(NTS_SAMPLE_DEVICE_MAX_DEG raises the cap)", thinned, D,
            )
        else:
            eff = deg
        nbr = np.zeros((v_num, D), dtype=np.int32)
        nbr[dst, within] = src.astype(np.int32)
        return cls(nbr, eff.astype(np.int32), D, thinned, device=device)

    def apply_delta(self, graph: CSCGraph, rows, seed: int = 0) -> int:
        """Patch ONLY the neighbour-table rows a graph delta touched
        (serve/delta.py ``dirty_rows``: vertices whose in-neighbour set
        changed): each is regathered from the post-delta host CSC and
        written into the table in place. A full rebuild (logged) when the
        reference rebuilds: more vertices than rows, a dirty row or the
        max in-degree outgrowing a width below the NTS_SAMPLE_DEVICE_MAX_DEG
        cap, or a table holding pre-thinned rows (their kept subsets come
        from one global priority stream over the edge layout, which a
        delta shifts; the bitwise fresh-table oracle demands the rebuilt
        form). A rebuild of the same width that fits the rows is written in
        place too. Returns the number of rows written (V on a rebuild)."""
        rows = np.unique(np.asarray(rows, dtype=np.int64))
        cap = default_max_width()
        max_deg = int(graph.in_degree.max()) if graph.v_num else 1
        needed = int(min(max(max_deg, 1), cap))
        rows_over = len(rows) > 0 and int(graph.in_degree[rows].max()) > self.width
        capacity = int(self.nbr.shape[0])
        if graph.v_num > capacity or needed > self.width or rows_over or self.thinned > 0:
            log.warning(
                "device sampler: delta changed the table shape or touched a pre-thinned "
                "row (V %d -> %d, width %d -> %d); rebuilding the full neighbour table",
                capacity, graph.v_num, self.width, needed,
            )
            fresh = DeviceUniformSampler.from_host(graph, seed=seed)
            if fresh.width == self.width and graph.v_num <= capacity:
                v = graph.v_num  # the rows past V stay slack
                self.nbr[:v].copy_(fresh.nbr)
                self.nbr[v:].zero_()
                self.eff_deg[:v].copy_(fresh.eff_deg)
                self.eff_deg[v:].zero_()
            else:
                dev = self.nbr.device
                self.nbr, self.eff_deg = fresh.nbr.to(dev), fresh.eff_deg.to(dev)
                if self.margin:
                    margin, self.margin = self.margin, 0
                    self.reserve_capacity(margin)  # keep the slack armed
            self.width, self.thinned = fresh.width, fresh.thinned
            return graph.v_num
        if len(rows) == 0:
            return 0
        D = self.width
        patch = np.zeros((len(rows), D), dtype=np.int32)
        eff = graph.in_degree[rows].astype(np.int32)  # all <= D here
        for j, v in enumerate(rows.tolist()):
            start = int(graph.column_offset[v])
            d = int(graph.in_degree[v])
            patch[j, :d] = graph.row_indices[start:start + d]
        idx = torch.from_numpy(rows).to(self.nbr.device)
        self.nbr.index_copy_(0, idx, torch.from_numpy(patch).to(self.nbr.device))
        self.eff_deg.index_copy_(0, idx, torch.from_numpy(eff).to(self.nbr.device))
        return int(len(rows))

    def sample_neighbors(self, dsts: np.ndarray, fanout: int, rng: np.random.Generator,
                         cap: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Drop-in for Sampler._sample_neighbors: (src global ids, dst
        batch-local indices) for up to ``fanout`` distinct uniform
        in-neighbours per dst, grouped by dst. ``cap`` pads the dst set to
        the hop's static capacity."""
        n_real = len(dsts)
        B = int(cap) if cap is not None else n_real
        if n_real > B:
            raise ValueError(f"{n_real} dsts exceed the static cap {B}")
        dsts_pad = np.zeros(B, dtype=np.int64)
        dsts_pad[:n_real] = dsts
        key = int(rng.integers(0, 2**31 - 1))
        dev = self.nbr.device
        src, valid = _hop(self.nbr, self.eff_deg, key,
                          torch.from_numpy(dsts_pad).to(dev), fanout)
        src = src.cpu().numpy()
        valid = valid.cpu().numpy()
        valid[n_real:] = False  # padded dst rows are not real draws
        dst_idx = np.broadcast_to(np.arange(B, dtype=np.int64)[:, None], src.shape)
        keep = valid.ravel()
        return src.ravel()[keep], dst_idx.ravel()[keep]
