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

Left for the stream slice: ``reserve_capacity`` and ``apply_delta`` (the
table's growth margin and in-place patches after a graph delta).
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
            order = np.lexsort((prio, dst))
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
