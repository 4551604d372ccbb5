"""Fan-out neighbour sampler producing padded, static-shape batch subgraphs
— port of ``neutronstarlite_tpu/sample/sampler.py`` (its NumPy path).

Per hop, each destination keeps up to ``fanout`` distinct in-neighbours,
drawn uniformly without replacement: the candidates of every destination get
random priorities and the ``fanout`` smallest are kept (the reference's
reservoir distribution). Sources are deduplicated and remapped to
batch-local indices (``np.unique`` + ``np.searchsorted``), and every batch is
padded to fixed capacities (``batch_size`` times the fanout products), so the
train step sees one shape for every batch. Padding edges carry weight 0 and
indices 0; padding seeds are masked out of the loss.

``hops[0]`` is the innermost (input) hop; the seeds are the destinations of
the last hop, and ``nodes[0]`` are the input vertices whose features feed
the network. Edges of a hop come grouped by destination, ascending, at most
``fanout`` per destination: ``ops/minibatch.py`` relies on it.

The JAX sampler also has a native reservoir sampler that seeds its own
PRNG; the port has no native code, so its draws are those of the JAX
sampler with ``use_native=False``, bitwise, from the same seed or the same
injected Generator. ``hop_sampler`` (``sample/device_sampler.py``) replaces
the per-hop draw only (``SAMPLE_PIPELINE:device``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from neutronstarlite_torch.graph.storage import CSCGraph


@dataclasses.dataclass
class SampledHop:
    """One hop's batch-local edge list."""

    src_local: np.ndarray  # [Ecap] index into the previous layer's node list
    dst_local: np.ndarray  # [Ecap] index into this layer's node list
    weight: np.ndarray  # [Ecap] float32, 0 on padding
    n_dst: int  # real destination count (<= dst capacity)


@dataclasses.dataclass
class SampledBatch:
    """Padded multi-hop subgraph for one seed batch."""

    nodes: List[np.ndarray]  # per layer: padded global vertex ids
    hops: List[SampledHop]  # len == n_layers; hops[l]: nodes[l] -> nodes[l+1]
    seed_mask: np.ndarray  # [B] 1.0 on real seeds, 0.0 on padding
    seeds: np.ndarray  # [B] padded global seed ids


def node_capacities(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Per-layer node capacities, input layer first: ``caps[-1]`` is the
    batch size and ``caps[h] = caps[h + 1] * fanouts[h]``."""
    caps = [int(batch_size)]
    for f in reversed(list(fanouts)):
        caps.append(caps[-1] * int(f))
    return list(reversed(caps))


class Sampler:
    """Per-epoch batch sampler over a set of seed vertices (one per mask
    split: train, eval, test)."""

    def __init__(
        self,
        graph: CSCGraph,
        seed_nids: np.ndarray,
        batch_size: int,
        fanouts: Sequence[int],
        seed: int = 0,
        rng: Optional[np.random.Generator] = None,
        hop_sampler=None,
    ):
        self.graph = graph
        self.hop_sampler = hop_sampler
        self.seed_nids = np.asarray(seed_nids, dtype=np.int64)
        self.batch_size = batch_size
        # fanouts listed as in the cfg; hop h (input -> output) uses
        # fanouts[h], so the seed-adjacent hop takes the last entry
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed) if rng is None else rng
        self.node_caps = node_capacities(batch_size, self.fanouts)

    def _sample_neighbors(self, dsts: np.ndarray, fanout: int, cap=None):
        """(src, dst_idx): for each dst, up to ``fanout`` distinct
        in-neighbours chosen uniformly. ``cap`` is the hop's static dst
        capacity, which only the device hop sampler needs."""
        g = self.graph
        if self.hop_sampler is not None:
            return self.hop_sampler.sample_neighbors(
                np.asarray(dsts, np.int64), fanout, self.rng, cap=cap
            )
        deg = g.in_degree[dsts].astype(np.int64)
        starts = g.column_offset[dsts]
        total = int(deg.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        # candidate edge list: all in-edges of all dsts
        dst_idx = np.repeat(np.arange(len(dsts)), deg)
        within = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
        cand_src = g.row_indices[(np.repeat(starts, deg) + within).astype(np.int64)]
        # random priority per candidate; keep the fanout smallest per segment
        prio = self.rng.random(total)
        order = np.lexsort((prio, dst_idx))
        seg_start = np.repeat(np.cumsum(deg) - deg, deg)
        rank = np.arange(total) - seg_start  # position within segment, post-sort
        keep = order[rank < fanout]
        return cand_src[keep].astype(np.int64), dst_idx[keep]

    def _make_batch(self, seeds: np.ndarray) -> SampledBatch:
        B = self.batch_size
        n_real = len(seeds)
        seeds_pad = np.zeros(B, dtype=np.int64)
        seeds_pad[:n_real] = seeds
        seed_mask = np.zeros(B, dtype=np.float32)
        seed_mask[:n_real] = 1.0

        g = self.graph
        nodes: List[Optional[np.ndarray]] = [None] * (len(self.fanouts) + 1)
        hops: List[Optional[SampledHop]] = [None] * len(self.fanouts)
        nodes[-1] = seeds_pad
        cur_nodes = seeds  # real (unpadded) dst set, outermost layer
        cur_count = n_real
        for h in range(len(self.fanouts) - 1, -1, -1):
            fanout = self.fanouts[h]
            src, dst_idx = self._sample_neighbors(
                cur_nodes, fanout, cap=self.node_caps[h + 1]
            )
            uniq = np.unique(src)
            src_local = np.searchsorted(uniq, src)
            # per-edge weight: the full-graph GCN norm over the original degrees
            d_out = np.maximum(g.out_degree[src], 1).astype(np.float64)
            d_in = np.maximum(g.in_degree[cur_nodes[dst_idx]], 1).astype(np.float64)
            w = (1.0 / np.sqrt(d_out * d_in)).astype(np.float32)

            ecap = self.node_caps[h + 1] * fanout
            hops[h] = SampledHop(
                src_local=_pad(src_local, ecap),
                dst_local=_pad(dst_idx, ecap),
                weight=_pad(w, ecap),
                n_dst=cur_count,
            )
            ncap = self.node_caps[h]
            if len(uniq) > ncap:
                raise AssertionError(
                    f"hop {h}: {len(uniq)} unique sources exceed capacity {ncap}"
                )
            nodes[h] = _pad(uniq, ncap)
            cur_nodes = uniq
            cur_count = len(uniq)
        return SampledBatch(
            nodes=list(nodes), hops=list(hops), seed_mask=seed_mask, seeds=seeds_pad
        )

    def sample_epoch(self, shuffle: bool = True):
        """Yield a SampledBatch for every seed batch (the work-queue walk)."""
        nids = self.seed_nids.copy()
        if shuffle:
            self.rng.shuffle(nids)
        for lo in range(0, len(nids), self.batch_size):
            yield self._make_batch(nids[lo: lo + self.batch_size])


def _pad(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: min(len(arr), n)] = arr[:n] if len(arr) > n else arr
    return out
