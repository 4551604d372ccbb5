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

As in JAX, the draw is native by default (``native/``: one xorshift64*
stream per (seed, destination), reservoir or Floyd per degree, and the
hash dedup), bitwise the JAX native sampler on the same host graph and
seed whatever the thread count. ``use_native=False``, an injected
Generator or a ``hop_sampler`` take the NumPy draw, bitwise the JAX sampler
with ``use_native=False`` from the same seed or Generator; ``use_native=True``
refuses an injected Generator or a ``hop_sampler`` (JAX's two refusals).
``hop_sampler`` (``sample/device_sampler.py``) replaces the per-hop draw
only (``SAMPLE_PIPELINE:device``). Either draw reads a destination's
edges in the host graph's order: a native graph and a NumPy graph of one
edge list draw differently from one seed (``graph/storage.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from neutronstarlite_torch import native
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
        use_native: Optional[bool] = None,
        rng: Optional[np.random.Generator] = None,
        hop_sampler=None,
    ):
        self.graph = graph
        self.hop_sampler = hop_sampler
        if hop_sampler is not None:
            if use_native:
                raise ValueError(
                    "use_native=True cannot combine with a device hop_sampler; "
                    "pass one or the other"
                )
            use_native = False
        if use_native and rng is not None:
            # the native sampler seeds its own streams from ``seed`` and
            # would ignore the injected Generator
            raise ValueError(
                "use_native=True cannot honor an injected rng; pass one or the other"
            )
        if use_native is None:
            use_native = native.available() if rng is None else False
        self.use_native = native.resolve(use_native)
        self._native_seed = seed
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
        if self.use_native:
            self._native_seed += 1
            return native.sample_hop(
                g.column_offset, g.row_indices, np.asarray(dsts, np.int64),
                fanout, self._native_seed,
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
            # dedup + batch-local remap: the same sorted-unique result
            # either way
            if self.use_native:
                uniq, src_local = native.dedup_remap(src)
            else:
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

    def sample_batch(self, seeds) -> SampledBatch:
        """One padded batch for an arbitrary seed set (<= batch_size): the
        online-serving entry point (serve/sampling.py), a request's fresh
        fan-out at the training capacities and distribution."""
        seeds = np.asarray(seeds, dtype=np.int64)
        if seeds.ndim != 1 or len(seeds) == 0:
            raise ValueError("sample_batch needs a non-empty 1-D seed array")
        if len(seeds) > self.batch_size:
            raise ValueError(
                f"{len(seeds)} seeds exceed this sampler's batch capacity "
                f"{self.batch_size}"
            )
        return self._make_batch(seeds)

    def sample_epoch(self, shuffle: bool = True):
        """Yield a SampledBatch for every seed batch (the work-queue walk)."""
        nids = self.seed_nids.copy()
        if shuffle:
            self.rng.shuffle(nids)
        for lo in range(0, len(nids), self.batch_size):
            yield self._make_batch(nids[lo: lo + self.batch_size])


def dirty_biased_seeds(
    seed_nids: np.ndarray,
    dirty: np.ndarray,
    n: int,
    dirty_frac: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Draw ``n`` training seeds biased toward the dirty region.

    The continuous fine-tune worker's seed policy (stream/finetune.py):
    roughly ``dirty_frac`` of the draw comes from ``seed_nids ∩ dirty``
    (the vertices whose aggregation inputs a delta changed — where the
    model is most stale), the rest uniformly from the remaining seeds so
    the update never forgets the clean region. Without replacement
    within each pool; short pools spill into the other so the draw
    always returns ``min(n, len(seed_nids))`` distinct seeds. The same
    Generator state gives the reference's draw, bitwise.
    """
    seed_nids = np.asarray(seed_nids, dtype=np.int64)
    n = int(min(n, len(seed_nids)))
    if n <= 0:
        return np.empty(0, np.int64)
    dirty = np.asarray(dirty, dtype=np.int64)
    is_dirty = np.isin(seed_nids, dirty)
    pool_d = seed_nids[is_dirty]
    pool_c = seed_nids[~is_dirty]
    want_d = int(min(round(n * float(dirty_frac)), len(pool_d)))
    want_c = min(n - want_d, len(pool_c))
    # spill: a short clean pool refills from dirty (and vice versa above)
    want_d = min(n - want_c, len(pool_d))
    take_d = rng.choice(pool_d, size=want_d, replace=False) \
        if want_d else np.empty(0, np.int64)
    take_c = rng.choice(pool_c, size=want_c, replace=False) \
        if want_c else np.empty(0, np.int64)
    out = np.concatenate([take_d, take_c]).astype(np.int64)
    rng.shuffle(out)
    return out


def _pad(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: min(len(arr), n)] = arr[:n] if len(arr) > n else arr
    return out
