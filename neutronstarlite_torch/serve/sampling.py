"""Serving-side sampling: per-request fan-out + inference embedding cache —
port of ``neutronstarlite_tpu/serve/sampling.py``.

Fresh-node fan-out reuses the training sampler (``sample/sampler.py``): one
Sampler per shape bucket, all sharing ONE injectable
``numpy.random.Generator``, so a serving run is reproducible end to end
from a single seed (and its host draws are the JAX package's, bitwise, from
the same Generator state).

The embedding cache is the serving instance of the hybrid dependency
management idea: a vertex's logits can be (1) recomputed fresh every
request — exact, pays sample+forward; or (2) served from a bounded LRU
cache — zero compute, bounded staleness. Which vertices are worth caching
follows the hot/cold split rule of the reference's training-side cache
(:func:`hot_vertex_mask`: out-degree >= threshold; a row referenced by many
consumers amortizes its cache slot). Staleness is bounded by
``cache_max_age_s``: entries older than that are recomputed. A graph delta
(serve/delta.py) swaps the graph under the running samplers
(``ServeSampler.set_graph``) and drops exactly the cache rows whose logits
it can change (``EmbeddingCache.invalidate``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.sample.sampler import SampledBatch, Sampler


def hot_vertex_mask(g: CSCGraph, threshold: int) -> np.ndarray:
    """[V] bool: ``out_degree >= threshold`` — the hot/cold split rule
    (the reference's ``parallel/feature_cache.hot_vertex_mask``): a
    high-out-degree vertex is referenced by many consumers, so its cached
    row amortizes."""
    return np.asarray(g.out_degree) >= threshold


class ServeSampler:
    """One training-equivalent Sampler per shape bucket, shared RNG."""

    def __init__(
        self,
        graph: CSCGraph,
        fanouts: Sequence[int],
        buckets: Sequence[int],
        seed: int = 0,
        rng: Optional[np.random.Generator] = None,
        hop_sampler=None,
    ):
        self.graph = graph
        self.fanouts = list(fanouts)
        self.hop_sampler = hop_sampler
        self.rng = np.random.default_rng(seed) if rng is None else rng
        # buckets share the injected Generator: draws interleave in request
        # order, so a serving trace replays bit-identically from one seed.
        # hop_sampler (SAMPLE_PIPELINE:device): the on-device uniform draw
        # (sample/device_sampler.py), shared across buckets too.
        self._samplers: Dict[int, Sampler] = {
            int(b): Sampler(
                graph, np.empty(0, np.int64), int(b), self.fanouts,
                rng=self.rng, hop_sampler=hop_sampler,
            )
            for b in buckets
        }
        self.buckets = sorted(self._samplers)

    def bucket_for(self, n_seeds: int) -> int:
        """Smallest bucket holding ``n_seeds`` (callers cap at max_batch ==
        the top bucket, so this always resolves)."""
        for b in self.buckets:
            if n_seeds <= b:
                return b
        raise ValueError(
            f"{n_seeds} seeds exceed the largest bucket {self.buckets[-1]}"
        )

    def node_caps(self, bucket: int) -> List[int]:
        return self._samplers[int(bucket)].node_caps

    def sample(self, bucket: int, seed_ids: np.ndarray) -> SampledBatch:
        return self._samplers[int(bucket)].sample_batch(seed_ids)

    def set_graph(self, graph: CSCGraph) -> None:
        """Swap in a post-delta host graph (serve/delta.py): every bucket
        Sampler re-points at the new structure; capacities/fanouts/rng
        are graph-independent and keep their state."""
        self.graph = graph
        for s in self._samplers.values():
            s.graph = graph


class EmbeddingCache:
    """Bounded LRU of per-vertex inference outputs with a staleness TTL.

    Thread-safe (the batcher flushes from its own thread while stats are
    read from clients). ``capacity <= 0`` disables everything — gets miss,
    puts drop — so callers never branch on "is there a cache".
    """

    def __init__(
        self,
        capacity: int,
        max_age_s: float = 60.0,
        hot_mask: Optional[np.ndarray] = None,
        clock=time.monotonic,
    ):
        self.capacity = int(capacity)
        self.max_age_s = float(max_age_s)
        # hot/cold split: only vertices flagged hot are cacheable; None =
        # every vertex (threshold 0 in hot_vertex_mask terms)
        self.hot_mask = hot_mask
        self.clock = clock
        self._lock = threading.Lock()
        self._rows: "OrderedDict[int, Tuple[float, np.ndarray]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self.invalidated = 0

    @classmethod
    def for_graph(cls, graph: CSCGraph, capacity: int, max_age_s: float,
                  hot_threshold: int) -> "EmbeddingCache":
        mask = (
            hot_vertex_mask(graph, hot_threshold) if hot_threshold > 0
            else None
        )
        return cls(capacity, max_age_s, hot_mask=mask)

    def lookup(self, vid: int) -> Optional[np.ndarray]:
        """Fresh cached row for ``vid`` or None (stale entries evict)."""
        if self.capacity <= 0:
            return None
        with self._lock:
            got = self._rows.get(int(vid))
            if got is None:
                self.misses += 1
                return None
            t, row = got
            if self.clock() - t > self.max_age_s:
                del self._rows[int(vid)]
                self.expired += 1
                self.misses += 1
                return None
            self._rows.move_to_end(int(vid))
            self.hits += 1
            return row

    def insert(self, vids: np.ndarray, rows: np.ndarray) -> int:
        """Cache freshly computed rows for the cache-eligible (hot) ids;
        returns how many were inserted. LRU-evicts beyond capacity."""
        if self.capacity <= 0:
            return 0
        now = self.clock()
        inserted = 0
        with self._lock:
            for vid, row in zip(np.asarray(vids).tolist(), rows):
                if self.hot_mask is not None and not self.hot_mask[vid]:
                    continue
                self._rows[int(vid)] = (now, np.asarray(row))
                self._rows.move_to_end(int(vid))
                inserted += 1
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
        return inserted

    def invalidate(self, vids) -> int:
        """Drop the cached rows for exactly ``vids`` (the graph-delta
        dirty set, serve/delta.py) — entries for untouched vertices keep
        hitting; returns how many entries were actually dropped."""
        if self.capacity <= 0:
            return 0
        n = 0
        with self._lock:
            for vid in np.asarray(vids, dtype=np.int64).tolist():
                if self._rows.pop(int(vid), None) is not None:
                    n += 1
            self.invalidated += n
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._rows),
                "hits": self.hits,
                "misses": self.misses,
                "expired": self.expired,
                "invalidated": self.invalidated,
            }
