"""Replication and caching of hot mirror rows (DepCache) — port of
``neutronstarlite_tpu/parallel/feature_cache.py``.

A mirror row can be had three ways: fetched fresh every layer (the
``all_to_all`` of ``dist_edge_ops.dist_get_dep_nbr``); for layer 0's raw
features, which never change, replicated once into the consumer's memory
(exact); for deeper layers, kept from the last fetch and refreshed every
``CACHE_REFRESH`` epochs (no gradient flows through a stale row). A slot
is hot when its source's out-degree is at least the replication
threshold (``hot_vertex_mask``).

``CachedMirrorGraph`` is a ``MirrorGraph`` whose per-(p, q) slots are
ordered hot first: slots ``[0, mc)`` the cached group, ``[mc, mc + mf)``
the fetched one (both capacities maxima over pairs, padded to 8). The edge
lists index the combined ``[P*(mc + mf)]`` mirror space, so every edge op
works on it unchanged, and ``need_ids`` is the two groups' concatenation,
so the full fetch works too (refresh epochs use it).
``dist_get_dep_nbr_partial`` ships only the fetched group (P*mf rows
instead of P*mb) and splices in the cached rows; ``dist_fetch_cached_rows``
fetches the hot slots fresh. Each has its twin (``group=None``).
``choose_replication_threshold`` (``REP_THRESHOLD:auto``) picks the
smallest threshold whose cached rows fit a per-rank byte budget, by binary
search over the distinct mirror out-degrees. Every table is bitwise JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.parallel.dist_edge_ops import _ids, all_to_all_gather
from neutronstarlite_torch.parallel.mirror import (
    MirrorGraph,
    _owners,
    build_local_edge_lists,
)
from neutronstarlite_torch.parallel.vertex_space import round_up
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("feature_cache")


def hot_vertex_mask(g: CSCGraph, threshold: int) -> np.ndarray:
    """[V] bool: ``out_degree >= threshold``, the hot/cold rule."""
    return np.asarray(g.out_degree) >= threshold


def _mirror_pass1(g: CSCGraph, P: int, lane_pad: int = 8):
    """``mirror._owners``'s (offsets, vp, src, dst, p, q) of every edge,
    its pair key ``(p*P + q)*V + src`` and ``u``, the sorted deduplicated
    (consumer p, owner q, source) mirror set."""
    offsets, vp, src, dst, p_of_edge, q_of_edge = _owners(g, P, lane_pad)
    pair = (p_of_edge * P + q_of_edge) * g.v_num + src
    return offsets, vp, src, dst, p_of_edge, q_of_edge, pair, np.unique(pair)


@dataclasses.dataclass
class CachedMirrorGraph(MirrorGraph):
    """A MirrorGraph with hot-first slots and the cache's gather tables."""

    mc: int = 0  # cached (hot) slots per (p, q) pair
    mf: int = 0  # fetched (cold) slots per (p, q) pair
    replication_threshold: int = 0
    cached_global: np.ndarray = None  # [P(p), P(q), mc] global source id, -1 on padding
    cached_ids: np.ndarray = None  # [P(q), P(p), mc] q-local ids of the cached slots
    fetch_ids: np.ndarray = None  # [P(q), P(p), mf] q-local ids of the fetched slots
    fetch_real: np.ndarray = None  # [P(q), P(p), mf] True on real fetched slots

    @property
    def cached_fraction(self) -> float:
        """Fraction of the real mirror slots served from the cache."""
        hot = int((self.cached_global >= 0).sum())
        return hot / max(hot + int(self.fetch_real.sum()), 1)

    @staticmethod
    def choose_replication_threshold(g: CSCGraph, partitions: int, feature_size: int,
                                     budget_bytes: int, lane_pad: int = 8,
                                     itemsize: int = 4) -> int:
        """The smallest out-degree threshold whose per-rank cached bytes
        ``P * round_up(mc, lane_pad) * feature_size * itemsize`` fit
        ``budget_bytes`` (``mc`` only grows as the threshold falls)."""
        P = partitions
        u = _mirror_pass1(g, P)[-1]
        u_pq, u_deg = u // g.v_num, g.out_degree[u % g.v_num].astype(np.int64)
        order = np.lexsort((u_deg, u_pq))
        u_pq_s, u_deg_s = u_pq[order], u_deg[order]
        starts = np.concatenate([[0], np.cumsum(np.bincount(u_pq_s, minlength=P * P))])
        pair_degs = [u_deg_s[starts[k]: starts[k + 1]] for k in range(P * P)]

        def cached_bytes(t: int) -> int:
            mc = max(len(d) - int(np.searchsorted(d, t, side="left")) for d in pair_degs)
            mc = round_up(mc, lane_pad) if mc else 0
            return P * mc * feature_size * itemsize

        cands = np.unique(u_deg)
        if len(cands) == 0:
            t = int(g.out_degree.max(initial=0)) + 1
            log.info("auto replication threshold: no mirrors, t=%d", t)
            return t
        lo, hi = 0, len(cands)  # invariant: cands[hi:] fit
        if cached_bytes(int(cands[0])) <= budget_bytes:
            hi = 0
        else:
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if cached_bytes(int(cands[mid])) <= budget_bytes:
                    hi = mid
                else:
                    lo = mid
        t = int(cands[-1]) + 1 if hi == len(cands) else int(cands[hi])
        log.info("auto replication threshold: t=%d (cached bytes/device %d of budget %d, "
                 "candidates %d)", t, cached_bytes(t), budget_bytes, len(cands))
        return t

    @staticmethod
    def build(g: CSCGraph, partitions: int, replication_threshold: int = 0,
              lane_pad: int = 8) -> "CachedMirrorGraph":
        """MirrorGraph.build with each pair's slots split hot first by
        ``out_degree >= replication_threshold``."""
        P = partitions
        offsets, vp, src, dst, p_of_edge, q_of_edge, pair, u = _mirror_pass1(g, P, lane_pad)
        u_pq, u_src = u // g.v_num, u % g.v_num
        w = g.edge_weight_forward.astype(np.float32)

        u_hot = hot_vertex_mask(g, replication_threshold)[u_src]
        pq_counts = np.bincount(u_pq, minlength=P * P)
        u_starts = np.concatenate([[0], np.cumsum(pq_counts)])
        hot_counts = np.zeros(P * P, dtype=np.int64)
        cold_counts = np.zeros(P * P, dtype=np.int64)
        slot_of_unique = np.zeros(len(u), dtype=np.int64)
        for k in np.nonzero(pq_counts)[0]:
            lo, hi = u_starts[k], u_starts[k + 1]
            h = u_hot[lo:hi]
            nh = int(h.sum())
            nc = (hi - lo) - nh
            hot_counts[k], cold_counts[k] = nh, nc
            s = np.zeros(hi - lo, dtype=np.int64)
            s[h] = np.arange(nh)
            s[~h] = np.arange(nc)  # the cold offset (mc) is added once mc is known
            slot_of_unique[lo:hi] = s

        mc = round_up(int(hot_counts.max()), lane_pad) if hot_counts.max() else 0
        mf = round_up(max(int(cold_counts.max()), 1), lane_pad)
        mb = mc + mf
        slot_of_unique[~u_hot] += mc

        cached_ids = np.zeros((P, P, max(mc, 1)), dtype=np.int32)[:, :, :mc]
        fetch_ids = np.zeros((P, P, mf), dtype=np.int32)
        fetch_real = np.zeros((P, P, mf), dtype=bool)
        cached_global = np.full((P, P, max(mc, 1)), -1, dtype=np.int64)[:, :, :mc]
        for k in np.nonzero(pq_counts)[0]:
            p, q = divmod(int(k), P)
            lo, hi = u_starts[k], u_starts[k + 1]
            h = u_hot[lo:hi]
            loc = (u_src[lo:hi] - offsets[q]).astype(np.int32)
            nh, nc = int(hot_counts[k]), int(cold_counts[k])
            if nh:
                cached_ids[q, p, :nh] = loc[h]
                cached_global[p, q, :nh] = u_src[lo:hi][h]
            if nc:
                fetch_ids[q, p, :nc] = loc[~h]
                fetch_real[q, p, :nc] = True
        need_ids = np.concatenate([cached_ids, fetch_ids], axis=2)

        slot_in_pair = slot_of_unique[np.searchsorted(u, pair)]
        slot_global = q_of_edge * mb + slot_in_pair
        edge_src_slot, edge_dst, edge_weight, edge_mask = build_local_edge_lists(
            P, vp, offsets, p_of_edge, slot_global, dst, w)
        return CachedMirrorGraph(
            partitions=P, vp=vp, mb=mb, offsets=offsets, need_ids=need_ids,
            edge_src_slot=edge_src_slot, edge_dst=edge_dst, edge_weight=edge_weight,
            edge_mask=edge_mask, e_num=g.e_num, v_num=g.v_num, mc=mc, mf=mf,
            replication_threshold=replication_threshold, cached_global=cached_global,
            cached_ids=cached_ids, fetch_ids=fetch_ids, fetch_real=fetch_real,
        )

    def replicate_rows(self, vertex_array: np.ndarray) -> np.ndarray:
        """Each consumer's cached rows from a host [V, f] array: the
        consumer-major ``[P, P*mc, f]`` cache (zeros on padding slots)."""
        P, mc = self.partitions, self.mc
        out = np.zeros((P, P * mc, vertex_array.shape[1]), dtype=vertex_array.dtype)
        if mc == 0:
            return out
        ids = self.cached_global.reshape(P, P * mc)
        valid = ids >= 0
        out[valid] = vertex_array[ids[valid]]
        return out


class CacheExchange:
    """The DepCache exchanges' gather tables over ``group`` (None: the
    twin): on a rank ``fetch`` / ``cached`` (its ``fetch_ids`` /
    ``cached_ids`` rows, consumer-major); in the twin each fetched and each
    cached mirror row's source row in the full ``[P*vp]`` x."""

    def __init__(self, cmg: CachedMirrorGraph, group=None, device="cpu"):
        self.cmg, self.group = cmg, group
        P, vp = cmg.partitions, cmg.vp
        if group is None:
            q = np.arange(P, dtype=np.int64)[None, :, None] * vp
            self.fetch = _ids((q + cmg.fetch_ids.transpose(1, 0, 2)).reshape(-1), device)
            self.cached = _ids((q + cmg.cached_ids.transpose(1, 0, 2)).reshape(-1), device)
        else:
            self.fetch = _ids(cmg.fetch_ids[group.rank].reshape(-1), device)
            self.cached = _ids(cmg.cached_ids[group.rank].reshape(-1), device)

    @property
    def consumers(self) -> int:
        """Consumers whose mirror rows this process holds."""
        return self.cmg.partitions if self.group is None else 1


def dist_get_dep_nbr_partial(ce: CacheExchange, x: torch.Tensor,
                             cached_rows: torch.Tensor) -> torch.Tensor:
    """Mirror rows with only the cold group exchanged: ``cached_rows``
    (``[P*mc, f]`` per consumer, the twin's ``[P*P*mc, f]``) fill the hot
    slots and pass no gradient; the result is ``dist_get_dep_nbr``'s
    layout (``[P*mb, f]`` per consumer)."""
    cmg = ce.cmg
    P, mc, mf = cmg.partitions, cmg.mc, cmg.mf
    got = x[ce.fetch] if ce.group is None else all_to_all_gather(x, ce.fetch, ce.group)
    f, n = x.shape[1], ce.consumers
    cached = cached_rows.detach().to(got.dtype).view(n, P, mc, f)
    return torch.cat([cached, got.view(n, P, mf, f)], dim=2).view(n * P * (mc + mf), f)


def dist_fetch_cached_rows(ce: CacheExchange, x: torch.Tensor) -> torch.Tensor:
    """Fresh values of the hot slots (the refresh exchange): ``[P*mc, f]``
    per consumer."""
    if ce.group is None:
        return x[ce.cached]
    return all_to_all_gather(x, ce.cached, ce.group)
