"""The mirror-slot layouts — port of ``neutronstarlite_tpu/parallel/mirror.py``.

``MirrorGraph`` (the uniform layout of the GAT/GGCN dist chain, the
``TEST_GETDEP`` check and the DepCache GCN): for each consumer partition p
and producer partition q (the diagonal included), the q-owned vertices
that p's in-edges read are deduplicated and padded to one capacity ``mb``
(the most any pair needs, a multiple of 8); ``need_ids[q, p]`` holds their
q-local ids. Each consumer's in-edges form one destination-sorted list
``[P, El]`` whose sources are slots ``q*mb + s`` of the ``[P*mb]`` mirror
space. ``chunk_edge_list`` cuts those lists at destination boundaries into
``[P, n_ch, Ec]`` chunks (pad chunks: mask 0, ``base == vp``), so the
gated chain can run a chunk at a time with every destination's softmax
whole inside one chunk.

``SplitMirror`` (``COMM_LAYER:mirror`` on the GCN family): for each
consumer partition p and producer partition q != p, the q-owned
vertices that p's in-edges read are deduplicated and padded to one
capacity ``mb`` (the most any off-diagonal pair needs, a multiple of 8):
``need_ids[q, p]`` holds their q-local ids, the rows producer q gathers
from its shard for p before the one ``all_to_all``. Edges whose source is
resident on their consumer (the diagonal) never enter the exchange:
they keep p-local source ids and read the shard directly. Per consumer,
the remote edges (sources in the ``[P*mb]`` mirror space ``q*mb + slot``)
and the local edges each form one destination-sorted list, padded to a
multiple of 8 (padding: weight 0, mask 0, destination ``vp - 1``).

Every array is bitwise JAX's. The exchanges and edge ops over these
layouts are ``dist_edge_ops.py``; the hot-first ``CachedMirrorGraph`` of
the DepCache GCN is ``feature_cache.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from neutronstarlite_torch.graph.storage import CSCGraph, partition_offsets
from neutronstarlite_torch.parallel.vertex_space import PaddedVertexSpace, round_up


def build_local_edge_lists(P, vp, offsets, p_of_edge, slot_global, dst, w):
    """Per-consumer destination-sorted edge lists (a stable grouping by p
    keeps the CSC destination order): (source slot, p-local dst, weight,
    mask), each ``[P, El]``."""
    p_counts = np.bincount(p_of_edge, minlength=P)
    el = round_up(max(int(p_counts.max()), 1), 8)
    order = np.argsort(p_of_edge, kind="stable")
    p_starts = np.concatenate([[0], np.cumsum(p_counts)])
    edge_src_slot = np.zeros((P, el), dtype=np.int32)
    edge_dst = np.full((P, el), vp - 1, dtype=np.int32)  # keep the tail sorted
    edge_weight = np.zeros((P, el), dtype=np.float32)
    edge_mask = np.zeros((P, el), dtype=np.float32)
    for p in range(P):
        sel = order[p_starts[p]: p_starts[p + 1]]
        n = len(sel)
        if n == 0:
            continue
        edge_src_slot[p, :n] = slot_global[sel].astype(np.int32)
        edge_dst[p, :n] = (dst[sel] - offsets[p]).astype(np.int32)
        edge_weight[p, :n] = w[sel]
        edge_mask[p, :n] = 1.0
    return edge_src_slot, edge_dst, edge_weight, edge_mask


def _owners(g: CSCGraph, P: int, lane_pad: int):
    offsets = partition_offsets(g.v_num, g.in_degree, P)
    vp = round_up(max(int(np.diff(offsets).max()), 1), lane_pad)
    owner = np.searchsorted(offsets, np.arange(g.v_num), side="right") - 1
    src = g.row_indices.astype(np.int64)  # global CSC order: dst-sorted
    dst = g.dst_of_edge.astype(np.int64)
    return offsets, vp, src, dst, owner[dst], owner[src]


@dataclasses.dataclass
class MirrorGraph(PaddedVertexSpace):
    """The uniform mirror-slot tables (host side)."""

    partitions: int
    vp: int  # padded vertices per partition
    mb: int  # mirror slots per (p, q) pair
    offsets: np.ndarray  # [P+1] original-id partition boundaries
    need_ids: np.ndarray  # [P(q), P(p), mb] q-local ids consumer p needs from q
    edge_src_slot: np.ndarray  # [P, El] int32 into the [P*mb] mirror space
    edge_dst: np.ndarray  # [P, El] int32 p-local dst (destination-sorted)
    edge_weight: np.ndarray  # [P, El] f32, 0 on padding
    edge_mask: np.ndarray  # [P, El] f32 {0, 1}
    e_num: int
    v_num: int

    @property
    def el(self) -> int:
        return self.edge_dst.shape[1]

    @staticmethod
    def estimate_mb(g: CSCGraph, partitions: int, lane_pad: int = 8):
        """(mb, vp) without building the tables (the unique-pair count)."""
        P = partitions
        _, vp, src, _, p_of_edge, q_of_edge = _owners(g, P, lane_pad)
        u = np.unique((p_of_edge * P + q_of_edge) * g.v_num + src)
        pq_counts = np.bincount(u // g.v_num, minlength=P * P)
        mb = round_up(max(int(pq_counts.max()) if pq_counts.size else 1, 1), lane_pad)
        return mb, vp

    @staticmethod
    def build(g: CSCGraph, partitions: int, lane_pad: int = 8) -> "MirrorGraph":
        P = partitions
        offsets, vp, src, dst, p_of_edge, q_of_edge = _owners(g, P, lane_pad)
        w = g.edge_weight_forward.astype(np.float32)

        # per-(p, q) deduplicated source sets: (p*P + q)*V + src sorts by
        # pair, then source, so each pair's unique sources are one run
        key_pq = p_of_edge * P + q_of_edge
        pair = key_pq * g.v_num + src
        u = np.unique(pair)
        u_pq = u // g.v_num
        pq_counts = np.bincount(u_pq, minlength=P * P)
        mb = round_up(max(int(pq_counts.max()) if pq_counts.size else 1, 1), lane_pad)
        u_starts = np.concatenate([[0], np.cumsum(pq_counts)])
        u_src_local = (u % g.v_num) - offsets[u_pq % P]

        need_ids = np.zeros((P, P, mb), dtype=np.int32)
        for k in np.nonzero(pq_counts)[0]:
            p, q = divmod(int(k), P)
            lo, hi = u_starts[k], u_starts[k + 1]
            need_ids[q, p, : hi - lo] = u_src_local[lo:hi].astype(np.int32)

        # every edge's slot = its position inside its pair's unique run
        slot_in_pair = np.searchsorted(u, pair) - u_starts[key_pq]
        slot_global = q_of_edge * mb + slot_in_pair
        edge_src_slot, edge_dst, edge_weight, edge_mask = build_local_edge_lists(
            P, vp, offsets, p_of_edge, slot_global, dst, w
        )
        return MirrorGraph(
            partitions=P, vp=vp, mb=mb, offsets=offsets, need_ids=need_ids,
            edge_src_slot=edge_src_slot, edge_dst=edge_dst, edge_weight=edge_weight,
            edge_mask=edge_mask, e_num=g.e_num, v_num=g.v_num,
        )


@dataclasses.dataclass
class ChunkedEdgeList:
    """Destination-aligned chunks of a ``MirrorGraph``'s edge lists, one
    shape for every rank and chunk:

      slot  [P, n_ch, Ec]  int32 into the [P*mb] mirror space
      dstl  [P, n_ch, Ec]  int32 p-local dst (gathers the dst-side rows)
      dstr  [P, n_ch, Ec]  int32 chunk-relative dst (softmax, sums)
      mask  [P, n_ch, Ec]  f32 {0, 1}
      base  [P, n_ch]      int32 first dst row of the chunk (pad: vp)
      dp    padded dst rows per chunk
    """

    slot: np.ndarray
    dstl: np.ndarray
    dstr: np.ndarray
    mask: np.ndarray
    base: np.ndarray
    dp: int

    @property
    def n_chunks(self) -> int:
        return self.slot.shape[1]


def chunk_edge_list(mg: MirrorGraph, ec_target: int) -> ChunkedEdgeList:
    """Cut each rank's destination-sorted edge list into destination-aligned
    chunks of at most max(ec_target, heaviest destination) edges."""
    P, vp = mg.partitions, mg.vp
    per_dev = []
    max_ec = max_dp = max_nch = 1
    for p in range(P):
        m = mg.edge_mask[p] > 0
        d = mg.edge_dst[p][m]
        s = mg.edge_src_slot[p][m]
        counts = np.bincount(d, minlength=vp)
        nz = np.nonzero(counts)[0]
        ec = max(int(ec_target), int(counts.max()) if nz.size else 1)
        chunks = []  # (edge_lo, edge_hi, dst_lo, dst_hi)
        e_lo, d_lo, acc, prev_hi = 0, 0, 0, 0
        for v in nz:
            c = int(counts[v])
            if acc and acc + c > ec:
                chunks.append((e_lo, e_lo + acc, d_lo, prev_hi + 1))
                e_lo += acc
                d_lo = int(v)
                acc = 0
            acc += c
            prev_hi = int(v)
        chunks.append((e_lo, e_lo + acc, d_lo, prev_hi + 1 if nz.size else 1))
        per_dev.append((d, s, chunks))
        max_ec = max(max_ec, max(h - lo for lo, h, *_ in chunks))
        max_dp = max(max_dp, max(dh - dl for *_, dl, dh in chunks))
        max_nch = max(max_nch, len(chunks))
    Ec, dp, n_ch = round_up(max_ec, 8), round_up(max_dp, 8), max_nch

    slot = np.zeros((P, n_ch, Ec), np.int32)
    dstl = np.full((P, n_ch, Ec), vp - 1, np.int32)
    dstr = np.full((P, n_ch, Ec), dp - 1, np.int32)  # sorted pad tail
    mask = np.zeros((P, n_ch, Ec), np.float32)
    base = np.full((P, n_ch), vp, np.int32)  # pad chunks -> the scratch margin
    for p, (d, s, chunks) in enumerate(per_dev):
        for k, (el, eh, dl, _) in enumerate(chunks):
            n = eh - el
            if n == 0:
                continue
            slot[p, k, :n] = s[el:eh]
            dstl[p, k, :n] = d[el:eh]
            dstr[p, k, :n] = d[el:eh] - dl
            mask[p, k, :n] = 1.0
            base[p, k] = dl
    return ChunkedEdgeList(slot=slot, dstl=dstl, dstr=dstr, mask=mask, base=base,
                           dp=int(dp))


@dataclasses.dataclass
class SplitMirror(PaddedVertexSpace):
    """Remote-only mirror exchange + resident local edge list."""

    partitions: int
    vp: int
    mb: int  # remote mirror slots per (p, q != p) pair
    offsets: np.ndarray
    need_ids: np.ndarray  # [P(q), P(p), mb]; the diagonal rows are dead (zeros)
    r_src_slot: np.ndarray  # [P, Er] int32 into the [P*mb] mirror space
    r_dst: np.ndarray  # [P, Er] int32 p-local dst
    r_weight: np.ndarray  # [P, Er] f32 (0 on padding)
    r_mask: np.ndarray  # [P, Er] f32 {0, 1}
    l_src: np.ndarray  # [P, El] int32 p-local src
    l_dst: np.ndarray  # [P, El] int32 p-local dst
    l_weight: np.ndarray  # [P, El] f32 (0 on padding)
    l_mask: np.ndarray  # [P, El] f32 {0, 1}
    e_num: int
    v_num: int

    @property
    def er(self) -> int:
        return self.r_dst.shape[1]

    @property
    def el(self) -> int:
        return self.l_dst.shape[1]

    @staticmethod
    def estimate_mb_remote(g: CSCGraph, partitions: int, lane_pad: int = 8):
        """(mb, vp) without building the tables: the split exchange's wire
        price, which ``COMM_LAYER:auto`` holds against the ring's vp."""
        P = partitions
        _, vp, src, _, p_of_edge, q_of_edge = _owners(g, P, lane_pad)
        remote = p_of_edge != q_of_edge
        key_pq = p_of_edge[remote] * P + q_of_edge[remote]
        u = np.unique(key_pq * g.v_num + src[remote])
        pq_counts = np.bincount(u // g.v_num, minlength=P * P)
        mb = round_up(max(int(pq_counts.max()) if pq_counts.size else 1, 1), lane_pad)
        return mb, vp

    @staticmethod
    def build(g: CSCGraph, partitions: int, lane_pad: int = 8) -> "SplitMirror":
        P = partitions
        offsets, vp, src, dst, p_of_edge, q_of_edge = _owners(g, P, lane_pad)
        w = g.edge_weight_forward.astype(np.float32)
        remote = p_of_edge != q_of_edge

        # the remote edges' deduplicated per-(p, q != p) source sets -> mb
        key_pq_r = p_of_edge[remote] * P + q_of_edge[remote]
        pair_r = key_pq_r * g.v_num + src[remote]
        u = np.unique(pair_r)
        u_pq = u // g.v_num
        pq_counts = np.bincount(u_pq, minlength=P * P)
        mb = round_up(max(int(pq_counts.max()) if pq_counts.size else 1, 1), lane_pad)
        u_starts = np.concatenate([[0], np.cumsum(pq_counts)])
        u_src_local = (u % g.v_num) - offsets[u_pq % P]

        need_ids = np.zeros((P, P, mb), dtype=np.int32)
        for k in np.nonzero(pq_counts)[0]:
            p, q = divmod(int(k), P)
            need_ids[q, p, : u_starts[k + 1] - u_starts[k]] = u_src_local[
                u_starts[k]: u_starts[k + 1]
            ].astype(np.int32)

        slot_in_pair = np.searchsorted(u, pair_r) - u_starts[key_pq_r]
        slot_global = q_of_edge[remote] * mb + slot_in_pair
        r_src_slot, r_dst, r_weight, r_mask = build_local_edge_lists(
            P, vp, offsets, p_of_edge[remote], slot_global, dst[remote], w[remote],
        )

        # the local edges keep p-local source ids (read from the shard)
        local = ~remote
        src_local = src[local] - offsets[p_of_edge[local]]
        l_src, l_dst, l_weight, l_mask = build_local_edge_lists(
            P, vp, offsets, p_of_edge[local], src_local, dst[local], w[local],
        )
        return SplitMirror(
            partitions=P, vp=vp, mb=mb, offsets=offsets, need_ids=need_ids,
            r_src_slot=r_src_slot, r_dst=r_dst, r_weight=r_weight, r_mask=r_mask,
            l_src=l_src, l_dst=l_dst, l_weight=l_weight, l_mask=l_mask,
            e_num=g.e_num, v_num=g.v_num,
        )
