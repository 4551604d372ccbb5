"""The split mirror layout — port of ``SplitMirror`` and
``build_local_edge_lists`` in ``neutronstarlite_tpu/parallel/mirror.py``.

For each consumer partition p and producer partition q != p, the q-owned
vertices that p's in-edges read are deduplicated and padded to one
capacity ``mb`` (the most any off-diagonal pair needs, a multiple of 8):
``need_ids[q, p]`` holds their q-local ids, the rows producer q gathers
from its shard for p before the one ``all_to_all``. Edges whose source is
resident on their consumer (the diagonal) never enter the exchange:
they keep p-local source ids and read the shard directly. Per consumer,
the remote edges (sources in the ``[P*mb]`` mirror space ``q*mb + slot``)
and the local edges each form one destination-sorted list, padded to a
multiple of 8 (padding: weight 0, mask 0, destination ``vp - 1``).

Every array is bitwise JAX's. The aggregation over this layout is
``dist_edge_ops.py``. The uniform ``MirrorGraph`` (GAT/GGCN dist) and the
chunked edge lists come with the edge-family slice.
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
