"""Vertex-sharded graph: per-(dst partition, src partition) edge blocks —
port of ``neutronstarlite_tpu/parallel/dist_graph.py``.

Vertices are range-partitioned by the edge-balancing chunker
(``graph/storage.partition_offsets``), each range padded to the largest
range size ``vp`` (rounded to ``lane_pad``). For each (dst partition p,
src partition q) the edges form one CSC-ordered block with partition-local
ids, padded to a common length ``Eb`` (a multiple of ``edge_chunk``) and
stacked into ``[P, P, Eb]`` host arrays; ``block_count [P, P]`` holds each
block's real edges, which come first. The arrays are bitwise JAX's.

``step_blocks`` re-packs them for the ring (``parallel/dist_ops.py``): at
ring step s, row p is block (p, (p + s) % P), each step padded only to its
own largest block. The device placement (JAX's ``shard``) is the
exchanges' business: each rank uploads only the blocks it runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from neutronstarlite_torch.graph.storage import CSCGraph, partition_offsets
from neutronstarlite_torch.parallel.vertex_space import (
    PaddedVertexSpace,
    owner_of_vertices,
    round_up,
)

# the JAX package's default scatter chunk (ops/device_graph.py): it sizes
# Eb, so the block arrays keep JAX's shapes
DEFAULT_EDGE_CHUNK = 1 << 18


@dataclasses.dataclass
class RingBlocks:
    """Step-major ring edge blocks: per ring step s, [P, Eb_s] arrays whose
    row p is edge block (p, (p+s) % P) — see DistGraph.step_blocks."""

    src: List[np.ndarray]
    dst: List[np.ndarray]
    wgt: List[np.ndarray]


@dataclasses.dataclass
class DistGraph(PaddedVertexSpace):
    """Host-side partitioned graph."""

    partitions: int
    vp: int  # padded vertices per partition
    offsets: np.ndarray  # [P+1] original-id partition boundaries
    # [P, P, Eb]: block[p, q] holds the edges with dst in partition p and
    # src in partition q, partition-local ids, CSC (dst-sorted) order
    block_src: np.ndarray
    block_dst: np.ndarray
    block_weight: np.ndarray
    e_num: int
    v_num: int
    edge_chunk: int
    block_count: np.ndarray = None  # [P, P] real edges per block

    @property
    def eb(self) -> int:
        return self.block_src.shape[2]

    @staticmethod
    def build(
        g: CSCGraph,
        partitions: int,
        edge_chunk: Optional[int] = None,
        lane_pad: int = 8,
    ) -> "DistGraph":
        """Partition a host graph into the [P, P, Eb] block layout."""
        P = partitions
        offsets = partition_offsets(g.v_num, g.in_degree, P)
        sizes = np.diff(offsets)
        vp = round_up(int(sizes.max()), lane_pad)
        owner = owner_of_vertices(offsets)

        src = g.row_indices.astype(np.int64)  # CSC order: dst-sorted
        dst = g.dst_of_edge.astype(np.int64)
        w = g.edge_weight_forward
        # group edges by (p, q); the stable sort keeps CSC order per group
        key = owner[dst] * P + owner[src]
        order = np.argsort(key, kind="stable")
        src_s, dst_s, w_s, key_s = src[order], dst[order], w[order], key[order]
        counts = np.bincount(key_s, minlength=P * P)
        eb = round_up(int(counts.max()) if counts.size else 1, 8)
        if edge_chunk is None:
            edge_chunk = min(DEFAULT_EDGE_CHUNK, max(128, eb))
        eb = round_up(eb, edge_chunk)

        block_src = np.zeros((P, P, eb), dtype=np.int32)
        block_dst = np.zeros((P, P, eb), dtype=np.int32)
        block_weight = np.zeros((P, P, eb), dtype=np.float32)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for p in range(P):
            for q in range(P):
                k = p * P + q
                lo, hi = starts[k], starts[k + 1]
                n = hi - lo
                if n == 0:
                    continue
                block_src[p, q, :n] = src_s[lo:hi] - offsets[q]
                block_dst[p, q, :n] = dst_s[lo:hi] - offsets[p]
                block_weight[p, q, :n] = w_s[lo:hi]

        return DistGraph(
            partitions=P, vp=vp, offsets=offsets, block_src=block_src,
            block_dst=block_dst, block_weight=block_weight, e_num=g.e_num,
            v_num=g.v_num, edge_chunk=int(edge_chunk),
            block_count=counts.reshape(P, P).astype(np.int64),
        )

    def padding_stats(self) -> dict:
        """Padded-vs-real occupancy of the [P, P, Eb] layout."""
        real = int(self.block_count.sum())
        padded = int(self.block_src.size)
        return {
            "real_edges": real,
            "padded_edges": padded,
            "waste_ratio": padded / max(real, 1),
            "max_block": int(self.block_count.max()),
            "mean_block": float(self.block_count.mean()),
        }

    def step_blocks(self) -> RingBlocks:
        """The ring's step-major layout: per ring step s, [P, Eb_s] arrays
        whose row p is block (p, (p+s) % P), padded only to that step's
        largest block (and the edge_chunk multiple)."""
        P = self.partitions
        src_l, dst_l, w_l = [], [], []
        for s, eb_s in enumerate(self._step_sizes()):
            bs = np.zeros((P, eb_s), dtype=np.int32)
            bd = np.zeros((P, eb_s), dtype=np.int32)
            bw = np.zeros((P, eb_s), dtype=np.float32)
            for p in range(P):
                q = (p + s) % P
                n = int(self.block_count[p, q])
                bs[p, :n] = self.block_src[p, q, :n]
                bd[p, :n] = self.block_dst[p, q, :n]
                bw[p, :n] = self.block_weight[p, q, :n]
            src_l.append(bs)
            dst_l.append(bd)
            w_l.append(bw)
        return RingBlocks(src=src_l, dst=dst_l, wgt=w_l)

    def _step_sizes(self) -> list:
        """Per-ring-step padded block length Eb_s (step_blocks and
        step_padding_stats share it)."""
        P = self.partitions
        return [
            round_up(
                max(max(int(self.block_count[p, (p + s) % P]) for p in range(P)), 1),
                self.edge_chunk,
            )
            for s in range(P)
        ]

    def step_padding_stats(self) -> dict:
        """Occupancy of the step-major layout next to the uniform one's."""
        padded = self.partitions * sum(self._step_sizes())
        real = int(self.block_count.sum())
        return {
            "real_edges": real,
            "padded_edges": padded,
            "waste_ratio": padded / max(real, 1),
        }
