"""Padded vertex-space layout shared by the distributed graph containers —
port of ``neutronstarlite_tpu/parallel/vertex_space.py``.

Vertex v owned by partition p maps to padded id ``p * vp + (v - offsets[p])``;
every shard has the same size ``vp``. The pad/unpad round trip plays the
role of the reference's scatter/gather of a distributed vertex array.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def owner_of_vertices(offsets: np.ndarray) -> np.ndarray:
    """[V] owning partition of every original vertex id under a range
    partition map (the searchsorted inverse of ``offsets``)."""
    v_num = int(offsets[-1])
    return np.searchsorted(offsets, np.arange(v_num), side="right") - 1


def reassigned_vertices(old_offsets: np.ndarray, new_offsets: np.ndarray) -> int:
    """How many vertices change owner between two range-partition maps of
    the same vertex space: the ``replan`` record's ``moved_vertices`` (a
    lost partition's whole range, plus every boundary the re-balance
    over the survivors shifts)."""
    if int(old_offsets[-1]) != int(new_offsets[-1]):
        raise ValueError(
            "partition maps cover different vertex spaces: "
            f"{int(old_offsets[-1])} vs {int(new_offsets[-1])}"
        )
    return int((owner_of_vertices(old_offsets) != owner_of_vertices(new_offsets)).sum())


class PaddedVertexSpace:
    """Mixin for containers with partitions / vp / offsets / v_num fields."""

    partitions: int
    vp: int
    offsets: np.ndarray
    v_num: int

    @property
    def padded_v(self) -> int:
        return self.partitions * self.vp

    def pad_vertex_array(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Re-lay a [V, ...] array into the padded [P*vp, ...] space."""
        out_shape = (self.padded_v,) + arr.shape[1:]
        out = np.full(out_shape, fill, dtype=arr.dtype)
        for p in range(self.partitions):
            lo, hi = self.offsets[p], self.offsets[p + 1]
            out[p * self.vp : p * self.vp + (hi - lo)] = arr[lo:hi]
        return out

    def unpad_vertex_array(self, arr: np.ndarray) -> np.ndarray:
        """Inverse of pad_vertex_array."""
        out = np.zeros((self.v_num,) + arr.shape[1:], dtype=arr.dtype)
        for p in range(self.partitions):
            lo, hi = self.offsets[p], self.offsets[p + 1]
            out[lo:hi] = arr[p * self.vp : p * self.vp + (hi - lo)]
        return out

    def valid_mask(self) -> np.ndarray:
        """[P*vp] 1.0 on real vertices, 0.0 on shard padding."""
        return self.pad_vertex_array(np.ones(self.v_num, dtype=np.float32))
