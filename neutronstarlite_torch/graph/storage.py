"""Host-side graph storage — port of ``neutronstarlite_tpu/graph/storage.py``.

Edge-list loading (Gemini binary or text, sniffed), the GCN norm weights
and the dual CSC/CSR build. This is the NumPy path of the JAX module
(``build_graph(..., use_native=False)``): the JAX package's native OpenMP
builder orders tied edges differently from build to build, and the port
keeps no native code of its own, so its arrays are bitwise those of the
JAX NumPy path.

Conventions: edges are directed src -> dst; the forward aggregation pulls
from in-neighbours (CSC, edges stable-sorted by dst), the backward pushes
along out-edges (CSR, stable-sorted by src). Zero degrees clamp to 1 in the
normalisation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np


def load_edges_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Gemini binary edge list: pairs of little-endian uint32 (src, dst)."""
    size = os.path.getsize(path)
    if size % 8 != 0:
        raise ValueError(f"{path}: size {size} is not a multiple of 8 bytes/edge")
    raw = np.fromfile(path, dtype="<u4").reshape(-1, 2)
    return np.ascontiguousarray(raw[:, 0]), np.ascontiguousarray(raw[:, 1])


def load_edges_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace text edge list, one ``src dst`` pair per line; '#'
    comments and extra columns are ignored, negative ids are an error."""
    data = np.loadtxt(path, dtype=np.int64, usecols=(0, 1), comments="#", ndmin=2)
    if data.size and data.min() < 0:
        raise ValueError(f"{path}: negative vertex id {data.min()} in edge list")
    return (
        np.ascontiguousarray(data[:, 0].astype(np.uint32)),
        np.ascontiguousarray(data[:, 1].astype(np.uint32)),
    )


_TEXT_EDGE_BYTES = frozenset(b"0123456789 \t\r\n-+.eE#,")


def load_edges(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load an edge list, sniffing text vs Gemini binary from the first
    4 KiB: an all-numeric-ASCII head (comment lines dropped) is text."""
    with open(path, "rb") as fh:
        head = fh.read(4096)
    lines = head.split(b"\n")
    if len(lines) > 1:
        lines = lines[:-1]
    data_lines = [ln for ln in lines if not ln.lstrip().startswith(b"#")]
    sniff = b"\n".join(data_lines)
    if sniff:
        is_text = all(b in _TEXT_EDGE_BYTES for b in sniff)
    else:
        is_text = (
            len(lines) > 0
            and all(32 <= b < 127 or b in (9, 10, 13) for b in head)
            and all(ln.lstrip().startswith(b"#") for ln in lines)
        )
    if head and is_text:
        return load_edges_text(path)
    return load_edges_binary(path)


def gcn_norm_weights(
    src: np.ndarray, dst: np.ndarray, out_degree: np.ndarray, in_degree: np.ndarray
) -> np.ndarray:
    """Per-edge GCN weight 1/sqrt(d_out(src) * d_in(dst)), in float64 then
    rounded once to float32."""
    d_out = np.maximum(out_degree[src], 1).astype(np.float64)
    d_in = np.maximum(in_degree[dst], 1).astype(np.float64)
    return (1.0 / np.sqrt(d_out * d_in)).astype(np.float32)


@dataclasses.dataclass
class CSCGraph:
    """Dual CSC/CSR adjacency with per-edge weights, host (NumPy) resident.

    CSC (forward, dst-sorted): column_offset [V+1], row_indices [E] (source
    of each edge), dst_of_edge [E], edge_weight_forward [E].
    CSR (backward, src-sorted): row_offset [V+1], column_indices [E]
    (destination of each edge), src_of_edge [E], edge_weight_backward [E].
    """

    v_num: int
    e_num: int
    column_offset: np.ndarray
    row_indices: np.ndarray
    dst_of_edge: np.ndarray
    edge_weight_forward: np.ndarray
    row_offset: np.ndarray
    column_indices: np.ndarray
    src_of_edge: np.ndarray
    edge_weight_backward: np.ndarray
    out_degree: np.ndarray
    in_degree: np.ndarray

    @property
    def avg_degree(self) -> float:
        return self.e_num / max(self.v_num, 1)


def build_graph(
    src: np.ndarray, dst: np.ndarray, v_num: int, weight: str = "gcn_norm"
) -> CSCGraph:
    """Dual CSC/CSR from an edge list. ``weight``: "gcn_norm" (the GCN
    toolkits' 1/sqrt(dd)) or "ones"."""
    src = np.asarray(src, dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.uint32)
    e_num = src.shape[0]
    if e_num and (int(src.max()) >= v_num or int(dst.max()) >= v_num):
        raise ValueError(
            f"edge list references vertex {max(int(src.max()), int(dst.max()))} "
            f">= VERTICES {v_num}"
        )
    out_degree = np.bincount(src, minlength=v_num).astype(np.int32)
    in_degree = np.bincount(dst, minlength=v_num).astype(np.int32)
    if weight == "gcn_norm":
        w = gcn_norm_weights(src, dst, out_degree, in_degree)
    elif weight == "ones":
        w = np.ones(e_num, dtype=np.float32)
    else:
        raise ValueError(f"unknown weight mode {weight}")

    csc_perm = np.argsort(dst, kind="stable")
    column_offset = np.zeros(v_num + 1, dtype=np.int64)
    np.cumsum(in_degree, out=column_offset[1:])
    csr_perm = np.argsort(src, kind="stable")
    row_offset = np.zeros(v_num + 1, dtype=np.int64)
    np.cumsum(out_degree, out=row_offset[1:])
    return CSCGraph(
        v_num=v_num,
        e_num=e_num,
        column_offset=column_offset,
        row_indices=src[csc_perm].astype(np.int32),
        dst_of_edge=dst[csc_perm].astype(np.int32),
        edge_weight_forward=w[csc_perm],
        row_offset=row_offset,
        column_indices=dst[csr_perm].astype(np.int32),
        src_of_edge=src[csr_perm].astype(np.int32),
        edge_weight_backward=w[csr_perm],
        out_degree=out_degree,
        in_degree=in_degree,
    )
