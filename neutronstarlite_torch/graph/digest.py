"""Canonical graph content digest — port of
``neutronstarlite_tpu/graph/digest.py`` (the perf ledger keys its rows by
it, as the reference's tune cache does): the same digest, with one packed
sort in place of the reference's two-key lexsort.

``graph_digest(g)`` hashes the graph's structure — per-destination
canonicalized neighbour multisets — into one sha256 hex string.

The reference's native OpenMP CSC construction orders tied edges (same
destination) differently from one build to the next, and the port's
native and NumPy builds order them differently from each other, so two
identical edge files can give CSC arrays that differ in within-segment
edge order.
Sorting each destination segment by source id (a stable lexsort over
(dst, src)) makes the digest a function of the neighbour multiset only:
duplicate edges keep their multiplicity, order wobble disappears, and
every construction of the same graph gives the same digest. Edge weights
are not hashed: the weight mode is a property of the algorithm family.
"""

from __future__ import annotations

import hashlib

import numpy as np


def graph_digest(g) -> str:
    """sha256 hex digest of a CSCGraph's canonicalized structure.

    Hash input: (v_num, e_num, in-degree offsets, and the CSC source ids
    sorted within each destination segment) — all cast to fixed-width
    little-endian dtypes, so the arrays' own dtypes (int32 vs int64
    offsets) cannot change the digest either.
    """
    dst = np.asarray(g.dst_of_edge, dtype=np.int64)
    src = np.asarray(g.row_indices, dtype=np.int64)
    # the sources sorted by (dst, src): dst_of_edge is already
    # non-decreasing, so this only canonicalizes the within-segment tie
    # order. Ids are below 2**32, so one int64 key packs the pair and a
    # plain sort gives the reference's ``src[np.lexsort((src, dst))]``
    # (equal keys are equal values) several times faster: a graph delta
    # digests its post-delta graph
    canon = np.sort((dst << 32) | src) & 0xFFFFFFFF
    h = hashlib.sha256()
    h.update(np.array([g.v_num, g.e_num], dtype="<i8").tobytes())
    h.update(np.asarray(g.column_offset, dtype="<i8").tobytes())
    h.update(canon.astype("<i8").tobytes())
    return h.hexdigest()
