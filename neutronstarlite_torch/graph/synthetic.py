"""Synthetic graphs — port of ``neutronstarlite_tpu/graph/synthetic.py``.

The reference benchmarks on Reddit (V=232,965, E~114.6M) but ships no
data. ``synthetic_power_law_graph`` draws edges with a Zipf-like endpoint
distribution at any (V, E), so the chip run can train at Reddit's widths
and mean degree; ``planted_partition_graph`` draws a community graph with
class-indicator features, whose labels a GCN can learn (the data-prep
tool's citeseer, pubmed and reddit, ``graph/prep.py``). The draws are
those of the JAX module (same numpy calls, same order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

REDDIT_V = 232965
REDDIT_E = 114615892  # binary edges of the reference's reddit.edge.bin


def synthetic_power_law_graph(
    v_num: int, e_num: int, seed: int = 0, self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) uint32 edge list: endpoints v_num * u**3 (mass skewed to
    low ids, giving hub vertices), ids then randomly permuted; self loops
    appended when asked (the reference trains on ``.edge.self`` files)."""
    rng = np.random.default_rng(seed)
    n_rand = e_num - (v_num if self_loops else 0)
    if n_rand < 0:
        raise ValueError("e_num smaller than self-loop count")
    a = 3.0
    src = (v_num * rng.random(n_rand) ** a).astype(np.uint32)
    dst = (v_num * rng.random(n_rand) ** a).astype(np.uint32)
    perm = rng.permutation(v_num).astype(np.uint32)
    src, dst = perm[src], perm[dst]
    if self_loops:
        loops = np.arange(v_num, dtype=np.uint32)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    return src, dst


def reddit_scaled(scale: float) -> Tuple[int, int]:
    """(V, E) of Reddit scaled by ``scale``, keeping its mean degree."""
    return int(REDDIT_V * scale), int(REDDIT_E * scale)


def planted_partition_graph(
    v_num: int,
    classes: int,
    avg_degree: float,
    p_in: float = 0.9,
    feature_size: int = 16,
    feature_noise: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, feature [V, f], label [V]): ``v_num * avg_degree`` edges
    whose destination is a vertex of the source's class with probability
    ``p_in`` (else uniform), self loops appended; features are a class
    embedding plus Gaussian noise, so a 2-layer GCN learns the labels."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, classes, size=v_num, dtype=np.int32)
    e_num = int(v_num * avg_degree)
    src = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    same = rng.random(e_num) < p_in
    by_class = [np.where(label == c)[0] for c in range(classes)]
    dst = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    for c in range(classes):
        idx = np.where(same & (label[src] == c))[0]
        members = by_class[c]
        if len(members) and len(idx):
            dst[idx] = members[rng.integers(0, len(members), size=len(idx))]
    loops = np.arange(v_num, dtype=np.uint32)
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])

    class_emb = rng.standard_normal((classes, feature_size)).astype(np.float32)
    feature = class_emb[label] + feature_noise * rng.standard_normal(
        (v_num, feature_size)
    ).astype(np.float32)
    return src, dst, feature, label
