"""Synthetic power-law graph — port of ``neutronstarlite_tpu/graph/synthetic.py``.

The reference benchmarks on Reddit (V=232,965, E~114.6M) but ships no
data; this generator draws edges with a Zipf-like endpoint distribution at
any (V, E), so the chip run can train at Reddit's widths and mean degree.
The draws are those of the JAX module (same numpy calls, same order).
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
