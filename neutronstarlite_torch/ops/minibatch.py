"""Mini-batch aggregation over sampled subgraphs — port of
``neutronstarlite_tpu/ops/minibatch.py``.

``minibatch_gather(src_local, dst_local, weight, x, n_dst_cap)`` computes
``out[dst] = Σ w · x[src]`` over a hop's padded edge list, as JAX's
``segment_sum`` does. JAX's op is XLA code, not a Pallas kernel, so the port
is plain PyTorch.

A scatter-add (``index_add_``) on a CUDA float adds with atomics in an order
that changes from call to call. Every sampled hop has at most ``K = E //
n_dst_cap`` (the fanout) edges per destination, so the port lays the hop out
as a dense ``[n_dst_cap, K]`` slot table (``slot_table``: a stable sort of
the live edges by destination, each edge's rank in its run is its slot;
padding and empty slots carry weight 0) and sums over the slot axis: the
forward has no atomics, and the backward of the row gather is
``index_put_(accumulate=True)``, which sorts its indices on the card. Both
directions are repeatable. Everything here has a fixed shape and never reads
a value back to the host, so the fused step can run it inside a CUDA graph.

Live edges are those of non-zero weight (a real edge's GCN weight is
positive); padding edges (weight 0, indices 0) drop out. The products and
the sum are float32, and the result is cast once to ``x.dtype``: JAX
multiplies and adds in ``x.dtype``, so under ``PRECISION:bfloat16`` the two
differ by bf16 rounding, and the tests compare in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def slot_table(src_local: torch.Tensor, dst_local: torch.Tensor, weight: torch.Tensor,
               n_dst_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src [n_dst_cap, K] int64, weight [n_dst_cap, K] float32): each
    destination's live edges in their input order, then empty slots (index
    0, weight 0). At most K live edges per destination (the fanout bound);
    the live edges of one destination need not be contiguous."""
    E = src_local.shape[0]
    if n_dst_cap <= 0 or E % n_dst_cap:
        raise ValueError(f"{E} edges do not fill {n_dst_cap} rows of slots")
    K = E // n_dst_cap
    dev = src_local.device
    live = weight != 0
    key = torch.where(live, dst_local.long(), n_dst_cap)
    skey, order = torch.sort(key, stable=True)
    # an edge's slot: its distance from the start of its destination's run
    rank = torch.arange(E, device=dev) - torch.searchsorted(skey, skey)
    # dead edges (and, were the bound broken, edges past slot K-1) go to
    # a spare cell past the table, which is dropped
    cell = torch.where((skey < n_dst_cap) & (rank < K), skey * K + rank, E)
    tsrc = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    tw = torch.zeros(E + 1, dtype=torch.float32, device=dev)
    tsrc[cell] = src_local.long()[order]
    tw[cell] = weight.float()[order]
    return tsrc[:E].view(n_dst_cap, K), tw[:E].view(n_dst_cap, K)


def slot_gather(slot_src: torch.Tensor, slot_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[d] = Σ_j slot_w[d, j] · x[slot_src[d, j]], summed in float32 over
    the slot axis, returned in x.dtype."""
    rows = x[slot_src]  # [n_dst_cap, K, f]
    return (rows * slot_w.unsqueeze(-1)).sum(dim=1).to(x.dtype)


def minibatch_gather(src_local: torch.Tensor, dst_local: torch.Tensor, weight: torch.Tensor,
                     x: torch.Tensor, n_dst_cap: int) -> torch.Tensor:
    """out[dst] = sum over the hop's edges of w * x[src]: [Ncap_in, f] ->
    [n_dst_cap, f]. Padding edges have weight 0 and indices 0."""
    return slot_gather(*slot_table(src_local, dst_local, weight, n_dst_cap), x)


def get_feature(feature: torch.Tensor, node_ids: torch.Tensor) -> torch.Tensor:
    """Input rows of the innermost sampled layer."""
    return feature[node_ids]


def get_label(label: torch.Tensor, seed_ids: torch.Tensor) -> torch.Tensor:
    return label[seed_ids]
