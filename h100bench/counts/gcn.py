"""GCN's epoch (forward, backward, Adam) at widths f0-f1-...-fL.

Per layer i: the aggregation at the layer's input width, then (not last)
batch norm (its statistics read the aggregate once) and the product with
W; the last layer's product gives the logits. Backward: each product's
weight gradient and, where the layer below or the layer's batch norm has
parameters, its input gradient (two products of the same size), and the aggregation's transpose
at the input width of every layer but the first (x needs no gradient).
The bfloat16 program stores activations in 2 bytes and runs its products
at the bfloat16 peak; the aggregation's arithmetic is float32."""

from __future__ import annotations

from typing import Dict, List

from h100bench import counts


def epoch_terms(cfg: dict, v: int, e: int) -> List[Dict]:
    c = cfg["cfg"]
    sizes = [int(s) for s in c["layer_string"].split("-")]
    bf16 = c.get("precision", "float32") == "bfloat16"
    elem, peak = (2, "bfloat16") if bf16 else (4, "float32")
    terms, n_params = [], 0
    n = len(sizes) - 1
    for i in range(n):
        fi, fo = sizes[i], sizes[i + 1]
        n_params += fi * fo + (2 * fi if i < n - 1 else 0)
        terms.append(counts.aggregation(f"agg_fwd_{i}", v, e, fi, elem))
        if i < n - 1:
            terms.append(counts.term(f"bn_stats_{i}", "elementwise", 3.0 * v * fi,
                                     float(elem) * v * fi, "float32"))
        terms.append(counts.matmul(f"mm_fwd_{i}", v, fi, fo, elem, peak))
        terms.append(counts.matmul(f"mm_dw_{i}", fi, v, fo, elem, peak))
        if i > 0 or i < n - 1:  # the input's gradient, or batch norm's parameters'
            terms.append(counts.matmul(f"mm_dx_{i}", v, fo, fi, elem, peak))
        if i > 0:
            terms.append(counts.aggregation(f"agg_bwd_{i}", v, e, fi, elem))
    terms.append(counts.loss(v, sizes[-1]))
    terms.append(counts.adam(n_params))
    return terms
