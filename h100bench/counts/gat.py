"""GAT's epoch (forward, backward, Adam), float32 with TF32 off.

Per layer: h = x @ W; the two attention halves (h . a); per edge the
score, leaky relu and softmax (their operations only: a fused
implementation keeps no [E] tensor, and the edge indices are counted once
in the aggregation); the weighted aggregation at the output width.
Backward: the aggregation's transpose at the output width, the attention
weights' gradient (a dot of width f_out per edge), the softmax's and
scores' gradients (operations per edge), the product's weight gradient
and, above the first layer, its input gradient."""

from __future__ import annotations

from typing import Dict, List

from h100bench import counts

EDGE_OPS_FWD = 6.0  # add, leaky relu, max, subtract, exp, sum / divide per edge
EDGE_OPS_BWD = 8.0


def epoch_terms(cfg: dict, v: int, e: int) -> List[Dict]:
    sizes = [int(s) for s in cfg["cfg"]["layer_string"].split("-")]
    terms, n_params = [], 0
    for i in range(len(sizes) - 1):
        fi, fo = sizes[i], sizes[i + 1]
        n_params += fi * fo + 2 * fo
        terms.append(counts.matmul(f"mm_fwd_{i}", v, fi, fo, 4, "float32"))
        terms.append(counts.matmul(f"attn_halves_{i}", v, fo, 2, 4, "float32"))
        terms.append(counts.term(f"edge_softmax_{i}", "edge", EDGE_OPS_FWD * e, 0.0, "float32"))
        terms.append(counts.aggregation(f"agg_fwd_{i}", v, e, fo, 4))
        terms.append(counts.aggregation(f"agg_bwd_{i}", v, e, fo, 4))
        terms.append(counts.term(f"grad_alpha_{i}", "edge", 2.0 * e * fo,
                                 8.0 * v * fo, "float32"))
        terms.append(counts.term(f"edge_softmax_bwd_{i}", "edge", EDGE_OPS_BWD * e, 0.0,
                                 "float32"))
        terms.append(counts.matmul(f"mm_dw_{i}", fi, v, fo, 4, "float32"))
        if i > 0:
            terms.append(counts.matmul(f"mm_dx_{i}", v, fo, fi, 4, "float32"))
    terms.append(counts.loss(v, sizes[-1]))
    terms.append(counts.adam(n_params))
    return terms
