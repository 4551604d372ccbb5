"""The work an epoch's inputs require, per model family (``<family>.py``):
a list of terms, each with its operations, the bytes that have to cross
HBM at least once, and the peak its operations run at. A term's least
time is the larger of bytes over the HBM rate and operations over the
peak; the epoch's least time is the sum. Copied and generalised from the
port's ``obs/cost.aggregation_cost`` and ``tools/roofline.epoch_terms``.

What is counted is what the inputs need, whatever implements it: every
edge (parallel edges too) once per aggregation, no padding; a dense
product's operands read once and its result written once; element-wise
passes that a fused implementation need not make (relu, dropout, the
batch-norm apply) are not counted.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")))


def term(name: str, kind: str, ops: float, nbytes: float, peak: str) -> Dict:
    return {"name": name, "kind": kind, "ops": float(ops), "bytes": float(nbytes),
            "peak": peak}


def aggregation(name: str, v: int, e: int, f: int, elem: int) -> Dict:
    """One aggregation over all E edges at width f: 2·E·f float32
    operations (products and sums accumulate in float32); bytes: per edge
    its source index and weight (4 + 4), the row offsets ((V+1)·4), x read
    once and the output written once (V·f each at ``elem`` bytes)."""
    return term(name, "aggregation", 2.0 * e * f, 8.0 * e + 4.0 * (v + 1) + 2.0 * v * f * elem,
                "float32")


def matmul(name: str, m: int, k: int, n: int, elem: int, peak: str) -> Dict:
    return term(name, "matmul", 2.0 * m * k * n, float(elem) * (m * k + k * n + m * n), peak)


def least_ms(terms: List[Dict], kinds=None) -> float:
    """The sum of the terms' least times (of the given kinds), in ms."""
    bw, peaks = PEAKS["hbm_bytes_per_s"], PEAKS["flops_per_s"]
    return 1e3 * sum(max(t["bytes"] / bw, t["ops"] / peaks[t["peak"]])
                     for t in terms if kinds is None or t["kind"] in kinds)


def adam(n_params: int) -> Dict:
    """Read p, g, m, v and write p, m, v (float32)."""
    return term("adam", "optimizer", 10.0 * n_params, 28.0 * n_params, "float32")


def loss(v: int, classes: int) -> Dict:
    """log-softmax and the picked entries: the logits read once (float32)."""
    return term("loss", "elementwise", 4.0 * v * classes, 4.0 * v * classes, "float32")
