"""Deterministic synthetic graph + delta-trace generator (stream rigs).

Copy of ``neutronstarlite_tpu/tools/graph_gen.py``, equal to it apart from
this note and the import paths (tests/test_torch_obs.py holds the two
equal): the same seed and knobs give both packages the same graph and
byte-identical trace logs. It runs NumPy only: no device.

Every streaming test and gate in this repo needs the same two inputs: a
graph that LOOKS like real graph data (skewed degrees, not a uniform
Erdős–Rényi blob — the sampled trainer and the device neighbor table
behave differently under skew) and a reproducible stream of edits to
feed the delta log. This module generates both from a seed alone, so a
trace referenced in a test or a gate is a (generator-version, seed,
knobs) tuple, never a checked-in binary.

Two graph families:

- ``rmat``: the classic recursive-matrix generator (Chakrabarti et al.)
  — each edge picks a quadrant per bit level with probabilities
  (a, b, c, d), yielding the power-law in/out skew real web/social
  graphs show. Self-loops and duplicate pairs are kept (build_graph
  handles multigraphs; removal semantics drop every occurrence).
- ``powerlaw``: preferential-attachment flavored — destination picked
  ~ (current in-degree + 1), source uniform. Cheaper to reason about in
  closed form; the heavy-tail knob is ``gamma``.

The delta trace is generated in COMMIT ROUNDS: each round stages one
delta per writer (writer ids sorted — matching the log's canonical
(writer_id, writer_seq) merge order exactly, so generated removals are
always valid at their application point) and then commits. Edits track
a running pair-count table so a removal always names a live edge, and
every ``vertex_every``-th round appends a vertex (with deterministic
feature row and attachment edges) — the margin/overflow paths get
exercised, not just edge churn.

Usage (library): :func:`synth_edges`, :func:`synth_data`,
:func:`delta_trace`, :func:`write_trace_log`.

Usage (CLI)::

  python -m neutronstarlite_torch.tools.graph_gen OUT_DIR \
      [--kind rmat|powerlaw] [--vertices 512] [--edges 2048] \
      [--feat-dim 16] [--classes 4] [--seed 0] \
      [--rounds 6] [--writers 2] [--adds 4] [--removes 1] \
      [--vertex-every 3] [--json]

writes ``OUT_DIR/base.npz`` (src, dst, feature, label, mask) plus a
populated delta log at ``OUT_DIR/log/`` and prints the head digest —
two invocations with the same knobs produce byte-identical logs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neutronstarlite_torch.utils.logging import get_logger  # noqa: E402

log = get_logger("tools")

GENERATOR_VERSION = 1  # bump on any distribution-visible change


def rmat_edges(v_num: int, e_num: int, *, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """R-MAT edge list over the smallest power-of-two grid covering
    ``v_num`` (out-of-range picks are redrawn by modulo — cheap and
    deterministic). Returns (src, dst) uint32 arrays of length e_num."""
    if v_num <= 0 or e_num <= 0:
        raise ValueError("rmat_edges needs v_num > 0 and e_num > 0")
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("rmat quadrant probabilities exceed 1")
    scale = max(int(np.ceil(np.log2(max(v_num, 2)))), 1)
    rng = np.random.default_rng(seed)
    src = np.zeros(e_num, dtype=np.int64)
    dst = np.zeros(e_num, dtype=np.int64)
    for _level in range(scale):
        r = rng.random(e_num)
        # quadrant: 0 = (0,0) w.p. a, 1 = (0,1) w.p. b, 2 = (1,0) w.p.
        # c, 3 = (1,1) w.p. d — one random draw, three thresholds
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        src = (src << 1) | down.astype(np.int64)
        dst = (dst << 1) | right.astype(np.int64)
    return (src % v_num).astype(np.uint32), (dst % v_num).astype(np.uint32)


def powerlaw_edges(v_num: int, e_num: int, *, gamma: float = 0.8,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Preferential-attachment flavored edge list: dst sampled
    proportional to ``(in_degree + 1) ** gamma`` (built incrementally in
    chunks so the tail actually forms), src uniform."""
    if v_num <= 0 or e_num <= 0:
        raise ValueError("powerlaw_edges needs v_num > 0 and e_num > 0")
    rng = np.random.default_rng(seed)
    indeg = np.zeros(v_num, dtype=np.float64)
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    done = 0
    while done < e_num:
        n = min(max(v_num // 4, 64), e_num - done)
        w = (indeg + 1.0) ** float(gamma)
        p = w / w.sum()
        dst = rng.choice(v_num, size=n, p=p)
        src = rng.integers(0, v_num, size=n)
        np.add.at(indeg, dst, 1.0)
        srcs.append(src)
        dsts.append(dst)
        done += n
    return (np.concatenate(srcs).astype(np.uint32),
            np.concatenate(dsts).astype(np.uint32))


def synth_edges(kind: str, v_num: int, e_num: int,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    if kind == "rmat":
        return rmat_edges(v_num, e_num, seed=seed)
    if kind == "powerlaw":
        return powerlaw_edges(v_num, e_num, seed=seed)
    raise ValueError(f"unknown graph kind {kind!r} (rmat | powerlaw)")


def synth_data(kind: str, v_num: int, e_num: int, feat_dim: int,
               classes: int, seed: int = 0):
    """(src, dst, GNNDatum) — labels are planted from a random linear
    readout of each vertex's SYMMETRIC 1-hop neighborhood mean (self +
    in + out neighbors), i.e. inside a GCN's receptive field — so the
    model can actually LEARN the labels through aggregation and the
    fine-tune accuracy oracle has signal (a readout of raw per-vertex
    features is near-unlearnable once neighbors are averaged in)."""
    from neutronstarlite_torch.graph.dataset import GNNDatum

    src, dst = synth_edges(kind, v_num, e_num, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feature = rng.standard_normal((v_num, feat_dim)).astype(np.float32) * 0.5
    readout = rng.standard_normal((feat_dim, classes)).astype(np.float32)
    hood = feature.astype(np.float64).copy()
    deg = np.ones(v_num)
    np.add.at(hood, dst, feature[src])
    np.add.at(deg, dst, 1)
    np.add.at(hood, src, feature[dst])
    np.add.at(deg, src, 1)
    hood /= deg[:, None]
    label = np.argmax(hood @ readout, axis=1).astype(np.int32)
    mask = (np.arange(v_num) % 3).astype(np.int32)
    return src, dst, GNNDatum(feature=feature, label=label, mask=mask)


def _feature_row(feat_dim: int, seed: int, index: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 104729 + index)
    return (rng.standard_normal((1, feat_dim)) * 0.5).astype(np.float32)


def delta_trace(src: np.ndarray, dst: np.ndarray, v_num: int,
                feat_dim: int, *, rounds: int = 6, writers: int = 2,
                adds_per_delta: int = 4, removes_per_delta: int = 1,
                vertex_every: int = 3, seed: int = 0
                ) -> List[List[Tuple[str, "object"]]]:
    """A reproducible delta trace: ``rounds`` commit rounds, each a list
    of (writer_id, GraphDelta) in the log's canonical writer order.
    Removals always name an edge live at their canonical application
    point (a running pair-count table mirrors the log's own apply
    order); every ``vertex_every``-th round, the FIRST writer's delta
    appends one vertex wired into the existing graph."""
    from neutronstarlite_torch.serve.delta import GraphDelta

    rng = np.random.default_rng(seed + 2)
    live: Dict[Tuple[int, int], int] = {}
    for s, t in zip(src.tolist(), dst.tolist()):
        live[(s, t)] = live.get((s, t), 0) + 1
    v = int(v_num)
    appended = 0
    trace: List[List[Tuple[str, object]]] = []
    wids = [f"w{i}" for i in range(int(writers))]
    for rnd in range(int(rounds)):
        batch: List[Tuple[str, object]] = []
        for wi, wid in enumerate(sorted(wids)):
            add_vertices = 0
            add_features = None
            add: List[Tuple[int, int]] = []
            if vertex_every and wi == 0 and rnd % vertex_every == (
                    vertex_every - 1):
                add_vertices = 1
                add_features = _feature_row(feat_dim, seed, appended)
                appended += 1
                # wire the newcomer both ways so it can serve AND
                # influence its neighborhood
                peer = int(rng.integers(0, v))
                add.extend([(peer, v), (v, peer)])
                v += 1
            for _ in range(int(adds_per_delta)):
                add.append((int(rng.integers(0, v)), int(rng.integers(0, v))))
            remove: List[Tuple[int, int]] = []
            pool = list(live.keys())
            for _ in range(min(int(removes_per_delta), max(len(pool) - 1, 0))):
                pair = pool[int(rng.integers(0, len(pool)))]
                if pair in live and pair not in remove:
                    remove.append(pair)
            # mirror the canonical apply: removals drop EVERY occurrence
            for pair in remove:
                live.pop(pair, None)
            for pair in add:
                live[pair] = live.get(pair, 0) + 1
            batch.append((wid, GraphDelta.edges(
                add=add, remove=remove, add_vertices=add_vertices,
                add_features=add_features,
            )))
        trace.append(batch)
    return trace


def write_trace_log(log_root: str, graph, trace) -> "object":
    """Stage + commit a :func:`delta_trace` into a DeltaLog at
    ``log_root`` (one commit per round — the round structure IS the
    commit structure, keeping generated removals valid). Returns the
    populated log."""
    from neutronstarlite_torch.stream.log import DeltaLog

    dlog = DeltaLog(log_root, graph)
    if dlog.head_seq:
        raise ValueError(
            f"{log_root} already holds {dlog.head_seq} committed entries; "
            "refusing to regenerate over a live log"
        )
    for batch in trace:
        for wid, delta in batch:
            dlog.writer(wid).stage(delta)
        dlog.commit()
    return dlog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="deterministic synthetic graph + delta-trace "
        "generator: base.npz + a populated stream log from a seed alone"
    )
    ap.add_argument("out_dir")
    ap.add_argument("--kind", choices=("rmat", "powerlaw"), default="rmat")
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--edges", type=int, default=2048)
    ap.add_argument("--feat-dim", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--writers", type=int, default=2)
    ap.add_argument("--adds", type=int, default=4)
    ap.add_argument("--removes", type=int, default=1)
    ap.add_argument("--vertex-every", type=int, default=3,
                    help="append one vertex every Nth round (0 disables)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from neutronstarlite_torch.graph.storage import build_graph

    src, dst, datum = synth_data(
        args.kind, args.vertices, args.edges, args.feat_dim, args.classes,
        seed=args.seed,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(
        os.path.join(args.out_dir, "base.npz"), src=src, dst=dst,
        feature=datum.feature, label=datum.label, mask=datum.mask,
    )
    graph = build_graph(src, dst, args.vertices, use_native=False)
    trace = delta_trace(
        src, dst, args.vertices, args.feat_dim, rounds=args.rounds,
        writers=args.writers, adds_per_delta=args.adds,
        removes_per_delta=args.removes, vertex_every=args.vertex_every,
        seed=args.seed,
    )
    dlog = write_trace_log(os.path.join(args.out_dir, "log"), graph, trace)
    summary = {
        "generator_version": GENERATOR_VERSION,
        "kind": args.kind,
        "seed": args.seed,
        "vertices": args.vertices,
        "edges": int(len(src)),
        "head_seq": dlog.head_seq,
        "head_v_num": int(dlog.head_graph.v_num),
        "base_digest": dlog.base_digest,
        "head_digest": dlog.head_digest,
    }
    if args.json:
        print(json.dumps(summary))
    else:
        print(
            f"{args.out_dir}: {args.kind} graph V={args.vertices} "
            f"E={len(src)}, {dlog.head_seq} committed deltas "
            f"(head V={int(dlog.head_graph.v_num)}), head digest "
            f"{dlog.head_digest[:12]}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
