"""Exact wire accounting of the distributed exchanges, chip-free — port of
``neutronstarlite_tpu/tools/wire_accounting.py``.

- ``exchange_rows_per_device`` and ``peak_resident_rows``: the formulas
  behind the distributed trainers' ``wire.*`` gauges and counters
  (``mirror`` prices the split mirror of the GCN family and the uniform
  mirror of GATDIST, GGCNDIST and the DepCache GCN, whose partial fetch is
  priced at its cold slots ``mf``; ``ring`` the fused edge ring);
- ``predict_mesh``: the 2D mesh's wire and residency;
- ``predict_all``: every strategy's rows, residency and bytes for one
  (graph, P, f), the autotuner's analytic prior and the ``--json`` payload;
- ``accounting``: the per-layer table, the DepCache threshold ladder at
  refresh cadence R (``(P-1) * (mf + mc / R)`` rows per layer) and checks
  that ``COMM_LAYER:auto`` is the wire argmin and ``REP_THRESHOLD:auto``
  the least wire whose cache fits the budget;
- ``sample_batch_payload_bytes`` (kept in ``sample/pipeline.py``) and
  ``sample_h2d_bytes_per_epoch``: the sampled path's host-to-device bytes.

Usage::

    python -m neutronstarlite_torch.tools.wire_accounting
        [--scale 1.0 | --cora] [--partitions 8] [--feature 602]
        [--refresh 3] [--budget-mib 256] [--mesh Pv,Pf] [--json]

prints one JSON line (and the human-readable table on stderr). The
default graph is ``synthetic_power_law_graph`` at Reddit's size times
``--scale``, seed 7 (the JAX tool's, which it caches on disk; this one
builds it in memory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from neutronstarlite_torch.sample.pipeline import sample_batch_payload_bytes  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def exchange_rows_per_device(kind: str, P: int, vp: int, mb: int = 0) -> int:
    """Remote feature rows one partition receives per layer exchange: the
    dense exchanges (the ring, the all_gather family, ``ring_blocked``)
    deliver P - 1 shards of ``vp`` rows, the mirror all_to_all P - 1
    compacted chunks of ``mb`` rows."""
    if P <= 1:
        return 0
    if kind in ("mirror", "mirror_uniform"):
        return (P - 1) * mb
    return (P - 1) * vp


def sample_h2d_bytes_per_epoch(n_seeds: int, node_caps, fanouts, mode: str = "sync") -> int:
    """Per-epoch sampled-path host-to-device bytes of a SAMPLE_PIPELINE
    mode: batches per epoch times one padded payload for the host-staged
    modes (sync, pipelined and device ship the same payload), 0 for
    fused."""
    if mode == "fused":
        return 0
    B = int(node_caps[-1])
    n_batches = -(-int(n_seeds) // max(B, 1))
    return n_batches * sample_batch_payload_bytes(node_caps, fanouts)


def peak_resident_rows(kind: str, P: int, vp: int, mb: int = 0) -> int:
    """Exchange-buffer rows live at once per partition: every shard for the
    all_gather family (P*vp), two for the rings (resident and in flight),
    the mirror's P chunks of ``mb``."""
    if P <= 1:
        return vp
    if kind in ("mirror", "mirror_uniform"):
        return P * mb
    if kind in ("ring", "ring_blocked"):
        return min(2, P) * vp
    return P * vp


def predict_mesh(g, pv: int, pf: int, widths, itemsize: int = 4,
                 out_widths=None) -> dict:
    """Per-rank wire and memory of the 2D mesh on one graph: the vertex
    ring's bytes per epoch ((pv-1) hops per layer, each a ``[vp,
    slab_width(w, pf)]`` slab: what the live ``wire.bytes_fwd`` counter
    carries), the feature all-reduce's (a ring all-reduce moves ~2(pf-1)/pf
    of each ``[vp, w_out]`` product; analytic only) and the double-buffered
    residency at slab width (the ``wire.peak_resident_feature_bytes``
    gauge)."""
    from neutronstarlite_torch.graph.storage import partition_offsets
    from neutronstarlite_torch.parallel.partitioner import slab_width
    from neutronstarlite_torch.parallel.vertex_space import round_up

    pv, pf = max(int(pv), 1), max(int(pf), 1)
    offsets = partition_offsets(g.v_num, g.in_degree, pv)
    vp = round_up(int(np.diff(offsets).max()), 8)  # DistGraph.build's rule
    widths = [int(w) for w in widths]
    outs = [int(w) for w in (out_widths if out_widths else widths)]
    slabs = [slab_width(w, pf) for w in widths]
    rows = (pv - 1) * vp
    peak_rows = min(2, pv) * vp
    return {
        "pv": pv, "pf": pf, "vp": int(vp),
        "slab_widths": slabs,
        "exchange_rows": int(rows),
        "bytes_per_epoch": int(rows * sum(slabs) * itemsize),
        "allreduce_bytes_per_epoch": int(
            sum(2 * (pf - 1) * vp * w // pf for w in outs) * itemsize
        ),
        "peak_resident_rows": int(peak_rows),
        "peak_resident_feature_bytes": int(
            peak_rows * (max(slabs) if slabs else 0) * itemsize
        ),
    }


def predict_all(g, P: int, f: int, widths=None, itemsize: int = 4, mesh=None) -> dict:
    """Every strategy's exchange rows, peak resident rows and bytes per
    epoch for one (graph, P, f): the autotuner's prior and the CLI's
    ``--json`` payload. ``widths``: the per-layer exchange widths (default
    ``[f]``); ``itemsize``: bytes per value on the wire; ``mesh=(pv, pf)``
    adds the 2D layout as strategy ``ring2d`` (``predict_mesh``)."""
    from neutronstarlite_torch.parallel.mirror import MirrorGraph, SplitMirror

    mb_uni, vp = MirrorGraph.estimate_mb(g, P)
    mb, _ = SplitMirror.estimate_mb_remote(g, P)
    widths = [int(w) for w in (widths if widths else [f])]
    mbs = {"mirror": mb, "mirror_uniform": mb_uni}
    strategies = {}
    for kind in ("ring", "ell", "blocked", "ring_blocked", "mirror", "mirror_uniform"):
        m = mbs.get(kind, 0)
        rows = exchange_rows_per_device(kind, P, vp, m)
        peak = peak_resident_rows(kind, P, vp, m)
        strategies[kind] = {
            "exchange_rows": int(rows),
            "peak_resident_rows": int(peak),
            "bytes_per_epoch": int(rows * sum(widths) * itemsize),
            "peak_resident_bytes": int(peak * max(widths) * itemsize),
        }
    if mesh is not None:
        pv, pf = (int(x) for x in mesh)
        strategies["ring2d"] = predict_mesh(g, pv, pf, widths, itemsize=itemsize)
    return {
        "P": int(P), "f": int(f), "vp": int(vp), "mb": int(mb),
        "mb_uniform": int(mb_uni), "widths": widths,
        "itemsize": int(itemsize), "strategies": strategies,
    }


def accounting(g, P: int, f: int, refresh: int, budget_bytes: int, thresholds=None) -> dict:
    """The per-layer wire and residency table, the DepCache ladder and the
    two auto policies against the wire argmin. Counts are per partition
    per layer unless named otherwise; bytes are f32 rows at width f."""
    from neutronstarlite_torch.parallel.feature_cache import CachedMirrorGraph
    from neutronstarlite_torch.parallel.mirror import MirrorGraph, SplitMirror

    mb_uni, vp = MirrorGraph.estimate_mb(g, P)
    # the GCN family ships the split mirror (remote need-sets only); the
    # uniform layout's price is the GAT and DepCache chains'
    mb, _ = SplitMirror.estimate_mb_remote(g, P)
    dense_rows = exchange_rows_per_device("ring", P, vp)
    mirror_rows = exchange_rows_per_device("mirror", P, vp, mb)
    mirror_uni_rows = exchange_rows_per_device("mirror", P, vp, mb_uni)
    layer_rows = {
        "ring": dense_rows, "ell": dense_rows, "blocked": dense_rows,
        "ring_blocked": dense_rows,
        "mirror": mirror_rows, "mirror_uniform": mirror_uni_rows,
    }
    out = {
        "P": P, "f": f, "vp": vp, "mb": mb, "mb_uniform": mb_uni,
        "layers": layer_rows,
        "bytes_per_layer": {k: v * f * 4 for k, v in layer_rows.items()},
        # the memory half: each mirror flavour at its own slot count
        "peak_resident_rows": {
            k: peak_resident_rows(k, P, vp, {"mirror": mb, "mirror_uniform": mb_uni}.get(k, 0))
            for k in layer_rows
        },
    }
    out["peak_resident_bytes"] = {k: v * f * 4 for k, v in out["peak_resident_rows"].items()}

    # threshold ladder: degree percentiles of the mirror sources
    if thresholds is None:
        degs = g.out_degree[g.out_degree > 0]
        thresholds = sorted({int(np.percentile(degs, q)) for q in (50, 75, 90, 99)} | {1})
    ladder = []
    for t in thresholds:
        cm = CachedMirrorGraph.build(g, P, replication_threshold=t)
        amortized = (P - 1) * (cm.mf + cm.mc / max(refresh, 1))
        ladder.append({
            "threshold": t, "mc": cm.mc, "mf": cm.mf,
            "hot_fraction": round(float(cm.cached_fraction), 4),
            "fetch_rows": (P - 1) * cm.mf,
            "amortized_rows": round(amortized, 1),
            "cached_bytes_device": P * cm.mc * f * 4,
        })
    out["depcache"] = ladder

    # the auto decisions against the wire argmin
    from neutronstarlite_torch.models.gcn_dist import resolve_comm_layer
    from neutronstarlite_torch.utils.config import InputInfo

    cfg = InputInfo()
    cfg.comm_layer = "auto"
    auto_choice = resolve_comm_layer(cfg, g, P)
    wire_argmin = min(out["layers"], key=out["layers"].get)
    out["comm_auto"] = {
        "choice": auto_choice,
        "wire_argmin": wire_argmin,
        # the mirror and the dense layers tie when compaction saturates
        # (mb == vp); the tie goes to the mirror, wire-equivalent
        "wire_optimal": out["layers"][auto_choice] == out["layers"][wire_argmin],
    }

    t_auto = CachedMirrorGraph.choose_replication_threshold(g, P, f, budget_bytes)
    cm_auto = CachedMirrorGraph.build(g, P, replication_threshold=t_auto)
    fits = P * cm_auto.mc * f * 4 <= budget_bytes
    # no ladder threshold that fits ships strictly less wire (compared by
    # wire: thresholds can induce the same hot/cold split)
    smaller_wire_fitting = [
        e for e in ladder if e["cached_bytes_device"] <= budget_bytes and e["mf"] < cm_auto.mf
    ]
    out["rep_auto"] = {
        "threshold": t_auto, "mc": cm_auto.mc, "mf": cm_auto.mf,
        "cached_bytes_device": P * cm_auto.mc * f * 4,
        "budget_bytes": budget_bytes,
        "fits": fits,
        "wire_minimal_under_budget": not smaller_wire_fitting,
    }
    return out


def _graph(cora: bool, scale: float):
    """(graph, name): the Cora fixture, or the synthetic Reddit at ``scale``."""
    from neutronstarlite_torch.graph.storage import build_graph, load_edges

    if cora:
        fix = os.path.join(REPO, "tests", "fixtures", "cora")
        src, dst = load_edges(os.path.join(fix, "cora.2708.edge.self"))
        return build_graph(src, dst, 2708, weight="gcn_norm"), "cora"
    from neutronstarlite_torch.graph.synthetic import REDDIT_E, REDDIT_V, synthetic_power_law_graph

    v_num = max(int(REDDIT_V * scale), 64)
    e_num = max(int(REDDIT_E * scale), 512)
    src, dst = synthetic_power_law_graph(v_num, e_num, seed=7)
    return build_graph(src, dst, v_num, weight="gcn_norm"), f"reddit_synth_x{scale:g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--cora", action="store_true")
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--feature", type=int, default=602)
    ap.add_argument("--refresh", type=int, default=3)
    ap.add_argument("--budget-mib", type=int, default=256)
    ap.add_argument("--mesh", default="",
                    help="Pv,Pf: also price the 2D (vertex x feature) layout "
                    "(strategy 'ring2d' in the --json payload)")
    ap.add_argument("--json", action="store_true",
                    help="print predict_all's per-strategy prediction as one JSON line "
                    "and skip the DepCache ladder and the auto-policy checks")
    args = ap.parse_args(argv)

    g, name = _graph(args.cora, args.scale)
    mesh = None
    if args.mesh:
        from neutronstarlite_torch.parallel.partitioner import MeshSpec

        spec = MeshSpec.parse(args.mesh)
        mesh = (spec.pv, spec.pf)

    if args.json:
        out = predict_all(g, args.partitions, args.feature, mesh=mesh)
        out["graph"] = name
        print(json.dumps(out))
        return 0

    out = accounting(g, args.partitions, args.feature, args.refresh, args.budget_mib << 20)
    out["graph"] = name
    print(
        "\n".join(
            [f"wire accounting: {name} P={out['P']} f={out['f']} "
             f"vp={out['vp']} mb={out['mb']}"]
            + [f"  {k:14s} {v:>12d} rows/dev/layer "
               f"({out['bytes_per_layer'][k] / 2**20:.1f} MiB wire, "
               f"{out['peak_resident_rows'][k]:>8d} rows "
               f"{out['peak_resident_bytes'][k] / 2**20:.1f} MiB resident)"
               for k, v in out["layers"].items()]
            + [f"  depcache t={e['threshold']:>6d}: mc={e['mc']:>6d} "
               f"mf={e['mf']:>6d} hot={e['hot_fraction']:.3f} "
               f"amortized={e['amortized_rows']:>10.0f} rows/dev/layer"
               for e in out["depcache"]]
            + [f"  comm auto -> {out['comm_auto']['choice']} "
               f"(wire argmin {out['comm_auto']['wire_argmin']}, "
               f"optimal={out['comm_auto']['wire_optimal']})",
               f"  rep auto -> t={out['rep_auto']['threshold']} "
               f"fits={out['rep_auto']['fits']} "
               f"minimal={out['rep_auto']['wire_minimal_under_budget']}"]
        ),
        file=sys.stderr,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
