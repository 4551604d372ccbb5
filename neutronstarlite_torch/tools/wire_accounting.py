"""Wire accounting of the distributed exchanges — the part of
``neutronstarlite_tpu/tools/wire_accounting.py`` the distributed trainers
use: ``exchange_rows_per_device`` and ``peak_resident_rows`` (the formulas
behind their ``wire.*`` gauges and counters: ``mirror`` prices the split
mirror of the GCN family and the uniform mirror of GATDIST, GGCNDIST and
the DepCache GCN, whose partial fetch is priced at its cold slots ``mf``;
``ring`` the fused edge ring) and ``predict_mesh`` (the 2D mesh's). The
offline report and its policy checks come with a later slice.
"""

from __future__ import annotations

import numpy as np


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
