"""The bench tools' workload: the Reddit-scale synthetic graph, cached.

The port's own copy of what ``tools/bench_sample.py`` and
``tools/sample_bench.py`` take from the root ``bench.py``: the layer
widths and label count of the north-star workload, the watchdog, and the
host graph cache (``bench.py``'s ``_CACHE_FIELDS``, ``cache_dir_for``,
``build_and_cache_graph``, ``load_cached_graph``). The graph is
``graph/synthetic.synthetic_power_law_graph`` at Reddit's V and E times
``scale``, seed 7, GCN-normalised weights, built once by
``graph/storage.build_graph`` (native when ``native/`` is available, else
NumPy) and written as ``.npy`` files.

The cache key names the builder (``native`` or ``numpy``: a native build
sorts a destination's edges by source, the NumPy one keeps their input
order) and ends in ``_torch``, so neither package, nor either builder,
reads graph files that the other built. The cache lives
under ``NTS_BENCH_CACHE``, else ``nts_bench_cache`` in the temporary
directory (``TMPDIR``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from neutronstarlite_torch.graph.synthetic import REDDIT_E, REDDIT_V

LAYERS = "602-128-41"
N_LABELS = 41
SEED = 7

_CACHE_FIELDS = (
    "column_offset", "row_indices", "dst_of_edge", "edge_weight_forward",
    "row_offset", "column_indices", "src_of_edge", "edge_weight_backward",
    "out_degree", "in_degree",
)


def start_watchdog(deadline_s: float):
    """Bound total wall time: on expiry, dump every thread's stack to stderr
    and exit 3, so that a hang still leaves a diagnosable tail."""

    def fire():
        import faulthandler

        print(f"WATCHDOG: bench exceeded {deadline_s:.0f}s; dumping stacks",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        os._exit(3)

    t = threading.Timer(deadline_s, fire)
    t.daemon = True
    t.start()
    return t


def graph_size(scale: float):
    """(V, E) of the workload at ``scale`` (bench.py's floors: 64 and 512)."""
    return max(int(REDDIT_V * scale), 64), max(int(REDDIT_E * scale), 512)


def cache_root() -> str:
    return os.environ.get("NTS_BENCH_CACHE") or os.path.join(
        tempfile.gettempdir(), "nts_bench_cache")


def builder() -> str:
    """The host graph builder this process uses: ``native`` or ``numpy``."""
    from neutronstarlite_torch import native

    return "native" if native.available() else "numpy"


def _key_suffix(v_num: int, e_num: int, built_by: str) -> str:
    return f"V{v_num}_E{e_num}_seed{SEED}_gcnnorm_{built_by}_torch"


def cache_dir_for(scale: float, v_num: int, e_num: int) -> str:
    """The key encodes everything the cached bytes depend on (size,
    generator seed, weight scheme, the builder, the building package)."""
    return os.path.join(cache_root(),
                        f"scale_{scale:g}_{_key_suffix(v_num, e_num, builder())}")


def build_and_cache_graph(scale: float):
    """Synthesize the edge list, build the dual CSC/CSR and write both to the
    cache directory; a finished cache (its ``ok`` marker) is reused.
    Returns (directory, V, E, build seconds: 0.0 on a hit)."""
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph

    v_num, e_num = graph_size(scale)
    d = cache_dir_for(scale, v_num, e_num)
    marker = os.path.join(d, "ok")
    if os.path.exists(marker):
        return d, v_num, e_num, 0.0
    t0 = time.time()
    os.makedirs(d, exist_ok=True)
    src, dst = synthetic_power_law_graph(v_num, e_num, seed=SEED)
    g = build_graph(src, dst, v_num, weight="gcn_norm",
                    use_native=os.path.basename(d).endswith("_native_torch"))
    np.save(os.path.join(d, "src.npy"), src)
    np.save(os.path.join(d, "dst.npy"), dst)
    for name in _CACHE_FIELDS:
        np.save(os.path.join(d, name + ".npy"), getattr(g, name))
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump({"v_num": int(g.v_num), "e_num": int(g.e_num)}, fh)
    with open(marker, "w") as fh:
        fh.write("ok")
    return d, v_num, e_num, time.time() - t0


def load_cached_graph(d: str):
    """(CSCGraph, src, dst) from a cache directory; raises on a directory
    whose name does not match the graph it holds (a stale cache)."""
    from neutronstarlite_torch.graph.storage import CSCGraph

    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    name = os.path.basename(d)
    if not any(name.endswith(_key_suffix(meta["v_num"], meta["e_num"], b))
               for b in ("native", "numpy")):
        raise ValueError(f"stale graph cache {d}: meta {meta}")
    fields = {name: np.load(os.path.join(d, name + ".npy")) for name in _CACHE_FIELDS}
    g = CSCGraph(v_num=meta["v_num"], e_num=meta["e_num"], **fields)
    src = np.load(os.path.join(d, "src.npy"))
    dst = np.load(os.path.join(d, "dst.npy"))
    return g, src, dst
