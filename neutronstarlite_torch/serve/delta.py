"""Live graph-delta ingestion: node/edge updates applied between flushes —
port of ``neutronstarlite_tpu/serve/delta.py``.

A :class:`GraphDelta` (edge inserts/removes, vertex appends with their
feature rows) is turned into a :class:`DeltaPlan` — the post-delta host
graph plus the exact incremental damage — and applied to one or many
engines/servers between flushes. ``GraphDelta``, ``DeltaPlan`` and
``plan_delta`` are the reference's NumPy code, but for the removal mask
(``_removal_mask``): the rebuilt CSC, the two dirty sets and the digest
are bitwise the reference's.

- **Host graph rebuild, deterministically.** The edge list is extracted
  from the live CSC, edited, and rebuilt through the NumPy
  ``build_graph``: a fresh build over the same edited edge list is
  bitwise the same graph, so served predictions after a delta are held
  against a genuinely fresh engine. Removing an edge that does not exist
  raises; removal drops EVERY occurrence of a listed (src, dst) pair.
- **Incremental invalidation.** ``dirty_rows`` (vertices whose in-neighbour
  set changed) are the only device neighbour-table rows patched;
  ``dirty`` (vertices whose served logits can differ: the out-edge closure
  over the old and new graphs, L-1 hops, of every vertex whose aggregation
  input changed) are the only embedding-cache entries dropped.
- **Digest bump.** The plan carries the post-delta ``graph_digest``;
  applying it updates the toolkit's cached digest, so the tune-cache and
  perf-ledger keys see a different graph.

Where the port differs: JAX builds new arrays for every change, and an
in-flight flush keeps the pre-delta arrays it snapshotted. A captured CUDA
graph reads fixed addresses, so the port writes in place wherever a shape
holds (the neighbour table's rows, the fused degree tables, appended
feature rows within a reserved margin; see serve/engine.py and
sample/device_sampler.py), and keeps the staleness contract by draining:
``apply_to_servers`` takes every server's graph gate (no flush is being
produced) and waits until every flush already prepared has executed, so
those answer from the pre-delta view, before it writes anything. A vertex
append past the margin makes a new feature slab (the appended rows at
``v0..``, the slack cut) and clears both bucket ladders, which capture
again once per bucket, loudly; edge-only deltas capture nothing.

Every application emits one typed ``graph_delta`` obs record per server.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import CSCGraph, build_graph
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("serve")


def _ids(v) -> np.ndarray:
    return np.asarray(v, dtype=np.int64).reshape(-1)


@dataclasses.dataclass
class GraphDelta:
    """One batch of live-graph updates (all fields optional/empty)."""

    add_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    remove_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    remove_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_vertices: int = 0
    # feature rows for the appended vertices ([add_vertices, f]); required
    # whenever add_vertices > 0 — a vertex without features cannot serve
    add_features: Optional[np.ndarray] = None

    def __post_init__(self):
        self.add_src = _ids(self.add_src)
        self.add_dst = _ids(self.add_dst)
        self.remove_src = _ids(self.remove_src)
        self.remove_dst = _ids(self.remove_dst)
        if len(self.add_src) != len(self.add_dst):
            raise ValueError("add_src/add_dst length mismatch")
        if len(self.remove_src) != len(self.remove_dst):
            raise ValueError("remove_src/remove_dst length mismatch")
        if self.add_vertices < 0:
            raise ValueError("add_vertices must be >= 0")
        if self.add_vertices and self.add_features is None:
            raise ValueError(
                "add_vertices > 0 needs add_features rows — an appended "
                "vertex without features cannot be served"
            )

    @classmethod
    def edges(cls, add: Iterable[Tuple[int, int]] = (),
              remove: Iterable[Tuple[int, int]] = (),
              add_vertices: int = 0,
              add_features: Optional[np.ndarray] = None) -> "GraphDelta":
        """Convenience constructor from (src, dst) pair lists."""
        add = list(add)
        remove = list(remove)
        return cls(
            add_src=np.array([e[0] for e in add], np.int64),
            add_dst=np.array([e[1] for e in add], np.int64),
            remove_src=np.array([e[0] for e in remove], np.int64),
            remove_dst=np.array([e[1] for e in remove], np.int64),
            add_vertices=add_vertices,
            add_features=add_features,
        )

    @property
    def empty(self) -> bool:
        return (len(self.add_src) == 0 and len(self.remove_src) == 0
                and self.add_vertices == 0)


@dataclasses.dataclass
class DeltaPlan:
    """The post-delta graph plus the exact incremental damage."""

    src: np.ndarray  # the edited edge list (CSC order — dst-sorted)
    dst: np.ndarray
    v_num: int
    graph: CSCGraph  # rebuilt via the deterministic NumPy path
    digest: str  # canonical post-delta graph digest
    dirty_rows: np.ndarray  # in-neighbor SET changed -> device-table rows
    dirty: np.ndarray  # predictions possibly changed -> cache invalidation
    added_edges: int
    removed_edges: int
    added_vertices: int
    add_features: Optional[np.ndarray]
    hops: int
    rows_patched: int = 0  # filled by apply_to_engines


def _edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    # vertex ids are < 2**32 (uint32 storage), so one int64 packs a pair
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def _removal_mask(keys: np.ndarray, rm_keys: np.ndarray):
    """(keep, present): ``~np.isin(keys, rm_keys)`` and ``np.isin(rm_keys,
    keys)`` for the sorted, unique ``rm_keys``, through one binary search of
    each key. The reference calls ``np.isin`` both ways; for a few keys
    among the graph's millions, the NumPy of the H100 machine builds a
    hashed unique of the millions first (12.1 s of a 17.9 s plan_delta at
    0.1 of Reddit there), which every delta that removes an edge paid."""
    pos = np.searchsorted(rm_keys, keys)
    hit = rm_keys[np.minimum(pos, len(rm_keys) - 1)] == keys
    present = np.zeros(len(rm_keys), dtype=bool)
    present[pos[hit]] = True
    return ~hit, present


def _out_neighbors(g: CSCGraph, vs: np.ndarray) -> np.ndarray:
    """Unique destinations of the out-edges of ``vs`` (CSR walk); ids
    beyond the graph (appended vertices walked on the OLD graph) are
    skipped."""
    vs = np.unique(vs)
    vs = vs[(vs >= 0) & (vs < g.v_num)]
    if len(vs) == 0:
        return np.empty(0, np.int64)
    deg = g.out_degree[vs].astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        return np.empty(0, np.int64)
    starts = g.row_offset[vs].astype(np.int64)
    within = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    idx = np.repeat(starts, deg) + within
    return np.unique(g.column_indices[idx].astype(np.int64))


def plan_delta(graph: CSCGraph, delta: GraphDelta, hops: int,
               dirty_closure=None) -> DeltaPlan:
    """Turn a delta into the post-delta graph + dirty sets (pure).

    ``dirty_closure`` swaps the exact out-closure for an approximate one
    (stream/ingest.py's bitset tracker): a callable
    ``(old_graph, new_graph, changed_src, changed_dst, hops) -> dirty``
    whose result must be a SUPERSET of the exact closure — invalidating
    extra cache rows costs recompute, missing one serves stale logits.
    """
    old_src = graph.row_indices.astype(np.int64)
    old_dst = graph.dst_of_edge.astype(np.int64)
    new_v = graph.v_num + int(delta.add_vertices)

    for name, arr in (("add_src", delta.add_src), ("add_dst", delta.add_dst),
                      ("remove_src", delta.remove_src),
                      ("remove_dst", delta.remove_dst)):
        if len(arr) and (int(arr.min()) < 0 or int(arr.max()) >= new_v):
            raise ValueError(
                f"graph delta {name} references vertex "
                f"{int(arr.max() if arr.max() >= new_v else arr.min())} "
                f"outside 0..{new_v - 1}"
            )

    mask = np.ones(len(old_src), dtype=bool)
    removed = 0
    if len(delta.remove_src):
        keys = _edge_keys(old_src, old_dst)
        rm_keys = np.unique(_edge_keys(delta.remove_src, delta.remove_dst))
        mask, present = _removal_mask(keys, rm_keys)
        if not present.all():
            missing = rm_keys[~present][:5]
            pairs = [(int(k >> 32), int(k & 0xFFFFFFFF)) for k in missing]
            raise ValueError(
                f"graph delta removes edge(s) that do not exist: {pairs}"
                + (" ..." if (~present).sum() > 5 else "")
            )
        removed = int((~mask).sum())

    src = np.concatenate([old_src[mask], delta.add_src])
    dst = np.concatenate([old_dst[mask], delta.add_dst])
    # the NumPy path: a stable dst-sort of this (already mostly sorted)
    # list — deterministic, so a fresh build over the same edited list is
    # bitwise identical (the oracle's ground)
    g2 = build_graph(
        src.astype(np.uint32), dst.astype(np.uint32), new_v,
        weight="gcn_norm", use_native=False,
    )

    changed_dst = np.unique(np.concatenate([delta.remove_dst, delta.add_dst]))
    changed_src = np.unique(np.concatenate([delta.remove_src, delta.add_src]))
    if dirty_closure is not None:
        dirty = np.unique(np.asarray(
            dirty_closure(graph, g2, changed_src, changed_dst, int(hops)),
            dtype=np.int64,
        ))
    else:
        # aggregation inputs that changed: touched destinations (in-degree
        # renormalizes every in-edge weight) + out-neighbors of touched
        # sources (out-degree renormalizes every out-edge weight) — walked
        # on BOTH graphs so removed reach still counts
        seed = np.unique(np.concatenate([
            changed_dst,
            _out_neighbors(graph, changed_src),
            _out_neighbors(g2, changed_src),
        ])).astype(np.int64)
        dirty = seed
        frontier = seed
        for _ in range(max(int(hops) - 1, 0)):
            nxt = np.union1d(
                _out_neighbors(graph, frontier), _out_neighbors(g2, frontier)
            )
            fresh = np.setdiff1d(nxt, dirty, assume_unique=False)
            if len(fresh) == 0:
                break
            dirty = np.union1d(dirty, fresh)
            frontier = fresh

    return DeltaPlan(
        src=src, dst=dst, v_num=new_v, graph=g2, digest=graph_digest(g2),
        dirty_rows=changed_dst.astype(np.int64), dirty=dirty,
        added_edges=int(len(delta.add_src)), removed_edges=removed,
        added_vertices=int(delta.add_vertices),
        add_features=delta.add_features, hops=int(hops),
    )


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def apply_to_engines(engines: Sequence, delta: GraphDelta,
                     plan: Optional[DeltaPlan] = None) -> DeltaPlan:
    """Swap the post-delta graph into every engine (no server state; the
    caller keeps flushes out of the way, as ``apply_to_servers`` does).

    Engines cloned from one template share the toolkit, the device hop
    sampler, the fused degree tables and the bucket ladders: the shared
    pieces are patched exactly once; per-engine samplers each get the new
    graph. Returns the plan (``plan.rows_patched`` set)."""
    base = engines[0]
    if plan is None:
        plan = plan_delta(base.sampler.graph, delta, hops=len(base.fanouts))
    g = plan.graph

    new_feature = None
    if plan.added_vertices:
        feat = base.feature
        rows = np.asarray(plan.add_features)
        if rows.ndim != 2 or rows.shape[0] != plan.added_vertices \
                or rows.shape[1] != feat.shape[1]:
            raise ValueError(
                f"add_features must be [{plan.added_vertices}, "
                f"{feat.shape[1]}], got {rows.shape}"
            )
        v0 = plan.v_num - plan.added_vertices
        rows_t = torch.from_numpy(np.ascontiguousarray(rows)).to(feat.device, feat.dtype)
        if int(feat.shape[0]) >= plan.v_num:
            # the capture-free path (stream/ingest.reserve_feature_margin):
            # the slab was pre-sized with slack rows, so the appended rows
            # are written into it; no pre-delta draw indexes a row >= v0
            feat[v0:plan.v_num] = rows_t
            log.info(
                "graph delta appended %d vertices within the capacity "
                "margin (%d slack rows remain): feature rows patched in "
                "place, bucket ladders untouched",
                plan.added_vertices, int(feat.shape[0]) - plan.v_num,
            )
        else:
            new_feature = torch.cat([feat[:v0], rows_t], dim=0)
            if int(feat.shape[0]) > v0 or getattr(base, "margin_armed", False):
                log.warning(
                    "graph delta appended %d vertices, OVERFLOWING the "
                    "capacity margin (%d slack rows available): falling "
                    "back to the full ladder-invalidation path",
                    plan.added_vertices, int(feat.shape[0]) - v0,
                )

    rows_patched = 0
    seen = set()
    for eng in engines:
        h = eng.sampler.hop_sampler
        if h is not None and id(h) not in seen:
            rows_patched += h.apply_delta(g, plan.dirty_rows)
            seen.add(id(h))
        eng.sampler.set_graph(g)
        tk = eng.toolkit
        if id(tk) not in seen:
            tk.host_graph = g
            # the tuner/ledger keying follows the live graph
            tk._tune_graph_digest = plan.digest
            seen.add(id(tk))
        if id(eng._fused_shared) not in seen:
            eng.refresh_fused_degrees()
            seen.add(id(eng._fused_shared))
        if new_feature is not None:
            eng.feature = new_feature
            if id(eng._compiled) not in seen:
                seen.add(id(eng._compiled))
                n = len(eng._compiled) + len(eng._fused_compiled)
                if n:
                    log.warning(
                        "graph delta appended %d vertices: the feature slab "
                        "changed shape, dropping %d captured bucket(s); the "
                        "next flush per bucket captures once",
                        plan.added_vertices, n,
                    )
                eng._compiled.clear()
                eng._fused_compiled.clear()
    if new_feature is not None:
        # the fine-tune worker trains over the same slab the engines serve
        for tk in {id(e.toolkit): e.toolkit for e in engines}.values():
            tk.feature = new_feature
    if base.device.type == "cuda":
        # the writes above ran on this thread's stream, the replays run on
        # the engines' own: finish them before a flush can read the tables
        torch.cuda.synchronize(base.device)
    plan.rows_patched = rows_patched
    return plan


def apply_to_servers(servers: Sequence, delta: GraphDelta,
                     extra_engines: Sequence = (),
                     plan: Optional[DeltaPlan] = None,
                     dirty_closure=None) -> DeltaPlan:
    """The full between-flushes application over one or many servers
    (the fleet path): compute the plan once, take every server's graph
    gate (no flush is being produced), wait until every prepared flush has
    executed, swap the engines, invalidate only the dirty embedding-cache
    entries, refresh hot masks, bump graph versions, and emit one
    ``graph_delta`` record per server stream. ``plan``/``dirty_closure``
    are the stream ingestor's hooks (precomputed plan; approximate dirty
    closure)."""
    if not servers:
        raise ValueError("apply_to_servers needs at least one server")
    t0 = time.perf_counter()
    base = servers[0].engine
    if plan is None:
        plan = plan_delta(base.sampler.graph, delta, hops=len(base.fanouts),
                          dirty_closure=dirty_closure)
    engines: List = []
    seen = set()
    for eng in [s.engine for s in servers] + list(extra_engines):
        if id(eng) not in seen:
            seen.add(id(eng))
            engines.append(eng)
    with contextlib.ExitStack() as stack:
        for s in servers:
            stack.enter_context(s._graph_gate)
        for s in servers:
            s.drain_prepared()
        apply_to_engines(engines, delta, plan=plan)
        rows_patched = plan.rows_patched
        seconds = time.perf_counter() - t0
        for s in servers:
            n_inv = s.cache.invalidate(plan.dirty)
            if s.opts.hot_threshold > 0:
                from neutronstarlite_torch.parallel.feature_cache import hot_vertex_mask

                s.cache.hot_mask = hot_vertex_mask(plan.graph, s.opts.hot_threshold)
            s._graph_version += 1
            if s.metrics is not None:
                s.metrics.counter_add("serve.graph_deltas")
                s.metrics.gauge_set("graph.digest", plan.digest)
                fields = dict(
                    added_edges=plan.added_edges,
                    removed_edges=plan.removed_edges,
                    added_vertices=plan.added_vertices,
                    graph_digest=plan.digest,
                    cache_invalidated=int(n_inv),
                    rows_patched=int(rows_patched),
                    dirty_predictions=int(len(plan.dirty)),
                    seconds=float(seconds),
                )
                if getattr(s, "replica", None):
                    fields["replica"] = s.replica
                s.metrics.event("graph_delta", **fields)
    log.info(
        "graph delta applied: +%de -%de +%dv, %d dirty prediction(s), "
        "%d device row(s) patched, digest %s (%.1f ms)",
        plan.added_edges, plan.removed_edges, plan.added_vertices,
        len(plan.dirty), rows_patched, plan.digest[:12],
        (time.perf_counter() - t0) * 1000.0,
    )
    return plan
