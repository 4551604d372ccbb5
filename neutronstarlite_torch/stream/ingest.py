"""Capture-free high-rate delta ingestion for a serving fleet — port of
``neutronstarlite_tpu/stream/ingest.py``.

Two costs dominate a delta stream at high rates, and this module removes
both:

**Vertex-capacity margin.** A vertex append past the feature slab's rows
makes a new slab, and every captured bucket (which reads the old one by
address) is dropped and captured again. :func:`reserve_feature_margin`
pre-sizes the slab to ``[V + margin, f]`` (``NTS_STREAM_VERTEX_MARGIN``)
BEFORE warmup, so the ladder captures over the padded slab once; appends
within the margin write feature rows into the reserved slack
(serve/delta.py's in-margin branch) and the ladder never notices —
``compile_counts`` stays pinned (test-asserted). Slack rows are zero and
unreachable: sampling only ever returns ids below the live ``v_num``.
Overflowing the margin degrades LOUDLY to the full-invalidation path. The
device neighbour table gets the same treatment
(``DeviceUniformSampler.reserve_capacity``), and the fused degree tables
follow the table's row capacity.

**Bitset approximate dirty closure.** ``NTS_STREAM_DIRTY=bitset`` swaps
the exact out-edge closure for :class:`BitsetDirtyTracker`: vertices hash
into B buckets (``NTS_STREAM_DIRTY_BUCKETS``, default 1024), a ``[B, B]``
boolean bucket-adjacency matrix summarizes the edge set, and the closure
runs at bucket granularity. ``v -> w`` implies ``bucket(v) -> bucket(w)``,
so the expanded vertex set is a SUPERSET of exact: extra invalidations
cost recompute, never staleness. Added edges set bits incrementally;
removals leave stale bits (still a superset). The false-positive rate is
measured against the exact closure on an audit cadence
(``NTS_STREAM_DIRTY_AUDIT``, default every 16th commit) and reported as the
``stream.dirty_fp_rate`` gauge.

:class:`StreamIngestor` ties the legs together: it consumes
:class:`~neutronstarlite_torch.stream.log.DeltaLog` entries in order,
applies each through serve/delta.py (margin-aware, with the configured
dirty closure), VERIFIES the entry's recorded digest against the applied
graph, accumulates the dirty region for the fine-tune worker, and emits
one typed ``delta_commit`` record per entry. Everything but
:func:`reserve_feature_margin` is the reference's code.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.serve import delta as delta_mod
from neutronstarlite_torch.stream.log import LogEntry, read_log_entries
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("stream")

DEFAULT_MARGIN = 0
DEFAULT_BUCKETS = 1024
DEFAULT_AUDIT_EVERY = 16


def margin_from_env() -> int:
    raw = os.environ.get("NTS_STREAM_VERTEX_MARGIN", "")
    if raw:
        try:
            return max(int(raw), 0)
        except ValueError:
            log.warning(
                "NTS_STREAM_VERTEX_MARGIN=%r is not an int; margin disabled",
                raw,
            )
    return DEFAULT_MARGIN


def dirty_mode_from_env() -> str:
    mode = os.environ.get("NTS_STREAM_DIRTY", "exact").strip() or "exact"
    if mode not in ("exact", "bitset"):
        raise ValueError(
            f"NTS_STREAM_DIRTY={mode!r}: known modes are 'exact' and "
            "'bitset'"
        )
    return mode


def reserve_feature_margin(engines: Sequence, margin: int) -> int:
    """Pre-size the engines' shared feature slab (and any device
    neighbour table) with ``margin`` slack rows. Runs before ``warmup()``:
    a bucket captures the slab it sees, and only a slab that is already
    padded gives appends room to land without a new one. Engines cloned
    from one template share the slab — it is padded once and re-pointed
    everywhere; buckets captured before this point are dropped (loudly)
    and capture again. Returns the new physical row capacity."""
    import torch

    if margin <= 0:
        return int(engines[0].feature.shape[0])
    base = engines[0]
    feat = base.feature
    padded = torch.cat([feat, feat.new_zeros((int(margin), int(feat.shape[1])))])
    toolkits = {}
    ladders = set()
    for eng in engines:
        eng.feature = padded
        # lets apply_to_engines tell "armed margin, fully consumed"
        # apart from "never armed" once the slack runs out (the loud
        # overflow warning hangs off this)
        eng.margin_armed = True
        toolkits[id(eng.toolkit)] = eng.toolkit
        hop = getattr(eng.sampler, "hop_sampler", None)
        if hop is not None and hop.margin < margin:
            hop.reserve_capacity(margin)
        if id(eng._compiled) not in ladders:
            ladders.add(id(eng._compiled))
            n = len(eng._compiled) + len(eng._fused_compiled)
            if n:
                log.warning(
                    "stream ingest: the margin was reserved after %d bucket(s) were "
                    "captured over the unpadded slab; dropping them (reserve before "
                    "warmup)", n,
                )
            eng._compiled.clear()
            eng._fused_compiled.clear()
    for tk in toolkits.values():
        # the fine-tune worker's train step reads toolkit.feature
        tk.feature = padded
    log.info(
        "stream ingest: reserved a %d-row vertex-capacity margin "
        "(feature slab %s -> %s); the bucket ladder captured after this "
        "point survives every in-margin append",
        margin, tuple(feat.shape), tuple(padded.shape),
    )
    return int(padded.shape[0])


class BitsetDirtyTracker:
    """Bucket-granular approximate out-closure (superset of exact)."""

    def __init__(self, graph: CSCGraph, buckets: int = DEFAULT_BUCKETS):
        self.B = max(int(buckets), 1)
        self.adj = np.zeros((self.B, self.B), dtype=bool)
        self._ingest_edges(
            graph.row_indices.astype(np.int64),
            graph.dst_of_edge.astype(np.int64),
        )
        self.fp_rate = 0.0

    def _bucket(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v, dtype=np.int64) % self.B

    def _ingest_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        if len(src):
            self.adj[self._bucket(src), self._bucket(dst)] = True

    def observe_delta(self, delta) -> None:
        """Fold a delta's ADDED edges into the bucket adjacency.
        Removed edges leave their bits set — stale bits only ever widen
        the closure (the superset stays sound, monotonically)."""
        self._ingest_edges(delta.add_src, delta.add_dst)

    def rebuild(self, graph: CSCGraph) -> None:
        """Drop accumulated stale bits by re-summarizing the live edge
        set (call on whatever cadence the measured fp rate motivates)."""
        self.adj[:] = False
        self._ingest_edges(
            graph.row_indices.astype(np.int64),
            graph.dst_of_edge.astype(np.int64),
        )

    def closure(self, old_graph: CSCGraph, new_graph: CSCGraph,
                changed_src: np.ndarray, changed_dst: np.ndarray,
                hops: int) -> np.ndarray:
        """The ``dirty_closure`` hook for serve/delta.plan_delta: the
        exact seed rule lifted to buckets, closed over the bucket
        adjacency, then expanded back to every vertex in a dirty
        bucket."""
        mask = np.zeros(self.B, dtype=bool)
        mask[self._bucket(changed_dst)] = True
        src_mask = np.zeros(self.B, dtype=bool)
        src_mask[self._bucket(changed_src)] = True
        # seed rule: changed destinations + out-neighbors of changed
        # sources — one bucket hop from the changed-source buckets
        mask |= self.adj[src_mask].any(axis=0)
        frontier = mask.copy()
        for _ in range(max(int(hops) - 1, 0)):
            nxt = self.adj[frontier].any(axis=0)
            fresh = nxt & ~mask
            if not fresh.any():
                break
            mask |= fresh
            frontier = fresh
        verts = np.arange(new_graph.v_num, dtype=np.int64)
        return verts[mask[verts % self.B]]


class StreamIngestor:
    """Ordered, digest-verified log consumption into a serving fleet.

    One ingestor per process; hand it the engines (and any servers whose
    caches must follow) plus the log root. :meth:`arm` reserves the
    capacity margin (before warmup); :meth:`consume` applies every
    committed entry past the current position; :meth:`take_dirty` hands
    the accumulated dirty region to the fine-tune worker and resets it.
    """

    def __init__(
        self,
        engines: Sequence,
        servers: Sequence = (),
        *,
        log_root: Optional[str] = None,
        margin: Optional[int] = None,
        dirty_mode: Optional[str] = None,
        buckets: Optional[int] = None,
        audit_every: Optional[int] = None,
        metrics=None,
    ):
        if not engines:
            raise ValueError("StreamIngestor needs at least one engine")
        self.engines = list(engines)
        self.servers = list(servers)
        self.log_root = log_root
        self.margin = margin_from_env() if margin is None else int(margin)
        self.dirty_mode = (dirty_mode_from_env() if dirty_mode is None
                           else str(dirty_mode))
        if self.dirty_mode not in ("exact", "bitset"):
            raise ValueError(
                f"dirty_mode {self.dirty_mode!r}: known modes are 'exact' "
                "and 'bitset'"
            )
        self.metrics = metrics if metrics is not None \
            else self.engines[0].metrics
        self.applied_seq = 0
        self._lock = threading.Lock()
        self._dirty: np.ndarray = np.empty(0, np.int64)
        self._dirty_from_seq = 1
        self.tracker: Optional[BitsetDirtyTracker] = None
        if self.dirty_mode == "bitset":
            nb = int(buckets) if buckets is not None else int(
                os.environ.get("NTS_STREAM_DIRTY_BUCKETS", DEFAULT_BUCKETS)
            )
            self.tracker = BitsetDirtyTracker(
                self.engines[0].sampler.graph, buckets=nb
            )
        self.audit_every = int(audit_every) if audit_every is not None \
            else int(os.environ.get("NTS_STREAM_DIRTY_AUDIT",
                                    DEFAULT_AUDIT_EVERY))
        self._applied_count = 0

    @property
    def head_seq(self) -> int:
        """Last sequence point applied to the engines."""
        return self.applied_seq

    def arm(self) -> None:
        """Reserve the vertex-capacity margin (call BEFORE warmup)."""
        if self.margin > 0:
            reserve_feature_margin(self.engines, self.margin)

    # ---- application -----------------------------------------------------

    def _dirty_closure_hook(self):
        if self.tracker is None:
            return None
        return self.tracker.closure

    def apply(self, entry: LogEntry) -> "delta_mod.DeltaPlan":
        """Apply one committed entry in order; verifies the recorded
        digest against the post-apply graph and accumulates the dirty
        region."""
        with self._lock:
            if entry.seq != self.applied_seq + 1:
                raise ValueError(
                    f"stream ingest: entry seq {entry.seq} does not follow "
                    f"applied head {self.applied_seq} — replay the log from "
                    f"seq {self.applied_seq} instead"
                )
            t0 = time.perf_counter()
            if self.tracker is not None:
                self.tracker.observe_delta(entry.delta)
            hook = self._dirty_closure_hook()
            base = self.engines[0]
            plan = delta_mod.plan_delta(
                base.sampler.graph, entry.delta, hops=len(base.fanouts),
                dirty_closure=hook,
            )
            if plan.digest != entry.digest:
                raise ValueError(
                    f"stream ingest: applying seq {entry.seq} produced "
                    f"digest {plan.digest[:12]}..., but the log recorded "
                    f"{entry.digest[:12]}... — this replica diverged from "
                    "the committed history"
                )
            fp_rate = None
            if self.tracker is not None and self.audit_every > 0 \
                    and (self._applied_count % self.audit_every) == 0:
                exact = delta_mod.plan_delta(
                    base.sampler.graph, entry.delta, hops=len(base.fanouts),
                )
                n_exact, n_approx = len(exact.dirty), len(plan.dirty)
                missing = np.setdiff1d(exact.dirty, plan.dirty)
                if len(missing):
                    raise AssertionError(
                        f"bitset dirty closure missed {len(missing)} "
                        "exact-dirty vertices — the superset invariant is "
                        "broken"
                    )
                fp_rate = (n_approx - n_exact) / max(n_approx, 1)
                self.tracker.fp_rate = fp_rate
                if self.metrics is not None:
                    self.metrics.gauge_set("stream.dirty_fp_rate",
                                           round(fp_rate, 6))
            if self.servers:
                delta_mod.apply_to_servers(
                    self.servers, entry.delta,
                    extra_engines=self.engines, plan=plan,
                )
            else:
                delta_mod.apply_to_engines(self.engines, entry.delta,
                                           plan=plan)
            self.applied_seq = entry.seq
            self._applied_count += 1
            self._dirty = np.union1d(self._dirty, plan.dirty)
            seconds = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.counter_add("stream.entries_applied")
                self.metrics.gauge_set("stream.head_seq", entry.seq)
                fields = dict(
                    seq=entry.seq, writer=entry.writer,
                    writer_seq=entry.writer_seq,
                    added_edges=plan.added_edges,
                    removed_edges=plan.removed_edges,
                    added_vertices=plan.added_vertices,
                    graph_digest=plan.digest,
                    dirty=int(len(plan.dirty)),
                    dirty_mode=self.dirty_mode,
                    seconds=float(seconds),
                )
                if fp_rate is not None:
                    fields["fp_rate"] = float(round(fp_rate, 6))
                self.metrics.event("delta_commit", **fields)
            return plan

    def consume(self, log_root: Optional[str] = None) -> List[LogEntry]:
        """Apply every committed entry past the current position from
        the log directory; returns the entries applied."""
        root = log_root or self.log_root
        if root is None:
            raise ValueError("StreamIngestor has no log_root to consume")
        entries = read_log_entries(root, after_seq=self.applied_seq)
        for e in entries:
            self.apply(e)
        return entries

    # ---- the fine-tune worker's feed -------------------------------------

    def take_dirty(self) -> Tuple[np.ndarray, int, int]:
        """Hand over (dirty vertices, first seq, last seq) accumulated
        since the previous take, and reset the accumulator."""
        with self._lock:
            dirty = self._dirty
            lo, hi = self._dirty_from_seq, self.applied_seq
            self._dirty = np.empty(0, np.int64)
            self._dirty_from_seq = self.applied_seq + 1
            return dirty, lo, hi
