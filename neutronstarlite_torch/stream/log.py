"""Multi-writer, sequence-numbered, append-only GraphDelta log.

Copy of ``neutronstarlite_tpu/stream/log.py``, equal to it apart from this
note, the import paths and ``_apply_delta``'s removal mask, which is
serve/delta.py's ``_removal_mask`` in place of two ``np.isin`` calls
(tests/test_torch_obs.py holds the rest equal): the two packages write
byte-identical logs for the same staged deltas, and each reads the
other's.

A delta applied straight to the servers
(:class:`~neutronstarlite_torch.serve.delta.GraphDelta`) is single-writer
and unlogged: the history is gone. A streaming fleet needs the
opposite — many writers producing deltas concurrently, one total order
every replica agrees on, and a durable record a late-joining replica can
replay. This module is that record.

Merge semantics (the determinism contract)
------------------------------------------

Writers stage deltas into per-writer :class:`WriterSession`\\ s; nothing
is ordered at stage time. :meth:`DeltaLog.commit` is the ordering point:
every staged delta across all sessions is collected and sorted by the
CANONICAL key ``(writer_id, writer_seq)`` — NOT arrival order — then
assigned consecutive global sequence numbers and applied, one by one, to
the log's head graph. Because the key depends only on who wrote what
(not on thread scheduling), two arbitrarily interleaved stage orders of
the same sessions commit to the SAME total order, the same per-seq
graphs, and therefore the same digest sequence — the multi-writer
extension of the single-delta bitwise oracle, pinned by
tests/test_stream_log.py.

Every committed entry records the canonical ``graph_digest``
(graph/digest.py) of the head graph AT that sequence point. Any replica
that has applied the log through seq N holds a graph bitwise-identical
to a fresh ``build_graph`` over the post-delta edge list at seq N; the
digest is the proof carried in-band, and consumers verify it on apply
(stream/ingest.py).

Commit is atomic at the batch level: every staged delta is validated and
applied to a SCRATCH head first (an invalid delta — e.g. removing an
edge that does not exist under the canonical order — aborts the whole
commit with nothing written and nothing staged lost), and only then do
the entries reach disk.

On-disk format
--------------

A log directory holds::

    meta.json                    # schema, base digest, base v_num
    tail.jsonl                   # the live append file, one entry/line
    seg-00000001-00000042.jsonl  # sealed segments (seq lo..hi), immutable

Entries append to ``tail.jsonl`` (fsync'd per commit). :meth:`seal`
compacts the tail into an immutable segment published via the tmp +
``os.replace`` idiom — a reader never observes a half-written segment.
A writer killed MID tail append (the ``writer_crash`` chaos kind fires
at the ``delta_commit`` fault point planted between the two halves of
the entry's line) leaves a torn final line; recovery drops it LOUDLY and
keeps the committed prefix — tests kill a real subprocess to pin this.
A crash between segment publication and tail truncation can leave the
same seq in both files; readers dedup by seq, first occurrence wins.

Feature rows for appended vertices ride in the entry as nested float
lists: float32 -> Python float -> JSON -> float32 is exact (float64 is
a superset of float32 and JSON round-trips float64), so the digest /
bitwise guarantees survive serialization.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import CSCGraph, build_graph
from neutronstarlite_torch.resilience.faults import fault_point
from neutronstarlite_torch.serve.delta import GraphDelta
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("stream")

SCHEMA_VERSION = 1
META_NAME = "meta.json"
TAIL_NAME = "tail.jsonl"
SEG_PREFIX = "seg-"


@dataclasses.dataclass
class LogEntry:
    """One committed delta at its sequence point."""

    seq: int  # global total-order position (1-based)
    writer: str  # the committing WriterSession's id
    writer_seq: int  # position within that writer's session
    digest: str  # canonical head-graph digest AFTER applying this delta
    delta: GraphDelta

    def to_json(self) -> str:
        d = self.delta
        obj = {
            "seq": self.seq,
            "writer": self.writer,
            "writer_seq": self.writer_seq,
            "digest": self.digest,
            "add": [[int(s), int(t)]
                    for s, t in zip(d.add_src, d.add_dst)],
            "remove": [[int(s), int(t)]
                       for s, t in zip(d.remove_src, d.remove_dst)],
            "add_vertices": int(d.add_vertices),
        }
        if d.add_features is not None:
            rows = np.asarray(d.add_features)
            obj["add_features"] = [[float(x) for x in row] for row in rows]
            obj["feature_dtype"] = str(rows.dtype)
        return json.dumps(obj, separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "LogEntry":
        obj = json.loads(line)
        feats = None
        if obj.get("add_features") is not None:
            feats = np.asarray(
                obj["add_features"],
                dtype=np.dtype(obj.get("feature_dtype", "float32")),
            )
        delta = GraphDelta.edges(
            add=[tuple(e) for e in obj.get("add", [])],
            remove=[tuple(e) for e in obj.get("remove", [])],
            add_vertices=int(obj.get("add_vertices", 0)),
            add_features=feats,
        )
        return cls(
            seq=int(obj["seq"]), writer=str(obj["writer"]),
            writer_seq=int(obj["writer_seq"]), digest=str(obj["digest"]),
            delta=delta,
        )


class WriterSession:
    """One writer's staging buffer; deltas carry (writer_id, writer_seq)
    — the canonical merge key — from the moment they are staged."""

    def __init__(self, log_: "DeltaLog", writer_id: str):
        self._log = log_
        self.writer_id = writer_id
        self.staged: List[Tuple[int, GraphDelta]] = []
        self._next_writer_seq = 1

    def stage(self, delta: GraphDelta) -> int:
        """Buffer a delta; returns its writer_seq. Thread-safe with other
        sessions (the log lock serializes), ordering-irrelevant with them
        (commit orders canonically, not by arrival)."""
        if delta.empty:
            raise ValueError("refusing to stage an empty GraphDelta")
        with self._log._lock:
            wseq = self._next_writer_seq
            self._next_writer_seq += 1
            self.staged.append((wseq, delta))
        return wseq


def _parse_lines(path: str, *, source: str) -> Tuple[List[LogEntry], int]:
    """Parse a jsonl file into entries; a torn final line (no trailing
    newline, or JSON that does not parse) is dropped LOUDLY with
    everything after it. Returns (entries, dropped_line_count)."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as fh:
        raw = fh.read()
    entries: List[LogEntry] = []
    lines = raw.split(b"\n")
    # a file ending in "\n" splits into [..., b""]; anything else means
    # the final line never finished (the torn tail)
    complete, leftover = lines[:-1], lines[-1]
    dropped = 1 if leftover else 0
    for i, line in enumerate(complete):
        if not line.strip():
            continue
        try:
            entries.append(LogEntry.from_json(line.decode("utf-8")))
        except (ValueError, KeyError, UnicodeDecodeError):
            dropped += len(complete) - i
            break
    if dropped:
        log.warning(
            "stream log %s: dropped %d torn/unparseable trailing line(s) "
            "— a writer died mid-commit; the committed prefix is intact",
            source, dropped,
        )
    return entries, dropped


def _segments(root: str) -> List[str]:
    names = [n for n in os.listdir(root)
             if n.startswith(SEG_PREFIX) and n.endswith(".jsonl")]
    return [os.path.join(root, n) for n in sorted(names)]


def read_log_entries(root: str, after_seq: int = 0) -> List[LogEntry]:
    """Read committed entries with seq > ``after_seq`` from a log
    directory (sealed segments first, then the live tail), deduped by
    seq. The lightweight consumer path: tailing replicas and the
    fine-tune worker poll this without holding a graph."""
    entries: List[LogEntry] = []
    seen: Dict[int, bool] = {}
    for path in _segments(root) + [os.path.join(root, TAIL_NAME)]:
        parsed, _ = _parse_lines(path, source=path)
        for e in parsed:
            if e.seq in seen:
                continue
            seen[e.seq] = True
            if e.seq > after_seq:
                entries.append(e)
    entries.sort(key=lambda e: e.seq)
    return entries


class DeltaLog:
    """The ordered, durable, multi-writer GraphDelta log.

    ``DeltaLog(root, graph)`` opens-or-creates the log at ``root`` over
    the base ``graph`` (whose digest must match a pre-existing log's
    recorded base). Existing entries are replayed over the base to
    rebuild the head graph, verifying the recorded digest chain — an
    entry whose recomputed digest disagrees with its recorded one fails
    the open (corruption must not propagate silently).
    """

    def __init__(self, root: str, graph: CSCGraph, *, verify: bool = True):
        self.root = root
        self._lock = threading.RLock()
        self._sessions: Dict[str, WriterSession] = {}
        os.makedirs(root, exist_ok=True)
        base_digest = graph_digest(graph)
        meta_path = os.path.join(root, META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("base_digest") != base_digest:
                raise ValueError(
                    f"stream log {root} was recorded over base digest "
                    f"{meta.get('base_digest', '?')[:12]}..., but the "
                    f"supplied graph digests {base_digest[:12]}... — "
                    "wrong base graph"
                )
        else:
            meta = {
                "schema": SCHEMA_VERSION,
                "base_digest": base_digest,
                "base_v_num": int(graph.v_num),
            }
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            os.replace(tmp, meta_path)
        self.base_digest = base_digest
        self.head_graph = graph
        self.head_digest = base_digest
        self.head_seq = 0
        self.head_features: Optional[np.ndarray] = None
        self.recovered_dropped = 0
        self._recover(verify=verify)

    # ---- open/recovery ---------------------------------------------------

    def _recover(self, verify: bool) -> None:
        entries = read_log_entries(self.root, after_seq=0)
        # count what recovery threw away (the torn-tail telemetry)
        _, dropped = _parse_lines(
            os.path.join(self.root, TAIL_NAME), source="tail"
        )
        self.recovered_dropped = dropped
        for e in entries:
            if e.seq != self.head_seq + 1:
                raise ValueError(
                    f"stream log {self.root}: sequence gap — entry seq "
                    f"{e.seq} follows head {self.head_seq}"
                )
            g2 = _apply_delta(self.head_graph, e.delta)
            if verify:
                d = graph_digest(g2)
                if d != e.digest:
                    raise ValueError(
                        f"stream log {self.root}: digest chain broken at "
                        f"seq {e.seq}: recorded {e.digest[:12]}..., "
                        f"recomputed {d[:12]}..."
                    )
            self.head_graph = g2
            self.head_digest = e.digest
            self.head_seq = e.seq
        if entries:
            log.info(
                "stream log %s: replayed %d entries to seq %d (digest %s)",
                self.root, len(entries), self.head_seq,
                self.head_digest[:12],
            )
        if dropped:
            # rewrite the tail without the torn line(s): the damage is
            # acknowledged once, not re-warned on every future open
            tail_entries, _ = _parse_lines(
                os.path.join(self.root, TAIL_NAME), source="tail"
            )
            self._rewrite_tail(tail_entries)

    def _rewrite_tail(self, entries: List[LogEntry]) -> None:
        tail = os.path.join(self.root, TAIL_NAME)
        tmp = tail + ".tmp"
        with open(tmp, "w") as fh:
            for e in entries:
                fh.write(e.to_json() + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, tail)

    # ---- writing ---------------------------------------------------------

    def writer(self, writer_id: str) -> WriterSession:
        """The (one) staging session for ``writer_id``."""
        with self._lock:
            sess = self._sessions.get(writer_id)
            if sess is None:
                sess = WriterSession(self, writer_id)
                self._sessions[writer_id] = sess
            return sess

    def commit(self) -> List[LogEntry]:
        """The ordering point: collect every staged delta across all
        sessions, order canonically by (writer_id, writer_seq), assign
        consecutive global seqs, apply to the head, record digests, and
        append durably. Atomic: an invalid delta aborts the whole batch
        with nothing written and nothing staged lost."""
        with self._lock:
            pending: List[Tuple[str, int, GraphDelta]] = []
            for wid in sorted(self._sessions):
                for wseq, d in self._sessions[wid].staged:
                    pending.append((wid, wseq, d))
            if not pending:
                return []
            pending.sort(key=lambda t: (t[0], t[1]))

            # validate + apply on a scratch head first (atomicity): only
            # a fully-valid batch reaches disk or the real head
            scratch = self.head_graph
            entries: List[LogEntry] = []
            seq = self.head_seq
            for wid, wseq, d in pending:
                seq += 1
                scratch = _apply_delta(scratch, d)
                entries.append(LogEntry(
                    seq=seq, writer=wid, writer_seq=wseq,
                    digest=graph_digest(scratch), delta=d,
                ))

            tail = os.path.join(self.root, TAIL_NAME)
            with open(tail, "ab") as fh:
                for e in entries:
                    line = (e.to_json() + "\n").encode("utf-8")
                    half = len(line) // 2
                    fh.write(line[:half])
                    fh.flush()
                    os.fsync(fh.fileno())
                    # the torn-tail chaos plant: writer_crash@seq=k dies
                    # HERE, with half of seq k's line durably on disk —
                    # recovery must drop exactly that half-line
                    fault_point("delta_commit", seq=e.seq)
                    fh.write(line[half:])
                fh.flush()
                os.fsync(fh.fileno())

            for sess in self._sessions.values():
                sess.staged.clear()
            self.head_graph = scratch
            self.head_digest = entries[-1].digest
            self.head_seq = entries[-1].seq
            log.info(
                "stream log commit: %d entries, head seq %d (digest %s)",
                len(entries), self.head_seq, self.head_digest[:12],
            )
            return entries

    def seal(self) -> Optional[str]:
        """Compact the live tail into an immutable segment file,
        published atomically (tmp + ``os.replace``); returns the segment
        path, or None when the tail is empty. A crash between segment
        publication and tail truncation duplicates entries across the
        two files — readers dedup by seq."""
        with self._lock:
            tail = os.path.join(self.root, TAIL_NAME)
            entries, _ = _parse_lines(tail, source="tail")
            if not entries:
                return None
            lo, hi = entries[0].seq, entries[-1].seq
            seg = os.path.join(self.root, f"{SEG_PREFIX}{lo:08d}-{hi:08d}.jsonl")
            tmp = seg + ".tmp"
            with open(tmp, "w") as fh:
                for e in entries:
                    fh.write(e.to_json() + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, seg)
            self._rewrite_tail([])
            log.info("stream log sealed segment %s (seq %d..%d)",
                     os.path.basename(seg), lo, hi)
            return seg

    # ---- reading ---------------------------------------------------------

    def entries(self, after_seq: int = 0) -> List[LogEntry]:
        """Committed entries with seq > after_seq (replay-from-seq for a
        late-joining replica)."""
        return read_log_entries(self.root, after_seq=after_seq)

    def digest_sequence(self) -> List[str]:
        """The per-seq digest chain [digest@1, ..., digest@head] — the
        determinism oracle's comparison object."""
        return [e.digest for e in self.entries()]

    def iter_graphs(self, base: CSCGraph) -> Iterator[Tuple[int, CSCGraph]]:
        """Replay from ``base``, yielding (seq, graph-at-seq) — the
        fresh-build side of the bitwise oracle."""
        g = base
        for e in self.entries():
            g = _apply_delta(g, e.delta)
            yield e.seq, g


def _apply_delta(graph: CSCGraph, delta: GraphDelta) -> CSCGraph:
    """Apply one delta to a host graph via the deterministic NumPy build
    path — validation (missing removals raise) and edge-list editing
    shared with serve/delta.plan_delta, minus the dirty-set work the log
    does not need."""
    from neutronstarlite_torch.serve import delta as delta_mod

    old_src = graph.row_indices.astype(np.int64)
    old_dst = graph.dst_of_edge.astype(np.int64)
    new_v = graph.v_num + int(delta.add_vertices)
    for name, arr in (("add_src", delta.add_src), ("add_dst", delta.add_dst),
                      ("remove_src", delta.remove_src),
                      ("remove_dst", delta.remove_dst)):
        if len(arr) and (int(arr.min()) < 0 or int(arr.max()) >= new_v):
            raise ValueError(
                f"graph delta {name} references a vertex outside "
                f"0..{new_v - 1}"
            )
    mask = np.ones(len(old_src), dtype=bool)
    if len(delta.remove_src):
        keys = delta_mod._edge_keys(old_src, old_dst)
        rm = np.unique(
            delta_mod._edge_keys(delta.remove_src, delta.remove_dst)
        )
        mask, present = delta_mod._removal_mask(keys, rm)
        if not present.all():
            missing = rm[~present][:5]
            pairs = [(int(k >> 32), int(k & 0xFFFFFFFF)) for k in missing]
            raise ValueError(
                f"graph delta removes edge(s) that do not exist: {pairs}"
            )
    src = np.concatenate([old_src[mask], delta.add_src])
    dst = np.concatenate([old_dst[mask], delta.add_dst])
    return build_graph(
        src.astype(np.uint32), dst.astype(np.uint32), new_v,
        weight="gcn_norm", use_native=False,
    )
