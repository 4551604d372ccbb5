"""Streaming graph learning: the live half of the serving story — port of
``neutronstarlite_tpu/stream``.

Three legs:

- :mod:`neutronstarlite_torch.stream.log` — the multi-writer, sequence-
  numbered, append-only GraphDelta log with deterministic merge
  semantics and a canonical graph digest at every sequence point.
- :mod:`neutronstarlite_torch.stream.ingest` — capture-free ingestion:
  a pre-sized vertex-capacity margin so appends write into reserved
  slack instead of dropping the captured bucket ladder, plus the bitset
  approximate dirty-closure for high delta rates.
- :mod:`neutronstarlite_torch.stream.finetune` — the continuous
  fine-tune worker draining the accumulated dirty region between serve
  flushes and publishing checkpoints.
"""

from neutronstarlite_torch.stream.log import (  # noqa: F401
    DeltaLog,
    LogEntry,
    WriterSession,
    read_log_entries,
)
