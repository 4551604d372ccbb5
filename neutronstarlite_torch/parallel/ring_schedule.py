"""The ring's schedule — port of ``neutronstarlite_tpu/parallel/ring_schedule.py``.

Three facts every participant of the pipelined ring agrees on: who sends
to whom (``ring_perm``), which source partition a rank holds at each step
(``ring_source``) and what dtype rides the wire (``resolve_wire_dtype``).
The backward runs the reverse ring (direction -1). ``trim_transfers``
drops the hops of a skipped suffix. ``payload_quant_probe`` measures what
the narrowed wire does to a payload (``NTS_QUANT_PROBE``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

# cfg WIRE_DTYPE / env NTS_WIRE_DTYPE spellings -> canonical names
_WIRE_DTYPES = {
    "": None,
    "f32": None,
    "float32": None,
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
}


def ring_perm(partitions: int, direction: int = 1) -> List[Tuple[int, int]]:
    """(sender, receiver) pairs of one hop: ``direction=+1`` is the forward
    ring (rank i sends its shard to i-1, so the source partition a rank
    holds advances by one per step); ``-1`` is the reverse ring."""
    if direction not in (1, -1):
        raise ValueError(f"ring direction must be +1 or -1, got {direction}")
    return [(i, (i - direction) % partitions) for i in range(partitions)]


def ring_source(p: int, step: int, partitions: int, direction: int = 1) -> int:
    """The source partition whose shard rank ``p`` holds at ring step
    ``step`` (step 0: its own)."""
    return (p + direction * step) % partitions


def resolve_wire_dtype(cfg_value: str = "") -> Optional[torch.dtype]:
    """The dtype the ring's shards are sent in, or None (the compute dtype
    unchanged). ``NTS_WIRE_DTYPE`` overrides the cfg's ``WIRE_DTYPE``; bf16
    halves the bytes on the wire while the accumulator stays f32.
    ``auto`` is the autotuner's, resolved before the exchange is built."""
    value = os.environ.get("NTS_WIRE_DTYPE", "") or (cfg_value or "")
    value = value.strip().lower()
    if value not in _WIRE_DTYPES:
        raise ValueError(
            f"WIRE_DTYPE must be one of {sorted(k for k in _WIRE_DTYPES if k)}"
            f" (or empty), got {value!r}"
        )
    name = _WIRE_DTYPES[value]
    return getattr(torch, name) if name else None


def payload_quant_probe(wire_dtype: torch.dtype):
    """The probe over a ring payload (``NTS_QUANT_PROBE``): ``probe(x)`` is
    the payload's stats at the wire dtype (``obs/numerics``' group stats,
    device tensors) plus ``quant_rel_err``, the relative RMS error of
    shipping it narrowed instead of f32."""
    from neutronstarlite_torch.obs import numerics

    def probe(x: torch.Tensor):
        st = numerics.group_stats(x.detach().to(wire_dtype))
        st["quant_rel_err"] = numerics.quant_rel_err(x, wire_dtype)
        return st

    return probe


def trim_transfers(work_steps: List[int]) -> int:
    """Hops actually needed: shards travel only as far as the last step
    with work, so a skipped suffix drops its hops (0 when only step 0
    works or nothing does)."""
    return max(work_steps) if work_steps else 0
