"""Program cost attribution: one typed ``program_cost`` record per program —
port of ``neutronstarlite_tpu/obs/cost.py``.

The reference reads XLA's own ``cost_analysis()`` off each executable. The
port has no compiler analysis to read, so its numbers are counted
(``source="counted"``) over one real run of the program:

- a train step: ``torch.utils.flop_counter.FlopCounterMode`` over the step
  (the library ops it dispatches), plus the hand-written kernels' own count,
  which FlopCounterMode cannot see; ``memory`` is the rise of
  ``torch.cuda.max_memory_allocated`` over the step on a CUDA device
  (``{"peak_bytes": ...}``), null on the CPU;
- each hand-written aggregation kernel per (tables, width) pair the step
  ran: ``aggregation_cost``, the analytic formula ``chip_smoke.py`` takes
  its bound from (``2*E*f`` operations; ``E*8 + (V+1)*4`` bytes of indices,
  weights and offsets, ``x`` read once and the output written once), so
  the record and the bound are one formula.

The kernels' wrappers report each call through :func:`note_kernel` while a
step is counted (:func:`count_step`); otherwise the note is one ``None``
check. A distributed exchange notes each shard's call with the shard's own
tables (its edges, ``vp`` rows over ``P*vp`` sources), one record per
shard. ``NTS_PROGRAM_COST`` is three-state as in the reference: ``0``
never, ``1`` always, unset = only when the telemetry persists (a JSONL sink
or an armed ledger). Counting never hides a failing step: an error in the
counted step raises as it would without the count; a record that cannot
be written warns.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")


def cost_enabled(metrics=None) -> bool:
    """Three-state ``NTS_PROGRAM_COST``: ``0`` = never, ``1`` = always,
    unset = capture only when the telemetry is persisted (the registry has
    a JSONL sink, or ``NTS_LEDGER_DIR`` is armed)."""
    raw = os.environ.get("NTS_PROGRAM_COST", "")
    if raw == "0":
        return False
    if raw == "1":
        return True
    if metrics is not None and getattr(metrics, "path", None):
        return True
    return bool(os.environ.get("NTS_LEDGER_DIR"))


def aggregation_cost(e_num: int, v_num: int, f: int, elem_bytes: int,
                     n_src: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of one weighted aggregation of ``e_num`` edges
    into ``v_num`` rows at width ``f``: 2*E*f float32 operations; E int32
    indices and f32 weights, V+1 int32 offsets, x read once (``n_src``
    rows: ``v_num`` unless the tables are rectangular, as a distributed
    shard's are) and the output written once (padding is a cost of a
    layout, so it is not counted)."""
    n_src = v_num if n_src is None else n_src
    flops = 2.0 * e_num * f
    moved = e_num * 8 + (v_num + 1) * 4 + (n_src + v_num) * f * elem_bytes
    return flops, float(moved)


# ---- kernel calls of a counted step ----------------------------------------

# (shard, edges, rows, source rows) of a call over one shard's tables
Shard = Tuple[int, int, int, int]
_calls: Optional[List[Tuple[str, str, int, Any, Optional[Shard]]]] = None


def note_kernel(kernel: str, direction: str, x, shard: Optional[Shard] = None) -> None:
    """Called by a hand-written kernel's autograd wrapper for each call: the
    kernel, the tables' direction (fwd/bwd) and its input; recorded only
    while a step is counted. ``shard`` = (shard, edges, rows, source rows)
    when the tables are one shard's, else the call covers the whole graph."""
    if _calls is not None:
        _calls.append((kernel, direction, int(x.shape[1]), x.dtype, shard))


class StepCount:
    """What :func:`count_step` measured: ``flops`` of the library ops,
    ``calls`` the kernels' (kernel, direction, f, dtype, shard) calls in order,
    ``memory_rise`` the allocator's peak rise in bytes (None on the CPU)."""

    def __init__(self) -> None:
        self.flops: Optional[float] = None
        self.calls: List[Tuple[str, str, int, Any, Optional[Shard]]] = []
        self.memory_rise: Optional[int] = None


@contextlib.contextmanager
def count_step(device):
    """Count the enclosed step (one real step of the run: nothing is rerun).
    The step runs as it would without the count; an exception in it
    propagates. On a CUDA device the allocator's peak statistic is reset
    at the step's start (the run's peak is then the peak since)."""
    global _calls
    dev = torch.device(device)
    out = StepCount()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    _calls = out.calls
    try:
        with counter:
            yield out
    finally:
        _calls = None
    out.flops = float(counter.get_total_flops())
    if cuda:
        torch.cuda.synchronize(dev)
        out.memory_rise = int(torch.cuda.max_memory_allocated(dev) - base)


def _emit(metrics, fields: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """One program_cost record into the stream and the run_summary list."""
    try:
        rec = metrics.event("program_cost", **fields)
    except Exception as e:  # the record is telemetry: a failed write warns
        log.warning("program_cost record for %s failed: %s", fields.get("label"), e)
        return None
    record_list = getattr(metrics, "program_costs", None)
    if record_list is not None:
        record_list.append(
            {k: v for k, v in rec.items()
             if k not in ("event", "run_id", "schema", "seq")}
        )
    return rec


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def capture_program_cost(metrics, label: str, count: StepCount, e_num: int, v_num: int,
                         platform: str, **extra: Any) -> List[Dict[str, Any]]:
    """The counted step's record, then one record per distinct kernel call
    (kernel, direction, width, dtype, and the shard for a shard's tables)
    with its calls per step. The step's ``flops`` adds the kernels' count to
    the library ops'; its ``bytes_accessed`` is null (no byte count covers
    the library ops)."""
    recs: List[Dict[str, Any]] = []
    kernels: Dict[Tuple[str, str, int, str, Optional[Shard]], int] = {}
    for kernel, direction, f, dtype, shard in count.calls:
        key = (kernel, direction, f, _dtype_name(dtype), shard)
        kernels[key] = kernels.get(key, 0) + 1
    kernel_flops = 0.0
    kernel_recs = []
    for (kernel, direction, f, dtype, shard), calls in kernels.items():
        elem = torch.empty((), dtype=getattr(torch, dtype)).element_size()
        klabel = f"kernel.{kernel}/{direction}/f{f}/{dtype}"
        edges, rows, n_src = e_num, v_num, v_num
        if shard is not None:
            p, edges, rows, n_src = shard
            klabel += f"/shard{p}"
        flops, moved = aggregation_cost(edges, rows, f, elem, n_src=n_src)
        kernel_flops += flops * calls
        kernel_recs.append({
            "label": klabel, "available": True,
            "source": "counted", "flops": flops, "bytes_accessed": moved,
            "transcendentals": None, "memory": None, "platform": platform,
            "kernel": kernel, "direction": direction, "width": f, "dtype": dtype,
            "calls_per_step": calls, "edges": int(edges), "vertices": int(rows),
            **({"shard": p, "sources": int(n_src)} if shard is not None else {}),
        })
    step = {
        "label": str(label), "available": count.flops is not None,
        "source": "counted",
        "flops": (count.flops + kernel_flops) if count.flops is not None else None,
        "bytes_accessed": None, "transcendentals": None,
        "memory": ({"peak_bytes": count.memory_rise}
                   if count.memory_rise is not None else None),
        "platform": platform, "kernel_flops": kernel_flops,
        "kernel_calls": len(count.calls), **extra,
    }
    for fields in [step] + kernel_recs:
        rec = _emit(metrics, fields)
        if rec is not None:
            recs.append(rec)
    return recs
