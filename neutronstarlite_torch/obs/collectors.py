"""Collectors: device memory, compile-vs-steady-state attribution, phases —
port of ``neutronstarlite_tpu/obs/collectors.py``.

Each collector returns plain JSON-serializable dicts for the run_summary
record, under the reference's keys. ``steady_state_stats`` and
``phase_snapshot`` are copied. ``device_memory_stats`` reads the CUDA
caching allocator (``torch.cuda.memory_allocated`` /
``max_memory_allocated`` / ``mem_get_info``) where the reference reads
``device.memory_stats()``; a CPU run reports explicit nulls.
``compile_cache_info`` reports the port's kernel build directory
(``ops/_build.py``) and, per kernel, whether this process built its
library or loaded one already built.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The card's allocator accounting: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``) and
    ``bytes_limit`` (the card's total memory); explicit nulls on the CPU,
    so the run_summary schema is the same on both."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return {
            "available": False,
            "bytes_in_use": None,
            "peak_bytes_in_use": None,
            "devices": [],
        }
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    _, total = torch.cuda.mem_get_info(idx)
    entry = {
        "device": f"cuda:{idx}",
        "bytes_in_use": int(torch.cuda.memory_allocated(idx)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(idx)),
        "bytes_limit": int(total),
    }
    return {
        "available": True,
        "bytes_in_use": entry["bytes_in_use"],
        "peak_bytes_in_use": entry["peak_bytes_in_use"],
        "devices": [entry],
    }


def steady_state_stats(epoch_times: Sequence[float]) -> Dict[str, Any]:
    """First-step vs warm attribution: the first epoch carries the kernel
    build and the allocator's warm-up, the rest are steady state."""
    times = [float(t) for t in epoch_times]
    out: Dict[str, Any] = {
        "epochs": len(times),
        "first_s": times[0] if times else None,
        "warm_median_s": None,
        "warm_mean_s": None,
        "compile_overhead_s": None,
        "first_to_warm_ratio": None,
    }
    if len(times) >= 2:
        warm = sorted(times[1:])
        n = len(warm)
        med = (
            warm[n // 2] if n % 2 else 0.5 * (warm[n // 2 - 1] + warm[n // 2])
        )
        out["warm_median_s"] = med
        out["warm_mean_s"] = sum(warm) / n
        out["compile_overhead_s"] = max(times[0] - med, 0.0)
        if med > 0:
            out["first_to_warm_ratio"] = times[0] / med
    return out


def compile_cache_info() -> Dict[str, Any]:
    """The kernel build cache: ``persistent_cache_dir`` is the directory the
    CUDA kernels' libraries live in, ``enabled`` whether it holds one, and
    ``kernels`` maps each kernel this process loaded to ``built`` (nvcc ran
    in this process) or ``loaded`` (an up-to-date library was reused)."""
    from neutronstarlite_torch.ops import _build

    kernels: Dict[str, str] = dict(sorted(_build.origins.items()))
    have: List[str] = []
    if os.path.isdir(_build.BUILD_DIR):
        have = [n for n in _build.KERNELS
                if os.path.exists(os.path.join(_build.BUILD_DIR, f"lib{n}.so"))]
    return {"persistent_cache_dir": _build.BUILD_DIR, "enabled": bool(have),
            "kernels": kernels}


def phase_snapshot(timers) -> Dict[str, Dict[str, float]]:
    """PhaseTimers -> {name: {total_s, count}} (the DEBUGINFO host
    buckets as data instead of a printed report)."""
    if timers is None:
        return {}
    return timers.snapshot()
