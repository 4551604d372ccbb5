"""Per-layer metric readers, one file each, found by the metric's name.

Each module defines ``read(rec) -> float | None``. ``rec`` is the run's
record: ``spans`` (host seconds of the set-up steps), ``epochs`` and
``epoch_ms`` (the measured window), ``dispatch_s`` (host seconds of each
window epoch's ``train_step()`` call), ``counters`` (the program's
counters, their rise over the window), ``counts`` (the least times from
``counts/``, ms per epoch: ``least_ms`` and one per kind of term) and
``trace`` (``profile_window.record``'s result, with its ``epochs``; None
without one). A reader that finds nothing to read returns None, and the
metric is left out of the result line."""

from __future__ import annotations

HAND_WRITTEN = ("ell_work_kernel", "ell_split_reduce", "bsp_ell_kernel", "cast_kernel")
GEMM = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas", "splitk", "dot_kernel")


def device_s(rec, match) -> float:
    """Seconds of device kernels whose name passes ``match``, per traced epoch."""
    tr = rec.get("trace")
    if not tr or not tr.get("epochs"):
        return 0.0
    return sum(d for name, _, d, cat in tr["device"]
               if cat == "kernel" and match(name)) / tr["epochs"]


def is_hand_written(name: str) -> bool:
    return any(k in name for k in HAND_WRITTEN)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in GEMM)
