"""Profiler traces and named annotations — port of
``neutronstarlite_tpu/utils/profiling.py``.

``maybe_trace(label)`` records the enclosed region with ``torch.profiler``
(host and, on a CUDA device, the card's kernels) when ``NTS_PROFILE_DIR``
is set, and writes it as a Chrome trace under ``NTS_PROFILE_DIR/<label>/``.
While any torch profiler records in this process (``maybe_trace``'s, a
benchmark's, an operator's own), ``annotate(name)`` is a
``torch.profiler.record_function`` scope, so the tracer's live spans and the
step's ``nts.*`` scopes land inside the trace under their own names, on the
clock of the device's kernels; otherwise it is a shared no-op, and opens no
profiler scope at all.
"""

from __future__ import annotations

import itertools
import os
from contextlib import contextmanager, nullcontext
from typing import Iterator, Optional

import torch.autograd.profiler as _autograd_profiler

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("profiling")

_trace_seq = itertools.count()  # one file name per trace of this process
_NO_SCOPE = nullcontext()


def profile_dir() -> Optional[str]:
    return os.environ.get("NTS_PROFILE_DIR") or None


def recording() -> bool:
    """True while a torch profiler records in this process, whoever opened it."""
    return _autograd_profiler._is_profiler_enabled


@contextmanager
def maybe_trace(label: str = "nts", device=None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the enclosed region when
    ``NTS_PROFILE_DIR`` is set (CUDA activity too when ``device`` is a CUDA
    device); no-op otherwise. The Chrome trace is written when the region
    ends normally."""
    d = profile_dir()
    if not d:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(d, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = os.path.join(path, f"trace-{os.getpid()}-{next(_trace_seq)}.json")
    try:
        prof.export_chrome_trace(out)
        log.info("profiler trace: %s", out)
    except OSError as e:  # the trace is telemetry: a failed write warns
        log.warning("could not write the profiler trace %s (%s)", out, e)


def annotate(name: str):
    """A named profiler scope while a profiler records, else a shared no-op
    (a ``record_function`` costs ~10 us even with no profiler running)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SCOPE
    return _autograd_profiler.record_function(name)
