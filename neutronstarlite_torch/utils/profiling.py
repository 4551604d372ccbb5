"""Profiler traces and named annotations — port of
``neutronstarlite_tpu/utils/profiling.py``.

``maybe_trace(label)`` records the enclosed region with ``torch.profiler``
(host and, on a CUDA device, the card's kernels) when ``NTS_PROFILE_DIR``
is set, and writes it as a Chrome trace under ``NTS_PROFILE_DIR/<label>/``.
While such a trace records, ``annotate(name)`` is a
``torch.profiler.record_function`` scope, so the tracer's live spans land
inside the device trace under their own names; otherwise it is a no-op, and
a run without ``NTS_PROFILE_DIR`` opens no profiler scope at all.
"""

from __future__ import annotations

import itertools
import os
from contextlib import contextmanager, nullcontext
from typing import Iterator, Optional

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("profiling")

_recording = 0  # maybe_trace regions open in this process
_trace_seq = itertools.count()  # one file name per trace of this process


def profile_dir() -> Optional[str]:
    return os.environ.get("NTS_PROFILE_DIR") or None


def recording() -> bool:
    """True while a ``maybe_trace`` region records."""
    return _recording > 0


@contextmanager
def maybe_trace(label: str = "nts", device=None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the enclosed region when
    ``NTS_PROFILE_DIR`` is set (CUDA activity too when ``device`` is a CUDA
    device); no-op otherwise. The Chrome trace is written when the region
    ends normally."""
    global _recording
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
        _recording += 1
        try:
            yield
        finally:
            _recording -= 1
    out = os.path.join(path, f"trace-{os.getpid()}-{next(_trace_seq)}.json")
    try:
        prof.export_chrome_trace(out)
        log.info("profiler trace: %s", out)
    except OSError as e:  # the trace is telemetry: a failed write warns
        log.warning("could not write the profiler trace %s (%s)", out, e)


def annotate(name: str):
    """A named profiler scope while a trace records, else a no-op."""
    if not _recording:
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)
