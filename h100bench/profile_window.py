"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA)
over a few steady epochs, read back from its Chrome trace.

The trace is written to the run's ``TMPDIR``, read and deleted. The
traced window is a ``record_function`` scope around the epochs that ends
after a synchronise; its interval is on the clock of the device events.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

WINDOW = "h100bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCAN = 256  # host events looked back through for the one open at a gap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def record(run_epochs, device) -> Dict:
    """Runs ``run_epochs()`` under the profiler; returns the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            epochs = run_epochs()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            raw = json.load(fh)
    finally:
        os.remove(path)
    out = parse(raw.get("traceEvents", raw) if isinstance(raw, dict) else raw)
    out["epochs"] = epochs
    return out


def parse(events: List[dict]) -> Dict:
    """Device intervals ``[name, start_s, dur_s, cat]`` and host ones
    ``[name, start_s, dur_s]`` inside the window, and the window's bounds."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise ValueError("the trace has no window scope")
    w0 = float(win[0]["ts"]) * 1e-6
    w1 = w0 + float(win[0]["dur"]) * 1e-6
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if t + d < w0 or t > w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append([e["name"], t, d, cat])
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append([e["name"], t, d])
    device.sort(key=lambda r: r[1])
    return {"t0": w0, "t1": w1, "window_s": w1 - w0, "device": device, "host": host}


def busy_intervals(trace: Dict) -> List[Tuple[float, float]]:
    """The union of the device intervals, clipped to the window."""
    out: List[Tuple[float, float]] = []
    for _, t, d, _ in trace["device"]:
        a, b = max(t, trace["t0"]), min(t + d, trace["t1"])
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(trace: Dict) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing when each began (the innermost host event
    open at that moment)."""
    by_op: Dict[str, float] = {}
    for name, _, d, _ in trace["device"]:
        by_op[name] = by_op.get(name, 0.0) + d
    gaps, last = [], trace["t0"]
    for a, b in busy_intervals(trace):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if trace["t1"] > last:
        gaps.append((last, trace["t1"]))
    host = sorted(trace["host"], key=lambda r: r[1])
    starts = [r[1] for r in host]
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        doing = "nothing traced"
        # the latest-starting host event still open at a (nested events
        # start later than the ones that hold them)
        for i in range(bisect.bisect_right(starts, a) - 1, max(-1, bisect.bisect_right(starts, a) - 1 - SCAN), -1):
            name, t, d = host[i]
            if t + d >= a:
                doing = name
                break
        by_host[doing] = by_host.get(doing, 0.0) + (b - a)
    rank = lambda d: sorted(([short(k), v] for k, v in d.items()), key=lambda r: -r[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
