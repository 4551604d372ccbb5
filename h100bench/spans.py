"""The program's own scopes in a traced window: the ``nts.*`` profiler scopes
the port opens at its layer boundaries (``utils/profiling.annotate`` in the
port), and the device work each of them launched.

The parsed trace (``profile_window.parse``) keeps no correlation ids, so
launches are mapped to device work by order: on one stream the device runs
work in the order the host enqueued it. The window is cut into epochs at
the harness's loss fetch: on the host where its synchronise ends, on the
device after its copy back to the host, each cut on its own clock (the
two drift apart by up to half a millisecond over a window). In an epoch
the host events that enqueue work (``*LaunchKernel*``, ``cudaMemcpy*``,
``cudaMemset*``), sorted by start, pair one to one with the device events,
sorted by start; an epoch whose counts differ (CUPTI drops records) or
whose pairs differ in kind is left out. Each launch belongs to the
innermost ``nts.*`` scope open at its start: the latest-starting one not
yet ended (a scope the autograd engine's thread opens starts later than the
main thread's ``nts.step.backward`` that it runs under). The mapping is
refused (None) when no epoch pairs up, or when it fails its own check:
every ELL kernel lands under ``nts.ell.aggregate``, and no other kernel
does but the output's zero fill.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from h100bench import profile_window

PREFIX = "nts."
STEP = "nts.step."
AGGREGATE = "nts.ell.aggregate"
ELL = ("ell_work_kernel", "ell_split_reduce")
FILL = "FillFunctor"  # torch.zeros' kernel: the aggregate's output when a row has no slot
FETCH = "cudaStreamSynchronize"  # the harness's loss fetch ends in it, once per epoch
COPY_BACK = "Memcpy DtoH"  # ... after its copy back, the epoch's last device event
TOL = 5e-3  # s: a host and a device cut of one fetch lie this close, epochs far wider apart


def launch_kind(name: str) -> Optional[str]:
    """The device event a host call enqueues (its trace category), or None."""
    if "LaunchKernel" in name:
        return "kernel"
    if name.startswith("cudaMemcpy"):
        return "gpu_memcpy"
    if name.startswith("cudaMemset"):
        return "gpu_memset"
    return None


def scopes(trace: dict, prefix: str = PREFIX) -> List[Tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of the host scopes named ``prefix...``, by start."""
    return sorted(((n, t, t + d) for n, t, d in trace["host"] if n.startswith(prefix)),
                  key=lambda s: s[1])


def innermost(spans: List[Tuple[str, float, float]], times: List[float]) -> List[Optional[str]]:
    """For each of the ascending ``times``, the latest-starting span open
    then (start <= t <= end), or None."""
    out: List[Optional[str]] = []
    live: list = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            live.append(spans[i])
            i += 1
        live = [s for s in live if s[2] >= t]
        out.append(live[-1][0] if live else None)
    return out


def is_ell(name: str) -> bool:
    return any(k in name for k in ELL)


def epochs(trace: dict) -> Tuple[List[Tuple[list, list]], int]:
    """(launches, device events) per traced epoch that has both a host and
    a device side, each by start, and the number of epochs that launched
    anything. An epoch whose copy back was lost merges on the device with
    the next and pairs with no host epoch."""
    ends = sorted(t + d for n, t, d in trace["host"] if n == FETCH)
    host: List[list] = [[] for _ in range(len(ends) + 1)]
    for r in sorted((r for r in trace["host"] if launch_kind(r[0])), key=lambda r: r[1]):
        host[bisect.bisect_left(ends, r[1])].append(r)
    device: List[list] = [[]]
    for d in sorted(trace["device"], key=lambda r: r[1]):
        device[-1].append(d)
        if d[0].startswith(COPY_BACK):
            device.append([])
    out, used = [], set()
    for part in device[:-1]:
        end = part[-1][1] + part[-1][2]
        k = min(range(len(ends)), key=lambda i: abs(ends[i] - end), default=None)
        if k is not None and k not in used and abs(ends[k] - end) <= TOL:
            used.add(k)
            out.append((host[k], part))
    out.append((host[-1], device[-1]))  # after the last fetch, on both clocks
    return [(h, d) for h, d in out if h or d], sum(1 for h in host if h)


def attributed(trace: Optional[dict]) -> Optional[Tuple[List[Tuple[Optional[str], list]], float]]:
    """``(scope or None, device event)`` for the device work of every epoch
    that pairs up, in device order, and the share of epochs that did; None
    when none did or the mapping fails its check."""
    if not trace or not trace["device"]:
        return None
    spans_ = scopes(trace)
    parts, n = epochs(trace)
    work: List[Tuple[Optional[str], list]] = []
    whole = 0
    for launches, device in parts:
        if not launches or len(launches) != len(device) or any(
                launch_kind(h[0]) != d[3] for h, d in zip(launches, device)):
            continue
        names = innermost(spans_, [h[1] for h in launches])
        for name, (kernel, _, _, cat) in zip(names, device):
            if cat == "kernel" and is_ell(kernel) != (name == AGGREGATE) and not (
                    name == AGGREGATE and FILL in kernel):
                return None
        work.extend(zip(names, device))
        whole += 1
    return (work, whole / n) if whole else None


def scope_ms(rec: dict, prefix: str) -> Optional[float]:
    """Device ms per traced epoch of the work launched inside scopes named
    ``prefix...``, over the epochs that pair up; None without a trace, a
    mapping or such a scope."""
    tr = rec.get("trace")
    if not tr or not tr.get("epochs") or not scopes(tr, prefix):
        return None
    got = attributed(tr)
    if got is None:
        return None
    work, share = got
    s = sum(d[2] for name, d in work if name is not None and name.startswith(prefix))
    return 1e3 * s / (tr["epochs"] * share)


def idle_gaps(trace: dict) -> List[Tuple[float, float]]:
    """The window's device idle intervals, as ``profile_window.breakdown`` cuts them."""
    gaps, last = [], trace["t0"]
    for a, b in profile_window.busy_intervals(trace):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if trace["t1"] > last:
        gaps.append((last, trace["t1"]))
    return gaps


def step_idle_ms(rec: dict) -> Optional[float]:
    """Device idle ms per traced epoch in gaps that begin while an
    ``nts.step.*`` scope is open: idle the step itself leaves. The gap that
    begins where the loss fetch's copy back ends is the harness's, wherever
    the clocks' drift puts it. None without such scopes."""
    tr = rec.get("trace")
    if not tr or not tr.get("epochs") or not tr["device"]:
        return None
    steps = scopes(tr, STEP)
    if not steps:
        return None
    fetched = {t + d for n, t, d, _ in tr["device"] if n.startswith(COPY_BACK)}
    gaps = [g for g in idle_gaps(tr) if g[0] not in fetched]
    inside = innermost(steps, [a for a, _ in gaps])
    return 1e3 * sum(b - a for (a, b), s in zip(gaps, inside) if s is not None) / tr["epochs"]


def counter_ms(rec: dict, counter: str) -> Optional[float]:
    """A seconds counter's rise over the measured window, in ms per epoch."""
    s = (rec.get("counters") or {}).get(counter)
    if s is None or not rec.get("epochs"):
        return None
    return 1e3 * s / rec["epochs"]
