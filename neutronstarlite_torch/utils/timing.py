"""Per-phase wall-clock accumulators and the DEBUGINFO-style report — port of
``neutronstarlite_tpu/utils/timing.py``, copied.

``PhaseTimers.phase(name)`` sums the host time of a named phase and, with a
span tracer attached (``obs/trace.Tracer``), emits each interval as one
``span`` record too, so the report and the span timeline are two views of
one measurement. ``report()`` prints the reference's ``#name_time=`` lines.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator


def get_time() -> float:
    """Monotonic seconds (the reference's ``get_time``)."""
    return time.perf_counter()


class Timer:
    """Accumulating timer: ``start(); ...; stop()`` sums elapsed time.
    Nested starts stack, so ``stop()`` closes the innermost one."""

    def __init__(self) -> None:
        self.total = 0.0
        self._starts: list = []
        self.count = 0

    def start(self) -> None:
        self._starts.append(get_time())

    def stop(self) -> float:
        if not self._starts:
            raise RuntimeError("Timer.stop() without a matching start()")
        dt = get_time() - self._starts.pop()
        self.total += dt
        self.count += 1
        return dt

    def reset(self) -> None:
        self.total = 0.0
        self.count = 0
        self._starts.clear()


class PhaseTimers:
    """Named phase accumulators and the DEBUGINFO-style report; every
    ``phase()`` interval is also a ``span`` record when a tracer is
    attached."""

    def __init__(self, tracer=None) -> None:
        self._timers: Dict[str, Timer] = defaultdict(Timer)
        self.tracer = tracer

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t = self._timers[name]
        t.start()
        try:
            if self.tracer is not None:
                with self.tracer.span(name, cat="phase"):
                    yield
            else:
                yield
        finally:
            t.stop()

    def total(self, name: str) -> float:
        return self._timers[name].total

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{name: {total_s, count}}: the run_summary's ``phases``."""
        return {
            name: {"total_s": t.total, "count": t.count}
            for name, t in sorted(self._timers.items())
        }

    def report(self) -> str:
        lines = ["--------------------finish algorithm !"]
        for name, t in sorted(self._timers.items()):
            avg = t.total / max(t.count, 1)
            lines.append(
                f"#{name}_time={t.total * 1000:.3f}(ms) count={t.count} avg={avg * 1000:.3f}(ms)"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        for t in self._timers.values():
            t.reset()
