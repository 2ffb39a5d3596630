"""Injectable monotonic clock shared by every obs timer and tracer.

All timing in the repo (``UpdateReport.time_*`` accumulation, trace
span start/end stamps, the live-harness latency histograms) reads the
same process-wide clock through :func:`now`.  Tests swap in a
:class:`ManualClock` via :func:`use_clock` to make every duration and
span timestamp deterministic.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

_clock: Callable[[], float] = time.perf_counter


def now() -> float:
    """Current monotonic time from the active clock (seconds)."""
    return _clock()


def set_clock(fn: Callable[[], float] | None) -> None:
    """Install ``fn`` as the process clock (``None`` restores real time)."""
    global _clock
    _clock = fn if fn is not None else time.perf_counter


@contextmanager
def use_clock(fn: Callable[[], float]):
    """Scoped clock override; always restores the previous clock."""
    global _clock
    prev = _clock
    _clock = fn
    try:
        yield fn
    finally:
        _clock = prev


class ManualClock:
    """Deterministic clock: each read returns the current time, then
    advances by ``tick`` — so a timed block spanning N reads always
    measures exactly ``N * tick`` seconds, independent of wall time."""

    __slots__ = ("t", "tick")

    def __init__(self, start: float = 0.0, tick: float = 1.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t
