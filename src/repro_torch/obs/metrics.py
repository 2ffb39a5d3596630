"""Metrics registry: named counters.

Metric names are dotted paths (``kernels.mips_topk.launches``).  The
kernel wrappers own process-global launch counters on
:func:`global_registry`; each ``EraRAG`` carries a private registry on
its ``Observability``.  The JAX package's gauges, histograms,
collectors and Prometheus exposition serve ``index_report`` and come
with it in the lifecycle slice.
"""
from __future__ import annotations

from typing import Dict


class Counter:
    """Monotonic counter; per-registry, so concurrently-live stores or
    tests sharing a process cannot bleed into each other."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0

    @property
    def value(self) -> int:
        return self.count


class MetricsRegistry:
    """Get-or-create store of named counters."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def snapshot(self) -> Dict[str, int]:
        """Flat dotted-name view of every counter."""
        return {n: c.count for n, c in self.counters.items()}


# Process-global registry: home of truly process-scoped instruments
# (the kernel launch counters in ``kernels/*/ops``).  Everything
# store/pipeline-scoped lives on a per-``EraRAG`` registry.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
