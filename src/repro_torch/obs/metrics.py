"""Central metrics registry: counters, gauges, fixed-bucket histograms.

Metric names are dotted paths (``store.refreshes``,
``kernels.mips_topk.launches``).  Subsystems either own registry
instruments directly (the kernel launch counters on
:func:`global_registry`) or expose their existing ``stats`` objects
through *collectors* — callables registered under a prefix whose dict
is read live at collection time, so ``RAGPipeline.index_report()`` is a
view over the registry without double-counting or copy-on-write races
against the owning object.

Histograms keep fixed log-spaced bucket counts for the Prometheus
exposition AND the raw samples (bounded at ``MAX_SAMPLES``), so
:meth:`Histogram.percentile` is exactly ``np.percentile`` over
everything observed.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.schema import flatten_numeric

# 100us .. ~209s, doubling: covers a kernel dispatch through a full
# migration without tuning per metric.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(21))
MAX_SAMPLES = 65536


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


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram with exact percentile extraction."""

    __slots__ = ("name", "bounds", "bucket_counts", "count", "sum",
                 "samples", "dropped_samples")

    def __init__(self, name: str,
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.bounds = tuple(sorted(buckets)) if buckets is not None \
            else DEFAULT_BUCKETS
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.samples: List[float] = []
        self.dropped_samples = 0

    def observe(self, x: float) -> None:
        x = float(x)
        # bisect_left: first bound >= x, i.e. the Prometheus ``le``
        # bucket this observation belongs to (last slot is +Inf)
        self.bucket_counts[bisect.bisect_left(self.bounds, x)] += 1
        self.count += 1
        self.sum += x
        if len(self.samples) < MAX_SAMPLES:
            self.samples.append(x)
        else:
            self.dropped_samples += 1

    def percentile(self, q: float) -> float:
        """Exact ``np.percentile`` over the retained raw samples."""
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))


def _sanitize(name: str) -> str:
    return name.replace(".", "_").replace("-", "_").replace("/", "_")


class MetricsRegistry:
    """Get-or-create instrument store + live collectors + declared schema."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        self._declared: set = set()

    # -- instruments -------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    # -- collectors --------------------------------------------------
    def register_collector(self, prefix: str,
                           fn: Callable[[], dict]) -> None:
        """Register (or replace) the live stats source for ``prefix``."""
        self._collectors[prefix] = fn

    def collect(self, prefix: str) -> dict:
        fn = self._collectors.get(prefix)
        return dict(fn()) if fn is not None else {}

    # -- declared schema ---------------------------------------------
    def declare(self, name: str) -> None:
        self._declared.add(name)

    def declare_many(self, names: Iterable[str]) -> None:
        self._declared.update(names)

    @property
    def declared(self) -> frozenset:
        return frozenset(self._declared)

    # -- exposition --------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat dotted-name view: owned instruments + live collectors."""
        out: Dict[str, float] = {}
        for n, c in self.counters.items():
            out[n] = c.count
        for n, g in self.gauges.items():
            out[n] = g.value
        for n, h in self.histograms.items():
            out[f"{n}.count"] = h.count
            out[f"{n}.sum"] = h.sum
        for prefix in self._collectors:
            out.update(flatten_numeric(self.collect(prefix), prefix))
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, histograms,
        then collector leaves surfaced as gauges)."""
        lines: List[str] = []
        for n in sorted(self.counters):
            m = _sanitize(n)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self.counters[n].count}")
        for n in sorted(self.gauges):
            m = _sanitize(n)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {self.gauges[n].value:g}")
        for n in sorted(self.histograms):
            h = self.histograms[n]
            m = _sanitize(n)
            lines.append(f"# TYPE {m} histogram")
            acc = 0
            for bound, c in zip(h.bounds, h.bucket_counts):
                acc += c
                lines.append(f'{m}_bucket{{le="{bound:g}"}} {acc}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{m}_sum {h.sum:g}")
            lines.append(f"{m}_count {h.count}")
        for prefix in sorted(self._collectors):
            flat = flatten_numeric(self.collect(prefix), prefix)
            for k in sorted(flat):
                m = _sanitize(k)
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {flat[k]:g}")
        return "\n".join(lines) + "\n"


# Process-global registry: home of truly process-scoped instruments
# (the kernel launch counters in ``kernels/*/ops``).  Everything
# store/pipeline-scoped lives on a per-``EraRAG`` registry.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
