"""Observability layer.

One :class:`Observability` per :class:`~repro_torch.core.erarag.EraRAG`:
a private :class:`MetricsRegistry` of counters and a :class:`Tracer`
(or the shared :data:`NULL_TRACER` when tracing is off).  Config-gated
by ``EraRAGConfig.obs_trace``/``obs_max_spans``; the default is
counters-only and the disabled path is bitwise inert.
"""
from repro_torch.obs.clock import ManualClock, now, set_clock, use_clock
from repro_torch.obs.metrics import Counter, MetricsRegistry, \
    global_registry
from repro_torch.obs.timers import timed_block
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "MetricsRegistry", "ManualClock", "NULL_TRACER",
    "NullTracer", "Observability", "Span", "Tracer", "global_registry",
    "now", "set_clock", "timed_block", "use_clock",
]


class Observability:
    """Per-pipeline registry + tracer bundle."""

    def __init__(self, trace: bool = False, max_spans: int = 8192):
        self.registry = MetricsRegistry()
        self.tracer = Tracer(max_spans=max_spans) if trace \
            else NULL_TRACER

    @property
    def enabled(self) -> bool:
        """True when span tracing is on (counters are always live)."""
        return self.tracer is not NULL_TRACER
