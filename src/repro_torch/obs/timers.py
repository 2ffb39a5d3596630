"""One timer helper for every ``time_*`` accumulation in the repo.

``timed_block(target, field)`` replaces the scattered
``t0 = time.perf_counter(); ...; target.field += perf_counter() - t0``
blocks in ``core/graph.py``, ``core/baselines.py`` and
``common/utils.py``.  It reads the injectable obs clock, accumulates
onto a dict key or an object attribute, and — when given a tracer and
a span name — opens a trace span around the same interval, so the
``UpdateReport.time_*`` fields and the trace can never drift apart.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.obs import clock as _clock
from repro_torch.obs.trace import NULL_TRACER


@contextmanager
def timed_block(target, field: str, tracer=None,
                span: Optional[str] = None, **attrs):
    """Accumulate elapsed clock time onto ``target[field]`` (dict) or
    ``target.field`` (object attribute), optionally under a trace span."""
    tr = tracer if tracer is not None else NULL_TRACER
    cm = tr.span(span, **attrs) if span is not None else None
    if cm is not None:
        cm.__enter__()
    t0 = _clock.now()
    try:
        yield
    finally:
        dt = _clock.now() - t0
        if isinstance(target, dict):
            target[field] = target.get(field, 0.0) + dt
        else:
            setattr(target, field, getattr(target, field, 0.0) + dt)
        if cm is not None:
            cm.__exit__(None, None, None)
