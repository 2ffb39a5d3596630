"""Deterministic nested tracing.

A :class:`Tracer` produces :class:`Span` records with stack-based
nesting: a root span opens a new trace (its ``trace_id`` is the query
id), children inherit the trace id and get ``depth = parent + 1``.
Timestamps come from the injectable obs clock, so under
``clock.use_clock(ManualClock())`` every span start/end (and therefore
the exported JSONL) is bit-for-bit reproducible.

The disabled path is :data:`NULL_TRACER` — a singleton whose
``span()`` returns one shared no-op context manager, so instrumented
call sites cost a dict build and two trivial calls when tracing is
off and never allocate span state.
"""
from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import clock as _clock


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    start: float
    end: float = 0.0
    depth: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "trace_id": self.trace_id,
            "start": self.start, "end": self.end, "depth": self.depth,
            "attrs": self.attrs,
        }


class Tracer:
    """Span recorder with a bounded buffer and monotone totals.

    ``total_spans`` never decreases while the tracer lives (the live
    harness reads deltas across phases); the ``spans`` buffer is
    bounded at ``max_spans`` — once full, finished spans are counted
    in ``dropped`` instead of retained.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_spans: int = 8192):
        self._clock = clock or _clock.now
        self.max_spans = int(max_spans)
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 1
        self._next_trace = 1
        self.total_spans = 0
        self.dropped = 0

    @contextmanager
    def span(self, name: str, **attrs):
        sid = self._next_id
        self._next_id += 1
        if self._stack:
            parent = self._stack[-1]
            pid, tid = parent.span_id, parent.trace_id
            depth = parent.depth + 1
        else:
            pid = None
            tid = self._next_trace
            self._next_trace += 1
            depth = 0
        sp = Span(name=name, span_id=sid, parent_id=pid, trace_id=tid,
                  start=self._clock(), depth=depth, attrs=dict(attrs))
        self._stack.append(sp)
        try:
            yield sp
        finally:
            sp.end = self._clock()
            self._stack.pop()
            self.total_spans += 1
            if len(self.spans) < self.max_spans:
                self.spans.append(sp)
            else:
                self.dropped += 1

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per finished span; returns the count."""
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(sp.to_dict(), sort_keys=True))
                f.write("\n")
        return len(self.spans)

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.parent_id is None]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def reset(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self.dropped = 0


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


class NullTracer:
    """Inert tracer: no spans, no state, shared no-op context."""

    enabled = False
    total_spans = 0
    dropped = 0
    spans: tuple = ()

    def span(self, name: str, **attrs):
        return _NULL_CONTEXT

    def export_jsonl(self, path: str) -> int:
        return 0

    def roots(self):
        return []

    def children(self, span):
        return []

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()
