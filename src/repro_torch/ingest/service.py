"""Bounded-queue streaming ingestion service (see package docstring).

Design notes:

- Operations are FIFO: document submissions accumulate into the
  current *burst* (one pending insert op); a ``remove`` call seals the
  burst and acts as an ordering barrier, so replaying the committed
  op log onto a fresh index reproduces the exact same graph.
- A burst commits on the first tick where every document submitted so
  far is chunked and embedded — i.e. the burst is "all docs submitted
  before the commit tick", and it lands as ONE ``insert_chunks`` call,
  exactly what a synchronous ``insert_docs`` of those docs would do.
- Every tick does a bounded amount of work (at most one chunking
  quantum, one embedder launch, or one graph/store update), so a
  serving loop can interleave ``tick()`` between query batches without
  a latency cliff — the same one-step-per-refresh discipline the store
  uses for compaction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.chunker import Chunk, chunk_text
from repro_torch.obs.trace import NULL_TRACER


class IngestQueueFull(RuntimeError):
    """Raised by ``submit`` / ``remove`` when the bounded intake queue
    is at capacity — backpressure for the producer, never silent
    drops.  Both the per-document bound (``max_pending_docs``) and the
    op bound (``max_pending_ops``, covering removals too) apply."""


class IngestDrainExhausted(RuntimeError):
    """Raised by ``drain`` when ``max_ticks`` elapsed with ops still
    queued — exhaustion is an error, never a silent partial drain."""


def _knob(value: Optional[int], default: int, name: str) -> int:
    """Resolve a ctor knob: ``None`` means the config default; any
    explicit value (including 0) is validated, not silently replaced
    — ``int(x or default)`` treats 0 as "unset", the falsy-fallback
    bug class."""
    n = int(default if value is None else value)
    if n < 1:
        raise ValueError(f"{name} must be >= 1, got {n}")
    return n


@dataclass
class IngestStats:
    submitted_docs: int = 0
    committed_docs: int = 0
    committed_bursts: int = 0
    removals: int = 0
    chunks_prepared: int = 0
    embed_launches: int = 0
    ticks: int = 0
    idle_ticks: int = 0
    max_queue_depth: int = 0
    # producer-visible pressure events: submissions/removals refused
    # at capacity (IngestQueueFull raised) and successful full drains
    backpressure: int = 0
    drains: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dict(vars(self))


@dataclass
class _InsertOp:
    """One pending burst: submitted docs plus preparation state."""

    docs: List[Tuple[str, str]] = field(default_factory=list)
    chunks: List[Chunk] = field(default_factory=list)
    n_chunked: int = 0            # docs already split into self.chunks
    n_embedded: int = 0           # chunks already routed into self.pre
    pre: Dict[str, Tuple[np.ndarray, int]] = field(default_factory=dict)

    @property
    def prepared(self) -> bool:
        return (self.n_chunked == len(self.docs)
                and self.n_embedded == len(self.chunks))


@dataclass
class _RemoveOp:
    doc_ids: List[str] = field(default_factory=list)


class IngestService:
    """Background ingestion for one ``EraRAG`` index.

    ``submit`` / ``remove`` enqueue work; ``tick`` advances exactly one
    stage; ``drain`` ticks until the queue is empty (the synchronous
    fallback, used by tests and shutdown paths).  ``committed_ops`` is
    the replay log: applying it to a fresh index via ``insert_docs`` /
    ``remove_docs`` reproduces this index bitwise.
    """

    # span recorder for the ingest path; RAGPipeline swaps in the
    # pipeline's Observability tracer (inert no-op by default)
    tracer = NULL_TRACER

    def __init__(self, rag, max_pending_docs: Optional[int] = None,
                 docs_per_tick: Optional[int] = None,
                 embed_batch: Optional[int] = None,
                 max_pending_ops: Optional[int] = None):
        cfg = rag.cfg
        self.rag = rag
        self.max_pending_docs = _knob(
            max_pending_docs, cfg.ingest_max_pending_docs,
            "max_pending_docs")
        self.docs_per_tick = _knob(
            docs_per_tick, cfg.ingest_docs_per_tick, "docs_per_tick")
        self.embed_batch = _knob(
            embed_batch, cfg.ingest_embed_batch, "embed_batch")
        self.max_pending_ops = _knob(
            max_pending_ops, cfg.ingest_max_pending_ops,
            "max_pending_ops")
        self._ops: List[object] = []
        self.stats = IngestStats()
        # replay log of landed operations, in commit order:
        # ("insert", [(doc_id, text), ...]) | ("remove", [doc_id, ...])
        self.committed_ops: List[Tuple[str, list]] = []

    # -- intake --------------------------------------------------------
    @property
    def pending_docs(self) -> int:
        return sum(len(op.docs) for op in self._ops
                   if isinstance(op, _InsertOp))

    @property
    def pending_ops(self) -> int:
        return len(self._ops)

    @property
    def idle(self) -> bool:
        return not self._ops

    def submit(self, doc_id: str, text: str) -> None:
        """Queue one document for ingestion.  Raises
        ``IngestQueueFull`` at capacity (producer backpressure)."""
        if self.pending_docs >= self.max_pending_docs:
            self.stats.backpressure += 1
            raise IngestQueueFull(
                f"{self.pending_docs} docs pending "
                f"(max {self.max_pending_docs})")
        if not self._ops or not isinstance(self._ops[-1], _InsertOp):
            self._check_op_capacity()
            self._ops.append(_InsertOp())
        self._ops[-1].docs.append((str(doc_id), str(text)))
        self.stats.submitted_docs += 1
        self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                         self.pending_docs)

    def submit_many(self, docs: Sequence[Tuple[str, str]]) -> None:
        for doc_id, text in docs:
            self.submit(doc_id, text)

    def remove(self, doc_ids: Sequence[str]) -> None:
        """Queue a document removal.  Removals are ordering barriers:
        docs submitted earlier commit first, docs submitted later form
        a new burst behind the removal.  Raises ``IngestQueueFull`` at
        the op bound — removals carry no docs, so the per-doc bound
        alone would let alternating submit/remove grow ``_ops``
        without limit."""
        ids = [str(d) for d in doc_ids]
        if ids:
            self._check_op_capacity()
            self._ops.append(_RemoveOp(ids))

    def _check_op_capacity(self) -> None:
        if self.pending_ops >= self.max_pending_ops:
            self.stats.backpressure += 1
            raise IngestQueueFull(
                f"{self.pending_ops} ops pending "
                f"(max {self.max_pending_ops})")

    # -- the work loop -------------------------------------------------
    def tick(self) -> str:
        """Advance ingestion by one bounded stage; returns the stage
        name (``idle | chunk | embed | commit | remove``).  An idle
        tick still runs one store ``refresh()`` so off-path maintenance
        (compaction staging, migration steps) keeps moving."""
        with self.tracer.span("ingest_tick") as sp:
            stage = self._tick()
            if sp is not None:
                sp.attrs["stage"] = stage
        return stage

    def _tick(self) -> str:
        self.stats.ticks += 1
        if not self._ops:
            self.stats.idle_ticks += 1
            self.rag.store.refresh()
            return "idle"
        op = self._ops[0]
        if isinstance(op, _RemoveOp):
            self._ops.pop(0)
            self.rag.remove_docs(op.doc_ids)
            self.rag.store.refresh()
            self.committed_ops.append(("remove", list(op.doc_ids)))
            self.stats.removals += 1
            return "remove"
        if op.n_chunked < len(op.docs):
            take = op.docs[op.n_chunked:
                           op.n_chunked + self.docs_per_tick]
            for doc_id, text in take:
                op.chunks.extend(chunk_text(doc_id, text,
                                            self.rag.tokenizer,
                                            self.rag.cfg.chunk_tokens))
            op.n_chunked += len(take)
            return "chunk"
        if op.n_embedded < len(op.chunks):
            batch = op.chunks[op.n_embedded:
                              op.n_embedded + self.embed_batch]
            op.n_embedded += len(batch)
            # fresh-filter: skip chunks already in the graph or already
            # routed earlier in this burst (duplicate submissions) —
            # insert_chunks embeds any id missing from `pre` inline, so
            # skipping here only saves work, never changes results
            nodes = self.rag.graph.nodes
            need = [c for c in batch
                    if c.chunk_id not in nodes and c.chunk_id not in op.pre]
            if need:
                # one embedder launch per tick; encode is bitwise
                # row-independent of batch composition, so per-tick
                # sub-batches equal the one-shot synchronous encode
                embs = self.rag.graph.embedder.encode(
                    [c.text for c in need])
                keys = self.rag.graph.lsh.hash_ints(embs)
                for c, e, k in zip(need, embs, keys):
                    op.pre[c.chunk_id] = (e, int(k))
                self.stats.embed_launches += 1
                self.stats.chunks_prepared += len(need)
            return "embed"
        # fully prepared -> commit the burst as ONE graph update + one
        # lifecycle turn, exactly a synchronous insert_docs of op.docs
        self._ops.pop(0)
        report = self.rag.graph.insert_chunks(op.chunks,
                                              precomputed=op.pre)
        self.rag.reports.append(report)
        self.rag.store.refresh()
        self.committed_ops.append(("insert", list(op.docs)))
        self.stats.committed_bursts += 1
        self.stats.committed_docs += len(op.docs)
        return "commit"

    def drain(self, max_ticks: int = 1_000_000) -> int:
        """Tick until the queue is empty; returns ticks consumed.
        Raises ``IngestDrainExhausted`` if ops remain after
        ``max_ticks`` — a silent partial drain would let callers
        mistake a clipped queue for a fully landed one."""
        n = 0
        while self._ops and n < max_ticks:
            self.tick()
            n += 1
        if self._ops:
            raise IngestDrainExhausted(
                f"drain stopped after {n} ticks with "
                f"{self.pending_ops} ops ({self.pending_docs} docs) "
                f"still queued")
        self.stats.drains += 1
        return n

    # -- reporting -----------------------------------------------------
    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = self.stats.to_dict()
        out["pending_docs"] = self.pending_docs
        out["pending_ops"] = self.pending_ops
        return out
