"""Segment summarizers (paper Alg 1 L12-13; the dominant cost, Fig 8).

``ExtractiveSummarizer`` is deterministic centroid-nearest-sentence
selection with zero model weights, so every run is exactly
reproducible offline; token accounting (tokens_in = segment text,
tokens_out = summary) matches how the paper counts LLM cost.  It runs
on the host (numpy), like the embedder it calls.

Summarizers speak the batched protocol: ``EraGraph`` hands a whole
update's worth of segments to one ``summarize_batch`` call (the
extractive path is a loop over ``summarize``).

``SummaryCache`` is the content-keyed reuse layer: segment summaries
keyed by a digest over the (layer, member-id) basis of ``_node_id`` —
member ids are themselves content addresses, so a re-routed segment
whose membership is unchanged reuses its summary instead of paying the
summarizer again.  The graph owns one, persists it in ``state_dict``,
and reports hit/miss/tokens-saved movement per update.
"""
from __future__ import annotations

import hashlib
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


@dataclass
class SummaryResult:
    text: str
    tokens_in: int
    tokens_out: int


class Summarizer(Protocol):
    def summarize(self, texts: Sequence[str]) -> SummaryResult: ...

    def summarize_batch(self, batches: Sequence[Sequence[str]]
                        ) -> List[SummaryResult]: ...


@dataclass
class SummaryCacheStats:
    hits: int = 0
    misses: int = 0
    tokens_saved: int = 0     # prompt tokens NOT sent thanks to hits

    def to_dict(self) -> Dict[str, int]:
        return dict(vars(self))


class SummaryCache:
    """Content-keyed LRU of segment summaries.

    Keys are digests over ``(layer, member node ids)`` — the same basis
    ``graph._node_id`` hashes, and member ids are content addresses
    themselves — so a key identifies a segment by *what it contains*,
    not where routing happened to place it.  Any membership change
    (add, remove, or a member whose own text changed and therefore
    carries a new id) produces a different key: invalidation is
    structural, never TTL-based, and a stale summary can never be
    reused.  Summarizers are deterministic, so a hit returns exactly
    the text a regeneration would have produced — the cache only
    removes the summarizer cost, measured in ``stats.tokens_saved``.
    """

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("SummaryCache capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, str]" = OrderedDict()
        self.stats = SummaryCacheStats()

    @staticmethod
    def digest(layer: int, members: Sequence[str]) -> str:
        h = hashlib.blake2b(digest_size=12)
        h.update(str(layer).encode())
        for m in members:
            h.update(m.encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()

    def get(self, key: str) -> Optional[str]:
        text = self._entries.get(key)
        if text is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return text

    def put(self, key: str, text: str) -> None:
        self._entries[key] = text
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def state_dict(self) -> List[List[str]]:
        return [[k, v] for k, v in self._entries.items()]

    def load_state(self, entries: Sequence[Sequence[str]]) -> None:
        for k, v in entries:
            self.put(str(k), str(v))


@dataclass
class ExtractiveSummarizer:
    """Pick sentences nearest the segment centroid until the budget."""

    embedder: object                      # .encode(list[str]) -> (n, d)
    max_tokens: int = 96
    tokenizer: HashTokenizer = field(default_factory=HashTokenizer)

    def summarize(self, texts: Sequence[str]) -> SummaryResult:
        tokens_in = sum(self.tokenizer.count(t) for t in texts)
        sents: List[str] = []
        for t in texts:
            sents.extend(s for s in _SENT_RE.split(t.strip()) if s)
        # dedup, preserve order
        seen = set()
        uniq = []
        for s in sents:
            if s not in seen:
                seen.add(s)
                uniq.append(s)
        if not uniq:
            return SummaryResult("", tokens_in, 0)
        embs = self.embedder.encode(uniq)
        centroid = embs.mean(axis=0)
        nc = np.linalg.norm(centroid)
        centroid = centroid / (nc if nc > 0 else 1.0)
        scores = embs @ centroid
        order = np.argsort(-scores, kind="stable")
        picked: List[int] = []
        total = 0
        for i in order:
            n = self.tokenizer.count(uniq[int(i)])
            if picked and total + n > self.max_tokens:
                continue
            picked.append(int(i))
            total += n
            if total >= self.max_tokens:
                break
        picked.sort()  # restore narrative order
        summary = " ".join(uniq[i] for i in picked)
        return SummaryResult(summary, tokens_in,
                             self.tokenizer.count(summary))

    def summarize_batch(self, batches: Sequence[Sequence[str]]
                        ) -> List[SummaryResult]:
        """Model-free path: per-segment selection is already cheap and
        independent, so the batch is a loop (bitwise the serial path)."""
        return [self.summarize(texts) for texts in batches]
