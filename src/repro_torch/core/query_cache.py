"""Epoch-invalidated semantic query cache (serving-path retrieval).

RAG traffic at scale is heavily skewed: the same (or near-duplicate)
questions arrive over and over against an index that mutates slowly.
``SemanticQueryCache`` sits in front of retrieval and serves repeated
queries without a store scan:

- **exact fast path**: a blake2 digest of the query embedding bytes —
  an identical query string (hence identical embedding) hits in O(1);
- **semantic path**: cosine-threshold match of the (L2-normalized)
  query embedding against the cached embeddings under the same
  retrieval key — near-duplicate phrasings reuse the best cached
  retrieval when similarity >= ``threshold`` (1.0 disables the
  semantic path, keeping only exact hits).

Correctness is exact, not TTL-based: every entry is stored under the
store's ``cache_token`` — ``(epoch, graph version)`` — which moves on
every committed mutation a search could observe (inserts/deletes via
the graph version, reshard epoch swaps via the epoch counter).  A
lookup under a different token drops the whole generation before
matching, so a cached ``Retrieval`` can never be served stale: queries
issued mid-migration still serve (and cache against) the OLD epoch,
exactly like the store itself, and the atomic ``install_epoch`` swap
invalidates in the same step that makes the new epoch visible.

Entries are LRU-evicted at ``capacity``.  Retrieval payloads are
returned as shallow copies (fresh ``hits`` list) so callers can't
mutate the cached row.

Everything here runs on the host, as in the JAX package: the query
embeddings are host numpy arrays, so digests are bitwise the JAX
package's, and the cosine match is one small numpy product per lookup
(a device round trip would cost more than it saves).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.core.retrieve import Retrieval


@dataclass
class QueryCacheStats:
    """Movement counters (serving dashboards / benchmark evidence)."""

    hits_exact: int = 0
    hits_semantic: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    invalidations: int = 0     # token moves that dropped a generation

    @property
    def hits(self) -> int:
        return self.hits_exact + self.hits_semantic

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def to_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hits"] = self.hits
        d["hit_rate"] = self.hit_rate
        return d


@dataclass
class _Entry:
    emb: np.ndarray            # L2-normalized query embedding (d,)
    retrieval: Retrieval
    digest: bytes


@dataclass
class _KeyGroup:
    """Per-retrieval-key embedding plane for the cosine scan."""

    digests: List[bytes] = field(default_factory=list)
    embs: List[np.ndarray] = field(default_factory=list)

    def matrix(self) -> Optional[np.ndarray]:
        return np.stack(self.embs) if self.embs else None


def _digest(q: np.ndarray) -> bytes:
    return hashlib.blake2b(q.tobytes(), digest_size=16).digest()


def _normalized(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float32)
    n = float(np.linalg.norm(q))
    return q / n if n > 0 else q


class SemanticQueryCache:
    """LRU retrieval cache keyed by ``(retrieval key, query)`` and
    invalidated exactly by the store ``cache_token``.

    The *retrieval key* is whatever makes two searches comparable —
    the facade uses ``(k, mode, token_budget, bias p)``; a
    ``layer_filter`` belongs in the key when caching filtered scans
    directly.  The query side matches exact-first (embedding digest),
    then by cosine threshold within the same retrieval key.
    """

    def __init__(self, capacity: int = 1024, threshold: float = 1.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (0.0 < threshold <= 1.0):
            raise ValueError(
                f"threshold must be in (0, 1], got {threshold}")
        self.capacity = int(capacity)
        self.threshold = float(threshold)
        self.stats = QueryCacheStats()
        self._token: Optional[Tuple[int, int]] = None
        # digest -> entry, LRU order; one flat map, per-key groups for
        # the cosine scan (a digest is unique per (key, emb) because
        # the key is folded into it)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._groups: Dict[Hashable, _KeyGroup] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._groups.clear()

    def _sync_token(self, token: Tuple[int, int]) -> None:
        """Drop the cached generation when the store token moved (the
        epoch/_version check that replaces a TTL)."""
        if token != self._token:
            if self._entries:
                self.stats.invalidations += 1
            self.clear()
            self._token = token

    @staticmethod
    def _fold(key: Hashable, digest: bytes) -> bytes:
        return hashlib.blake2b(repr(key).encode() + digest,
                               digest_size=16).digest()

    def lookup(self, token: Tuple[int, int], key: Hashable,
               q: np.ndarray) -> Optional[Retrieval]:
        """Cached ``Retrieval`` for one query embedding, or None."""
        self._sync_token(token)
        qn = _normalized(q)
        d = self._fold(key, _digest(qn))
        ent = self._entries.get(d)
        if ent is not None:
            self._entries.move_to_end(d)
            self.stats.hits_exact += 1
            return self._copy(ent.retrieval)
        if self.threshold < 1.0:
            grp = self._groups.get(key)
            mat = grp.matrix() if grp is not None else None
            if mat is not None:
                sims = mat @ qn
                best = int(np.argmax(sims))
                if float(sims[best]) >= self.threshold:
                    ent = self._entries[grp.digests[best]]
                    self._entries.move_to_end(grp.digests[best])
                    self.stats.hits_semantic += 1
                    return self._copy(ent.retrieval)
        self.stats.misses += 1
        return None

    def lookup_batch(self, token: Tuple[int, int], key: Hashable,
                     queries: np.ndarray) -> List[Optional[Retrieval]]:
        return [self.lookup(token, key, queries[b])
                for b in range(queries.shape[0])]

    def put(self, token: Tuple[int, int], key: Hashable,
            q: np.ndarray, retrieval: Retrieval) -> None:
        self._sync_token(token)
        qn = _normalized(q)
        d = self._fold(key, _digest(qn))
        if d in self._entries:           # refresh LRU position only
            self._entries.move_to_end(d)
            return
        self._entries[d] = _Entry(emb=qn,
                                  retrieval=self._copy(retrieval),
                                  digest=d)
        grp = self._groups.setdefault(key, _KeyGroup())
        grp.digests.append(d)
        grp.embs.append(qn)
        self.stats.puts += 1
        while len(self._entries) > self.capacity:
            old, _ = self._entries.popitem(last=False)
            self.stats.evictions += 1
            for g in self._groups.values():
                if old in g.digests:
                    i = g.digests.index(old)
                    g.digests.pop(i)
                    g.embs.pop(i)
                    break

    @staticmethod
    def _copy(r: Retrieval) -> Retrieval:
        """Shallow copy with a fresh hits list: cached payloads must
        survive caller-side mutation (e.g. epoch stamping)."""
        return dataclasses.replace(r, hits=list(r.hits))
