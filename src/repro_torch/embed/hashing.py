"""Deterministic hash-n-gram random-projection embedder.

Stands in for BGE-M3 on CPU: texts sharing vocabulary (word unigrams +
bigrams) map to nearby unit vectors, so LSH bucket structure and
retrieval quality are measurable offline with zero model weights.
Implemented as feature-hashed sparse counts (dim ``n_features``) pushed
through a fixed Gaussian random projection to ``dim`` and L2-normalized —
Johnson-Lindenstrauss preserves the cosine geometry the paper's
Theorem 1 depends on.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Sequence

import numpy as np

from repro_torch.data.tokenizer import DEFAULT_TOKENIZER, HashTokenizer


FEATURE_CACHE = 1 << 17     # texts whose sparse features are kept


@lru_cache(maxsize=1 << 20)
def _feat_hash(token: str, n_features: int) -> int:
    h = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_features


def _sparse_features(words: Sequence[str], n_features: int) -> tuple:
    """(feature ids, their log1p counts): word unigrams and bigrams."""
    words = [w.lower() for w in words]
    idx = [_feat_hash("u:" + w, n_features) for w in words]
    idx += [_feat_hash(f"b:{a}:{b}", n_features)
            for a, b in zip(words, words[1:])]
    ids, counts = np.unique(np.asarray(idx, dtype=np.int64),
                            return_counts=True)
    # sublinear tf damping of whole counts, exact in float32 as the sums
    # of ones they replace
    return ids, np.log1p(counts.astype(np.float32))


@lru_cache(maxsize=FEATURE_CACHE)
def _text_features(text: str, n_features: int) -> tuple:
    """``_sparse_features`` of ``text`` under ``HashTokenizer``, kept for
    the most recent texts: a summary re-encodes its members' sentences,
    and every index over one corpus encodes the same chunks."""
    return _sparse_features(DEFAULT_TOKENIZER.tokenize(text), n_features)


class HashingEmbedder:
    def __init__(self, dim: int = 256, n_features: int = 4096,
                 seed: int = 0, tokenizer: HashTokenizer | None = None):
        self.dim = dim
        self.n_features = n_features
        self.tok = tokenizer or HashTokenizer()
        rng = np.random.Generator(np.random.PCG64(seed))
        # fixed projection, float32, column-normalized
        self._proj = rng.standard_normal((n_features, dim)).astype(
            np.float32) / np.sqrt(dim)
        # launch accounting for the live-serving harness: one "launch"
        # per encode() call (the batching unit), texts counted per row
        self.stats = {"encode_calls": 0, "texts_encoded": 0}

    def _features(self, text: str) -> tuple:
        """(feature ids, their log1p counts) of ``text``."""
        if type(self.tok) is HashTokenizer:
            return _text_features(text, self.n_features)
        return _sparse_features(self.tok.tokenize(text), self.n_features)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """-> (n, dim) float32, rows L2-normalized."""
        if isinstance(texts, str):
            raise TypeError("pass a sequence of texts, not a single str")
        self.stats["encode_calls"] += 1
        self.stats["texts_encoded"] += len(texts)
        feats = np.zeros((len(texts), self.n_features), dtype=np.float32)
        for row, t in zip(feats, texts):
            ids, vals = self._features(t)
            row[ids] = vals
        vecs = feats @ self._proj
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return (vecs / norms).astype(np.float32)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]
