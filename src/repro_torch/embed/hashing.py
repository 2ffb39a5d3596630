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
from typing import Sequence

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


def _feat_hash(token: str, n_features: int) -> int:
    h = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_features


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

    def _features(self, text: str) -> np.ndarray:
        counts = np.zeros(self.n_features, dtype=np.float32)
        words = [w.lower() for w in self.tok.tokenize(text)]
        for w in words:
            counts[_feat_hash("u:" + w, self.n_features)] += 1.0
        for a, b in zip(words, words[1:]):
            counts[_feat_hash(f"b:{a}:{b}", self.n_features)] += 1.0
        # sublinear tf damping
        np.log1p(counts, out=counts)
        return counts

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """-> (n, dim) float32, rows L2-normalized."""
        if isinstance(texts, str):
            raise TypeError("pass a sequence of texts, not a single str")
        self.stats["encode_calls"] += 1
        self.stats["texts_encoded"] += len(texts)
        feats = np.stack([self._features(t) for t in texts])
        vecs = feats @ self._proj
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return (vecs / norms).astype(np.float32)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]
