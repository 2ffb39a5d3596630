"""Deterministic hash tokenizer.

Word-level tokenization with ids assigned by a stable hash into a fixed
vocab.  Not a learned BPE — the framework's LM substrate only needs ids
that are (a) deterministic across processes and (b) bounded by
``vocab_size``; token *counts* (the paper's cost metric) use the same
word segmentation the paper's tokenizers approximate.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

_WORD_RE = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")

# ids 0..3 reserved
PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3
N_RESERVED = 4


def _stable_hash(token: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(),
        "little")


class HashTokenizer:
    def __init__(self, vocab_size: int = 32000):
        if vocab_size <= N_RESERVED:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size

    def tokenize(self, text: str) -> List[str]:
        return _WORD_RE.findall(text)

    def encode(self, text: str, add_special: bool = False) -> np.ndarray:
        span = self.vocab_size - N_RESERVED
        ids = [N_RESERVED + _stable_hash(t.lower()) % span
               for t in self.tokenize(text)]
        if add_special:
            ids = [BOS_ID] + ids + [EOS_ID]
        return np.asarray(ids, dtype=np.int32)

    def count(self, text: str) -> int:
        """Token count for cost accounting (no special tokens)."""
        return len(self.tokenize(text))


DEFAULT_TOKENIZER = HashTokenizer()
