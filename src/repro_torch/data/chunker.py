"""Corpus chunking (paper §II step 1).

Sentence-aware sliding-window chunker: documents are split at sentence
boundaries, sentences greedily packed into chunks of ~``chunk_tokens``
tokens.  Chunk ids are stable content hashes so re-chunking an unchanged
document yields identical ids (idempotent inserts).
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Iterable, List, Sequence

from repro_torch.data.tokenizer import HashTokenizer

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


@dataclass(frozen=True)
class Chunk:
    chunk_id: str
    doc_id: str
    text: str
    n_tokens: int


def _chunk_id(doc_id: str, text: str) -> str:
    h = hashlib.blake2b(f"{doc_id}\x00{text}".encode("utf-8"),
                        digest_size=12)
    return h.hexdigest()


def chunk_text(doc_id: str, text: str, tokenizer: HashTokenizer,
               chunk_tokens: int = 128) -> List[Chunk]:
    sentences = [s for s in _SENT_RE.split(text.strip()) if s]
    chunks: List[Chunk] = []
    cur: List[str] = []
    cur_tokens = 0
    for sent in sentences:
        n = tokenizer.count(sent)
        if cur and cur_tokens + n > chunk_tokens:
            body = " ".join(cur)
            chunks.append(Chunk(_chunk_id(doc_id, body), doc_id, body,
                                cur_tokens))
            cur, cur_tokens = [], 0
        cur.append(sent)
        cur_tokens += n
    if cur:
        body = " ".join(cur)
        chunks.append(Chunk(_chunk_id(doc_id, body), doc_id, body,
                            cur_tokens))
    return chunks


def chunk_corpus(docs: Iterable[Sequence[str]], tokenizer: HashTokenizer,
                 chunk_tokens: int = 128) -> List[Chunk]:
    """docs: iterable of (doc_id, text) pairs."""
    out: List[Chunk] = []
    for doc_id, text in docs:
        out.extend(chunk_text(doc_id, text, tokenizer, chunk_tokens))
    return out
