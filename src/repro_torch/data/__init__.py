"""Data substrate: tokenizer, chunker, synthetic corpora."""
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.chunker import chunk_text, chunk_corpus
from repro_torch.data.corpus import SyntheticCorpus, QAItem

__all__ = [
    "HashTokenizer",
    "chunk_text",
    "chunk_corpus",
    "SyntheticCorpus",
    "QAItem",
]
