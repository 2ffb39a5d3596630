"""Embedders."""
from repro_torch.embed.hashing import HashingEmbedder

__all__ = ["HashingEmbedder"]
