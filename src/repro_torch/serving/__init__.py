"""Serving: the batched LM engine and retrieval-augmented answering over
an EraRAG index."""
from repro_torch.serving.engine import Engine, EngineConfig

__all__ = ["Engine", "EngineConfig"]
