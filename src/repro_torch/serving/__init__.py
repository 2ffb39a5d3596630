"""Serving: the batched LM engine, retrieval-augmented answering over an
EraRAG index, and the live-serving harness."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.live_harness import LiveHarness, LiveSchedule, \
    Phase, make_schedule
from repro_torch.serving.rag_pipeline import RAGPipeline

__all__ = ["Engine", "EngineConfig", "LiveHarness", "LiveSchedule",
           "Phase", "RAGPipeline", "make_schedule"]
