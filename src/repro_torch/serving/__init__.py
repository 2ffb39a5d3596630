"""Serving: retrieval-augmented answering over an EraRAG index."""
