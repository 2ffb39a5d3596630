"""Core EraRAG: LSH graph, incremental update, flat store, retrieval."""
