"""EraRAG configuration (the only config family this package serves yet).

``EraRAGConfig`` takes every field name of the JAX package's dataclass,
because snapshots carry the config as a plain dict (``EraGraph.
state_dict()["cfg"]``) and ``EraRAG.from_state`` rebuilds it with
``EraRAGConfig(**cfg)``.  Fields whose subsystem is not ported yet
(sharding, lifecycle, quantized scan, query cache, ingest) are accepted
and validated identically; the components that would read them raise
``NotImplementedError`` when a non-default value asks for them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a component raises when asked for a subsystem this
    package does not serve yet; ``item`` names its ROADMAP entry."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


@dataclass(frozen=True)
class EraRAGConfig:
    """Hyper-parameters of the paper's technique (§III)."""

    n_hyperplanes: int = 12          # k: bits per hash code
    s_min: int = 4                   # lower segment-size bound
    s_max: int = 12                  # upper segment-size bound
    max_layers: int = 4              # L
    embed_dim: int = 256             # d
    chunk_tokens: int = 128          # tokenizer window per chunk
    top_k: int = 8                   # retrieval size
    token_budget: int = 2048         # T
    seed: int = 0                    # hyperplane PRNG seed (persisted)
    retrieval_bias_p: float = 0.5    # adaptive search p in [0, 1]
    summary_max_tokens: int = 96
    # vector-index sharding: 1 = single-buffer store (the only layout
    # served here), >1 = hash-routed shards, 0 = one per device
    index_shards: int = 1
    collective_query: bool = True
    # index lifecycle (live resharding triggers; 0.0 disables)
    reshard_skew_threshold: float = 0.0
    reshard_tombstone_threshold: float = 0.0
    reshard_min_rows: int = 256
    reshard_max_shards: int = 64
    reshard_growth_factor: int = 2
    # two-stage quantized retrieval (coarse sign-bit scan + rescore)
    quantized_scan: bool = False
    coarse_mult: int = 4
    scan_bits: int = 64
    # semantic query cache in front of retrieval
    query_cache: bool = False
    query_cache_size: int = 1024
    query_cache_threshold: float = 1.0
    # the JAX package's serial-vs-batched summarizer switch; kept so
    # its snapshots' cfg dicts load.  The port always batches (its only
    # summarizer, the extractive one, gives the same nodes either way).
    batch_summaries: bool = True
    # content-keyed summary cache size (0 disables the cache)
    summary_cache_size: int = 512
    # streaming ingestion service quanta
    ingest_max_pending_docs: int = 1024
    ingest_docs_per_tick: int = 8
    ingest_embed_batch: int = 64
    ingest_max_pending_ops: int = 4096
    # observability: counters are always live; obs_trace also records
    # nested spans on the EraRAG's Tracer (bounded at obs_max_spans)
    obs_trace: bool = False
    obs_max_spans: int = 8192

    def __post_init__(self):
        if not (0 < self.s_min <= self.s_max):
            raise ValueError(f"require 0 < s_min <= s_max, got "
                             f"[{self.s_min}, {self.s_max}]")
        if not (0.0 <= self.retrieval_bias_p <= 1.0):
            raise ValueError("retrieval_bias_p must be in [0, 1]")
        if self.index_shards < 0:
            raise ValueError("index_shards must be >= 0 (0 = auto)")
        if self.reshard_skew_threshold < 0 \
                or self.reshard_tombstone_threshold < 0:
            raise ValueError("reshard thresholds must be >= 0 "
                             "(0 disables)")
        if self.reshard_min_rows < 0:
            raise ValueError("reshard_min_rows must be >= 0")
        if self.reshard_max_shards < 1:
            raise ValueError("reshard_max_shards must be >= 1")
        if self.reshard_growth_factor < 2:
            raise ValueError("reshard_growth_factor must be >= 2 "
                             "(a skew trigger must grow the count)")
        if self.coarse_mult < 1:
            raise ValueError("coarse_mult must be >= 1 (C = "
                             "coarse_mult * k must cover the top-k)")
        if self.scan_bits < 1:
            raise ValueError("scan_bits must be >= 1")
        if self.query_cache_size < 1:
            raise ValueError("query_cache_size must be >= 1")
        if not (0.0 < self.query_cache_threshold <= 1.0):
            raise ValueError("query_cache_threshold must be in (0, 1] "
                             "(1.0 = exact-match hits only)")
        if self.summary_cache_size < 0:
            raise ValueError("summary_cache_size must be >= 0 "
                             "(0 disables the cache)")
        if self.ingest_max_pending_docs < 1 \
                or self.ingest_docs_per_tick < 1 \
                or self.ingest_embed_batch < 1 \
                or self.ingest_max_pending_ops < 1:
            raise ValueError("ingest_* settings must be >= 1")
        if self.obs_max_spans < 1:
            raise ValueError("obs_max_spans must be >= 1")

    def scaled_bounds(self, scale: float) -> "EraRAGConfig":
        """Tab V ablation: scale tolerance delta around the mean size."""
        mid = (self.s_min + self.s_max) / 2
        delta = (self.s_max - self.s_min) / 2 * scale
        lo = max(1, int(round(mid - delta)))
        hi = max(lo, int(round(mid + delta)))
        return dataclasses.replace(self, s_min=lo, s_max=hi)
