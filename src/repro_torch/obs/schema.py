"""Declared metric-name schema for ``RAGPipeline.index_report()``.

``INDEX_REPORT_SCHEMA`` is the hand-maintained inventory of every
numeric key the report may surface, as dotted paths with list indices
normalized to ``*``.  It is deliberately static (NOT derived from the
dataclasses it mirrors) so the drift check in
``tests/test_torch_index_report.py`` fires the moment a new counter is
added to a subsystem without being declared here — new telemetry
cannot silently bypass the obs layer.  The set is the JAX package's,
key for key: both packages' reports declare the same names.

Non-numeric leaves (strings such as shard ``device``, booleans such as
``quantized_scan``/``collective_query``, and ``None``) are outside the
schema: :func:`flatten_numeric` skips them.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List


def flatten_numeric(obj, prefix: str = "") -> Dict[str, float]:
    """Flatten nested dicts/lists to dotted numeric leaves.

    List/tuple indices normalize to ``*`` (all elements share one
    schema entry); ``bool``/``str``/``None`` leaves are skipped.
    """
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten_numeric(v, key))
    elif isinstance(obj, (list, tuple)):
        key = f"{prefix}.*" if prefix else "*"
        for v in obj:
            out.update(flatten_numeric(v, key))
    elif isinstance(obj, bool) or obj is None or isinstance(obj, str):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix] = obj
    return out


def undeclared(report: dict,
               declared: FrozenSet[str] | None = None) -> List[str]:
    """Numeric keys surfaced by ``report`` but absent from the schema."""
    schema = INDEX_REPORT_SCHEMA if declared is None else declared
    return sorted(k for k in flatten_numeric(report) if k not in schema)


_STORE_STATS = (
    "refreshes", "full_rebuilds", "rows_staged", "rows_tombstoned",
    "compactions", "compactions_skipped", "rows_compacted", "growths",
    "route_hits", "route_misses", "bulk_routed", "reshards",
    "reshard_steps", "quantized_scans", "kernel_launches",
)

_SCHEMA: List[str] = [
    # top-level scalars
    "size", "epoch", "retrieval_rounds", "coarse_mult", "scan_bits",
    "pending_compaction",
    # store stats (flat + sharded aggregate)
    *(f"stats.{k}" for k in _STORE_STATS),
    # lifecycle load report (ShardLoadReport.to_dict())
    "load.n_shards", "load.epoch", "load.size", "load.dead",
    "load.skew", "load.query_skew", "load.tombstone_fraction",
    "load.pending_compaction",
    *(f"load.routing.{k}"
      for k in ("hits", "misses", "size", "maxsize", "bulk_routed")),
    *(f"load.shards.*.{k}"
      for k in ("shard", "rows", "dead", "capacity", "staged",
                "compactions", "query_hits")),
    "load.migration.built", "load.migration.total",
    *(f"load.migration.plan.{k}"
      for k in ("n_from", "n_to", "version", "n_rows")),
    # serving caches
    *(f"query_cache.{k}"
      for k in ("hits_exact", "hits_semantic", "misses", "puts",
                "evictions", "invalidations", "hits", "hit_rate")),
    *(f"prefix_cache.{k}" for k in ("hits", "tokens_saved", "entries")),
    # streaming ingest
    *(f"ingest.summary_cache.{k}"
      for k in ("hits", "misses", "tokens_saved")),
    "ingest.summary_cache_entries",
    *(f"ingest.service.{k}"
      for k in ("submitted_docs", "committed_docs", "committed_bursts",
                "removals", "chunks_prepared", "embed_launches",
                "ticks", "idle_ticks", "max_queue_depth",
                "backpressure", "drains", "pending_docs",
                "pending_ops")),
    # per-subsystem launch accounting
    "launches.retrieval_rounds",
    *(f"launches.store.{k}"
      for k in ("refreshes", "compactions", "reshard_steps",
                "quantized_scans", "kernel_launches")),
    *(f"launches.embedder.{k}"
      for k in ("encode_calls", "texts_encoded")),
    *(f"launches.summarizer.{k}"
      for k in ("summarize_launches", "segments_summarized")),
    *(f"launches.engine.{k}"
      for k in ("prefill_launches", "decode_launches",
                "generate_batches")),
    # sharded per-shard report
    *(f"shards.*.{k}"
      for k in ("rows", "dead", "dead_ratio", "capacity", "staged",
                "compactions", "query_hits")),
    # tracer accounting (present only when tracing is enabled)
    "obs.spans", "obs.spans_dropped",
]

INDEX_REPORT_SCHEMA: FrozenSet[str] = frozenset(_SCHEMA)
