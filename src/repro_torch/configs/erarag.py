"""The paper's own system config (EraRAG hyper-parameters).

``ERARAG_DEFAULT`` is the main path: a flat store, no LM, no quantized
scan, no cache — the configuration ``chip_smoke.py`` drives on the card.
The two serving profiles below keep its hierarchy and retrieval
hyper-parameters and switch on one group of fields each.

Two-stage quantized retrieval (``kernels/quantized_scan``) is wired
behind three fields, off by default so the exact dense scan stays the
baseline and the differential oracle:

- ``quantized_scan``: serve every search as a coarse Hamming scan over
  packed LSH sign-bit codes (``hamming_topk``) followed by an exact
  fp32 rescore of the surviving candidates (``mips_rescore``; scores
  stay bitwise-equal to the dense scan's for the rows returned; only
  candidate selection is approximate).
- ``coarse_mult``: rescore budget — the coarse stage keeps
  ``C = coarse_mult * top_k`` candidates per query (clamped to the
  shard capacity; a huge value degrades gracefully into the exact
  scan, bitwise).
- ``scan_bits``: code width in bits (64 = two uint32 words per row,
  ~32x fewer bytes scanned than fp32 rows at ``embed_dim=256``).

The scan hyperplanes derive from the config's ``seed``, which is
persisted in the store snapshot — a restored index re-quantizes to
bit-identical codes.

Serving-path caching is wired behind three more fields, also off by
default (the uncached pipeline is the behavioral baseline — disabled
config reproduces it bitwise):

- ``query_cache``: put a ``SemanticQueryCache`` in front of retrieval.
  Repeated queries hit an exact (embedding-digest) fast path; with
  ``query_cache_threshold < 1.0`` near-duplicate phrasings also hit by
  cosine similarity.  Invalidation is exact — entries live under the
  store ``cache_token`` (epoch + graph version), so any committed
  insert/delete/reshard drops the generation and a stale retrieval is
  never served.  No TTL.
- ``query_cache_size``: LRU entry capacity.
- ``query_cache_threshold``: cosine floor for a semantic hit in
  (0, 1]; 1.0 keeps only exact-match hits (every returned context is
  then bitwise identical to the uncached pipeline's), lower values
  trade retrieval fidelity on near-duplicates for hit rate.

The KV *prefix* cache (N questions over one retrieved context pay one
context prefill) is an engine-side knob: ``EngineConfig.
prefix_cache_entries`` in ``repro_torch/serving/engine.py``, default 0
(off).

The *write* path (growing corpora — the paper's headline) is governed
by the ingest fields, all behavior-preserving accelerations (the graph
they produce is bitwise the serial one):

- ``batch_summaries``: materialize every segment a layer update
  touches in ONE ``Summarizer.summarize_batch`` call — through
  ``LMSummarizer`` that is one bucketed-prefill ``generate_batch``
  per update instead of one engine launch per segment.  False keeps
  the serial loop (the differential oracle).
- ``summary_cache_size``: content-keyed LRU of segment summaries
  (digest over layer + member node ids, the ``_node_id`` basis) so
  re-formed segments with unchanged membership skip the engine; 0
  disables.  Persisted in ``state_dict``; hit/token-savings counters
  surface in ``UpdateReport`` and ``index_report()["ingest"]``.
- ``ingest_max_pending_docs`` / ``ingest_docs_per_tick`` /
  ``ingest_embed_batch``: the ``repro_torch.ingest.IngestService``
  intake bound and per-``tick()`` work quanta (docs chunked, chunks
  embedded per embedder launch).
"""
from repro_torch.common.config import EraRAGConfig

ERARAG_DEFAULT = EraRAGConfig(
    n_hyperplanes=12,
    s_min=4,
    s_max=12,
    max_layers=4,
    embed_dim=256,
    chunk_tokens=64,
    top_k=8,
    token_budget=2048,
)

# the quantized-retrieval serving profile: identical hierarchy and
# retrieval hyper-parameters, search served through the two-stage
# coarse-code + exact-rescore pipeline
ERARAG_QUANTIZED = EraRAGConfig(
    n_hyperplanes=12,
    s_min=4,
    s_max=12,
    max_layers=4,
    embed_dim=256,
    chunk_tokens=64,
    top_k=8,
    token_budget=2048,
    quantized_scan=True,
    coarse_mult=4,
    scan_bits=64,
)

# the streaming-ingest serving profile: same hierarchy/retrieval
# hyper-parameters, tuned for continuous growth under live traffic —
# small per-tick quanta keep each ingest step short relative to a
# query batch, and a deep summary cache absorbs churn; its intake
# bound of 4096 holds the 2500 documents a 5000-document live day
# queues at its largest burst
ERARAG_STREAMING = EraRAGConfig(
    n_hyperplanes=12,
    s_min=4,
    s_max=12,
    max_layers=4,
    embed_dim=256,
    chunk_tokens=64,
    top_k=8,
    token_budget=2048,
    batch_summaries=True,
    summary_cache_size=2048,
    ingest_max_pending_docs=4096,
    ingest_docs_per_tick=4,
    ingest_embed_batch=32,
)
