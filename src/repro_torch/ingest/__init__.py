"""Streaming ingestion: the growing-corpus path off the query path.

The paper's pitch is continuous corpus growth, but a caller-driven
``insert_docs`` stalls serving for the whole chunk + embed + summarize
pipeline of every burst.  ``IngestService`` makes ingestion a bounded
background process that interleaves with serving, one small work
quantum per ``tick()``:

- **chunk**: split up to ``ingest_docs_per_tick`` queued documents;
- **embed**: encode up to ``ingest_embed_batch`` prepared chunks in one
  host embedder call, then LSH-route them with one ``hash_ints`` call
  (one ``lsh_hash`` launch on the card);
- **commit**: ONE ``insert_chunks(precomputed=...)`` graph update for
  the fully-prepared burst, then one store ``refresh()``.

Because the embedder and hash are row-deterministic and the commit
replays chunks in exact submission order, a background-ingested burst
is **bitwise identical** to a synchronous ``insert_docs`` of the same
documents — same node ids, same store row order, same retrieval
results.  ``tests/test_torch_ingest.py`` asserts exactly that, against
the synchronous port and against the JAX package.

Summarization cost (the dominant update cost, paper Fig 8) is handled
underneath by ``EraGraph``'s batched ``summarize_batch`` materialization
and the content-keyed ``SummaryCache`` (``core/summarize.py``).
"""
from repro_torch.ingest.service import IngestDrainExhausted, \
    IngestQueueFull, IngestService, IngestStats

__all__ = ["IngestDrainExhausted", "IngestQueueFull", "IngestService",
           "IngestStats"]
