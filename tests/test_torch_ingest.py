"""Streaming ingestion (``ingest/service.py``) in the PyTorch port, on
the CPU.

The first group is the port's counterpart of the service cases of
``tests/test_ingest.py``: a burst fed through ``IngestService`` is
bitwise a synchronous ``insert_docs`` of the same documents (node ids,
keys, embeddings, retrieval scores with no tolerance), removals are
ordering barriers, and the queue bounds, knobs and drain limits raise
rather than drop.  The second group runs one submit/tick/remove script
through the JAX package and the port: tick stages, ``committed_ops``,
``IngestStats``, node ids and the store buffer's bytes must be equal,
and so must the ``ingest_tick`` spans under a manual clock.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.ingest import IngestService as JaxIngestService
from repro.obs import ManualClock as JaxClock, use_clock as jax_use_clock

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.graph import EraGraph
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.ingest import IngestDrainExhausted, IngestQueueFull, \
    IngestService
from repro_torch.obs import ManualClock, use_clock
from torch_threads import one_blas_thread  # noqa: F401

KW = dict(embed_dim=32, n_hyperplanes=8, s_min=2, s_max=4, max_layers=3,
          chunk_tokens=16, top_k=6, token_budget=512)
CFG = EraRAGConfig(**KW)


def _docs(n, start=0):
    return [(f"d{i}", f"doc {i} alpha beta gamma. topic {i % 4} body "
                      f"text here. more words follow {i}.")
            for i in range(start, start + n)]


def _rag(cfg=CFG):
    return EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), device="cpu")


def _assert_same_graph(a: EraGraph, b: EraGraph):
    # order matters: store row order (and therefore top-k tie-breaks)
    # follows node creation order
    assert list(a.nodes) == list(b.nodes)
    for nid in a.nodes:
        na, nb = a.nodes[nid], b.nodes[nid]
        assert na.text == nb.text
        assert na.n_tokens == nb.n_tokens
        assert na.key == nb.key
        assert np.array_equal(na.embedding, nb.embedding)


def _assert_same_retrieval(a, b, queries):
    for q in queries:
        ra, rb = a.query(q), b.query(q)
        assert [h.node_id for h in ra.hits] == \
            [h.node_id for h in rb.hits]
        assert [h.score for h in ra.hits] == \
            [h.score for h in rb.hits]          # bitwise, no tolerance
        assert ra.context == rb.context


QUERIES = ["topic 1 body", "doc 7 alpha beta", "more words follow 3",
           "gamma topic 2"]


def _count_hash_calls(rag):
    """Wrap the graph's ``hash_ints`` (one ``lsh_hash`` launch on the
    card) with a call counter."""
    calls = []
    orig = rag.graph.lsh.hash_ints

    def counted(v):
        calls.append(len(v))
        return orig(v)
    rag.graph.lsh.hash_ints = counted
    return calls


# ---------------------------------------------------------------------------
# background ingest == synchronous insert_docs
# ---------------------------------------------------------------------------

def test_background_ingest_matches_sync_insert():
    live = _rag()
    live.insert_docs(_docs(8))
    svc = IngestService(live, docs_per_tick=3, embed_batch=4)
    svc.submit_many(_docs(10, start=8))
    calls = _count_hash_calls(live)
    stages = []
    while not svc.idle:
        n = len(calls)
        stages.append(svc.tick())
        if stages[-1] == "embed":
            # one embed tick: one hash call of at most embed_batch rows
            assert len(calls) == n + 1 and calls[-1] <= 4
        live.query("topic 2 body")      # serving interleaves freely
    assert stages.count("embed") == svc.stats.embed_launches
    twin = _rag()
    twin.insert_docs(_docs(8))
    for kind, payload in svc.committed_ops:
        assert kind == "insert"
        twin.insert_docs(payload)
    _assert_same_graph(live.graph, twin.graph)
    _assert_same_retrieval(live, twin, QUERIES)


def test_background_ingest_with_removal_barrier():
    """remove() seals the current burst; replaying the committed op
    log in order reproduces the live index bitwise."""
    live = _rag()
    live.insert_docs(_docs(8))
    svc = IngestService(live, docs_per_tick=2, embed_batch=4)
    svc.submit_many(_docs(6, start=8))
    svc.remove(["d1", "d9"])
    svc.submit_many(_docs(6, start=14))
    stages = []
    while not svc.idle:
        stages.append(svc.tick())
    assert [k for k, _ in svc.committed_ops] == \
        ["insert", "remove", "insert"]
    assert stages.count("commit") == 2 and stages.count("remove") == 1
    twin = _rag()
    twin.insert_docs(_docs(8))
    for kind, payload in svc.committed_ops:
        (twin.insert_docs if kind == "insert"
         else twin.remove_docs)(payload)
    _assert_same_graph(live.graph, twin.graph)
    _assert_same_retrieval(live, twin, QUERIES)
    assert not any(n.doc_id in ("d1", "d9")
                   for n in live.graph.nodes.values() if n.layer == 0)


@pytest.mark.parametrize("embed_batch", [1, 3, 64])
def test_ingest_sub_batch_embedding_matches_one_shot(embed_batch):
    """Tiny embed quanta (many per-tick encoder and hash calls) still
    equal the synchronous single-encode path bitwise."""
    live = _rag()
    svc = IngestService(live, docs_per_tick=1, embed_batch=embed_batch)
    svc.submit_many(_docs(7))
    svc.drain()
    twin = _rag()
    twin.insert_docs(_docs(7))
    _assert_same_graph(live.graph, twin.graph)


def test_ingest_queue_bound_backpressure():
    live = _rag()
    svc = IngestService(live, max_pending_docs=4)
    svc.submit_many(_docs(4))
    with pytest.raises(IngestQueueFull):
        svc.submit("dx", "overflow text")
    assert svc.stats.backpressure == 1
    svc.drain()
    svc.submit("dx", "now there is room again.")   # drained -> accepts
    assert svc.pending_docs == 1


def test_ingest_knob_zero_rejected_not_defaulted():
    live = _rag()
    for kw in ({"max_pending_docs": 0}, {"docs_per_tick": 0},
               {"embed_batch": 0}, {"max_pending_ops": 0},
               {"docs_per_tick": -2}):
        with pytest.raises(ValueError):
            IngestService(live, **kw)
    # None still means "use the config default"
    svc = IngestService(live)
    assert svc.max_pending_docs == CFG.ingest_max_pending_docs
    assert svc.docs_per_tick == CFG.ingest_docs_per_tick
    assert svc.embed_batch == CFG.ingest_embed_batch
    assert svc.max_pending_ops == CFG.ingest_max_pending_ops


def test_ingest_config_validates_pending_ops():
    with pytest.raises(ValueError):
        dataclasses.replace(CFG, ingest_max_pending_ops=0)


def test_remove_backpressure_bounds_op_queue():
    live = _rag()
    svc = IngestService(live, max_pending_ops=4)
    with pytest.raises(IngestQueueFull):
        for i in range(3 * 4):
            svc.submit(f"bp{i}", f"text for doc {i}.")
            svc.remove([f"bp{i}"])
    assert svc.pending_ops <= 4
    svc.drain()
    svc.remove(["bp0"])                 # drained -> accepts again
    assert svc.pending_ops == 1


def test_drain_exhaustion_raises_not_silent():
    live = _rag()
    svc = IngestService(live, docs_per_tick=1, embed_batch=1)
    svc.submit_many(_docs(5))
    with pytest.raises(IngestDrainExhausted):
        svc.drain(max_ticks=2)
    assert not svc.idle                 # work really is still queued
    n = svc.drain()                     # unbounded drain finishes
    assert n > 0 and svc.idle
    twin = _rag()
    twin.insert_docs(_docs(5))
    _assert_same_graph(live.graph, twin.graph)


def test_idle_tick_refreshes_and_duplicates_skip_embedding():
    live = _rag()
    live.insert_docs(_docs(4))
    svc = IngestService(live)
    refreshes = live.store.stats.refreshes
    assert svc.tick() == "idle"
    assert svc.stats.idle_ticks == 1 and svc.stats.ticks == 1
    # the graph is ahead of the store: the idle tick's refresh syncs it
    assert live.store.stats.refreshes == refreshes + 1
    # every chunk of a resubmitted document is already in the graph:
    # the embed tick prepares nothing and launches no hash
    calls = _count_hash_calls(live)
    svc.submit_many(_docs(2))
    assert [svc.tick() for _ in range(3)] == ["chunk", "embed", "commit"]
    assert calls == [] and svc.stats.embed_launches == 0
    assert svc.report()["pending_docs"] == 0


def test_remove_docs_is_idempotent_and_complete():
    rag = _rag()
    rag.insert_docs(_docs(12))
    rep = rag.remove_docs(["d3", "d4"])
    assert rep.n_removed_chunks > 0
    assert not any(n.doc_id in ("d3", "d4")
                   for n in rag.graph.nodes.values() if n.layer == 0)
    again = rag.remove_docs(["d3", "d4", "not-a-doc"])
    assert again.n_removed_chunks == 0
    for q in QUERIES:
        assert all(rag.graph.nodes[h.node_id].doc_id
                   not in ("d3", "d4")
                   for h in rag.query(q).hits
                   if rag.graph.nodes[h.node_id].layer == 0)


# ---------------------------------------------------------------------------
# the JAX package against the port on one script
# ---------------------------------------------------------------------------

def _script(rag, svc_cls, clock=None):
    """A build, then bursts, a removal barrier and a duplicate
    submission through the service with queries between ticks; returns
    the tick stages."""
    rag.insert_docs(_docs(8))
    svc = svc_cls(rag, docs_per_tick=3, embed_batch=5)
    svc.tracer = rag.obs.tracer
    svc.submit_many(_docs(7, start=8))
    svc.remove(["d2", "d10"])
    svc.submit_many(_docs(4, start=15) + _docs(1, start=3))
    stages = []
    while not svc.idle:
        stages.append(svc.tick())
        rag.query_batch(QUERIES[:2])
    stages.append(svc.tick())           # one idle tick
    return svc, stages


def _store_state(store):
    st = store.state_dict()
    shards = st["shards"] if "shards" in st else [st["shard"]]
    return [(np.asarray(s["buf"]).tobytes(), list(s["row_ids"]),
             np.asarray(s["row_seq"]).tobytes(),
             np.asarray(s["alive"]).tobytes()) for s in shards]


@pytest.mark.parametrize("shards", [1, 2])
def test_ingest_script_matches_reference(shards):
    kw = dict(KW, index_shards=shards)
    jax_rag = JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=32))
    port = EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=32),
                  device="cpu")
    jsvc, jstages = _script(jax_rag, JaxIngestService)
    psvc, pstages = _script(port, IngestService)
    assert pstages == jstages
    assert {"chunk", "embed", "commit", "remove", "idle"} <= set(pstages)
    assert psvc.committed_ops == jsvc.committed_ops
    assert psvc.stats.to_dict() == jsvc.stats.to_dict()
    assert psvc.report() == jsvc.report()
    assert list(port.graph.nodes) == list(jax_rag.graph.nodes)
    for nid, n in port.graph.nodes.items():
        assert n.key == jax_rag.graph.nodes[nid].key
        assert np.array_equal(n.embedding,
                              jax_rag.graph.nodes[nid].embedding)
    jax_rag.store.refresh()
    port.store.refresh()
    assert _store_state(port.store) == _store_state(jax_rag.store)
    for q in QUERIES:
        rj, rp = jax_rag.query(q), port.query(q)
        assert [h.node_id for h in rj.hits] == \
            [h.node_id for h in rp.hits]
        assert rj.context == rp.context


def test_ingest_tick_spans_match_reference():
    """Traced ticks (chunk, embed, commit with the graph's nested
    update spans, remove, idle) record the same spans in both packages
    under a manual clock."""
    kw = dict(KW, obs_trace=True)
    rows = []
    for rag, svc_cls, clock, use in (
            (JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=32)),
             JaxIngestService, JaxClock, jax_use_clock),
            (EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=32),
                    device="cpu"), IngestService, ManualClock, use_clock)):
        with use(clock(tick=1.0)):
            _script(rag, svc_cls)
        rows.append([(s.name, s.depth, s.duration,
                      sorted(s.attrs.items()))
                     for s in rag.obs.tracer.spans])
    assert rows[0] == rows[1]
    stages = [a for name, _, _, attrs in rows[1] if name == "ingest_tick"
              for k, a in attrs if k == "stage"]
    assert {"chunk", "embed", "commit", "remove", "idle"} <= set(stages)
