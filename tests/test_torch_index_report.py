"""``RAGPipeline.index_report``, the obs registry (``obs/metrics.py``,
``obs/schema.py``) and the load report (``lifecycle/report.py``) of the
PyTorch port, on the CPU.

The report of one serving script (a build, an attached
``IngestService`` with bursts and a removal ticked between
``answer_batch`` calls, the query cache on) must equal the JAX
package's, key for key and value for value, with the keys in
``EXCEPTED`` the only differences.  The registry cases are the port's
counterparts of ``tests/test_obs.py``: exact percentiles, collectors as
live views, the Prometheus text, the schema drift check, and the
report's numbers against the live objects.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.ingest import IngestService as JaxIngestService
from repro.kernels.mips_topk import ops as jax_mips_ops
from repro.obs.metrics import global_registry as jax_global_registry
from repro.serving.rag_pipeline import RAGPipeline as JaxPipeline

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.ingest import IngestService
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.lifecycle.report import ShardLoadReport
from repro_torch.obs import (Histogram, MetricsRegistry, NULL_TRACER,
                             global_registry)
from repro_torch.obs.schema import (INDEX_REPORT_SCHEMA, flatten_numeric,
                                    undeclared)
from repro_torch.serving.rag_pipeline import RAGPipeline
from torch_threads import one_blas_thread  # noqa: F401

KW = dict(embed_dim=32, n_hyperplanes=8, s_min=2, s_max=4, max_layers=3,
          chunk_tokens=16, top_k=6, token_budget=512)
CFG = EraRAGConfig(**KW)

# Report keys whose values differ by design, each with its reason.
# Every other key, numeric or not, must be equal.
EXCEPTED = {
    # a shard's placement: the port's sharded store places every slot
    # on its device ("cpu" here, "cuda:0" on the card); the JAX
    # package's mesh-free store has no placement and reports None
    "load.shards.*.device",
    "shards.*.device",
}


def _mk_emb(pkg_embedder):
    return pkg_embedder(dim=32, n_features=512, seed=0)


def _corpus(n=10, seed=5):
    return SyntheticCorpus.generate(n_docs=n, seed=seed)


def _rag(cfg=CFG, corpus=None):
    rag = EraRAG(cfg, _mk_emb(HashingEmbedder), device="cpu")
    rag.insert_docs((corpus or _corpus()).docs)
    rag.store.refresh()
    return rag


def _leaves(obj, prefix=""):
    """Every leaf (numeric or not) as a dotted path, list indices
    normalized to ``*`` and the values listed in order."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            for kk, vv in _leaves(v, f"{prefix}.{k}" if prefix
                                  else str(k)).items():
                out.setdefault(kk, []).extend(vv)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            for kk, vv in _leaves(v, f"{prefix}.*").items():
                out.setdefault(kk, []).extend(vv)
    else:
        out[prefix] = [obj]
    return out


def _serve(rag, pipe_cls, svc_cls, corpus):
    """The serving script: answer, ingest with ticks between batches,
    answer again; returns the pipeline."""
    svc = svc_cls(rag, docs_per_tick=2, embed_batch=4)
    pipe = pipe_cls(rag, ingest=svc)
    qs = [qa.question for qa in corpus.qa][:6]
    pipe.answer_batch(qs)
    svc.submit_many(corpus.docs[5:])
    svc.remove([corpus.docs[1][0]])
    while not svc.idle:
        svc.tick()
        pipe.answer_batch(qs[:3])
    pipe.answer_batch(qs)
    return pipe


@pytest.mark.parametrize("shards,quantized", [(1, False), (2, False),
                                              (1, True), (2, True)])
def test_index_report_matches_reference(shards, quantized):
    kw = dict(KW, obs_trace=True, query_cache=True, index_shards=shards,
              quantized_scan=quantized)
    corpus = _corpus()
    reports = []
    for rag, pipe_cls, svc_cls in (
            (JaxRAG(JaxConfig(**kw), _mk_emb(JaxEmbedder)), JaxPipeline,
             JaxIngestService),
            (EraRAG(EraRAGConfig(**kw), _mk_emb(HashingEmbedder),
                    device="cpu"), RAGPipeline, IngestService)):
        rag.insert_docs(corpus.docs[:5])
        rag.store.refresh()
        reports.append(_serve(rag, pipe_cls, svc_cls, corpus)
                       .index_report())
    want, got = (_leaves(r) for r in reports)
    assert set(got) == set(want)
    differ = {k for k in got if got[k] != want[k]}
    assert differ <= EXCEPTED, sorted(differ - EXCEPTED)
    if shards > 1:
        assert differ == EXCEPTED
        assert set(got["shards.*.device"]) == {"cpu"}
    assert undeclared(reports[1]) == []
    assert {"query_cache", "ingest", "launches", "obs"} <= set(reports[1])


def test_merge_launch_counter_divergence():
    """The one recorded divergence of the exported launch counters: the
    JAX package counts the sharded merge on
    ``kernels.mips_topk.launches``; the port counts CUDA kernel
    launches only there (none on the CPU) and the merge on its own
    ``kernels.mips_topk.merge.launches``.  ``StoreStats.kernel_launches``
    (the report's ``launches.store.kernel_launches``) is equal."""
    kw = dict(KW, index_shards=2)
    corpus = _corpus()
    qs = [qa.question for qa in corpus.qa][:5]
    jax_rag = JaxRAG(JaxConfig(**kw), _mk_emb(JaxEmbedder))
    port = EraRAG(EraRAGConfig(**kw), _mk_emb(HashingEmbedder),
                  device="cpu")
    for rag in (jax_rag, port):
        rag.insert_docs(corpus.docs)
        rag.store.refresh()
    jax_before = jax_mips_ops.launch_count()
    mips_ops.reset_launch_count()
    for rag in (jax_rag, port):
        rag.query_batch(qs)
        rag.query_batch(qs, mode="detailed")
    jax_launches = jax_mips_ops.launch_count() - jax_before
    merges = mips_ops.merge_launch_count()
    assert port.store.stats.kernel_launches == \
        jax_rag.store.stats.kernel_launches == jax_launches
    assert merges == 3            # one a search: collapsed 1, detailed 2
    assert mips_ops.launch_count() == 0
    prom = global_registry().to_prometheus()
    assert f"kernels_mips_topk_merge_launches {merges}" in prom
    assert "kernels_mips_topk_launches 0" in prom
    assert "merge" not in jax_global_registry().to_prometheus()


# -- registry instruments ----------------------------------------------
def test_registry_instruments_and_percentiles():
    reg = MetricsRegistry()
    c = reg.counter("a.b")
    c.inc()
    c.inc(4)
    assert reg.counter("a.b") is c and c.count == 5
    c.reset()
    assert c.count == 0
    g = reg.gauge("a.g")
    g.set(2.5)
    assert reg.gauge("a.g").value == 2.5

    h = reg.histogram("lat")
    rng = np.random.Generator(np.random.PCG64(0))
    xs = rng.uniform(1e-4, 2.0, size=257)
    for x in xs:
        h.observe(float(x))
    # exact: identical to np.percentile over everything observed
    for q in (50, 90, 99):
        assert h.percentile(q) == float(np.percentile(xs, q))
    assert h.count == len(xs) and sum(h.bucket_counts) == h.count
    assert h.sum == pytest.approx(float(xs.sum()))
    assert Histogram("empty").percentile(50) == 0.0


def test_histogram_buckets_and_samples_match_reference():
    from repro.obs.metrics import Histogram as JaxHistogram
    rng = np.random.Generator(np.random.PCG64(1))
    xs = np.concatenate([rng.uniform(0, 3.0, 300), [1e-4, 0.2, 250.0]])
    for buckets in (None, (0.01, 0.1, 1.0)):
        a, b = Histogram("h", buckets), JaxHistogram("h", buckets)
        for x in xs:
            a.observe(float(x))
            b.observe(float(x))
        assert (a.bounds, a.bucket_counts, a.count, a.sum) == \
            (b.bounds, b.bucket_counts, b.count, b.sum)
        for q in (0, 25, 50, 99.9, 100):
            assert a.percentile(q) == b.percentile(q)


def test_registry_collectors_snapshot_and_prometheus():
    reg = MetricsRegistry()
    reg.counter("hits").inc(3)
    reg.histogram("lat").observe(0.25)
    state = {"n": 7}
    reg.register_collector("sub", lambda: {"deep": {"n": state["n"]}})
    snap = reg.snapshot()
    assert snap["hits"] == 3 and snap["sub.deep.n"] == 7
    state["n"] = 9           # collectors are live views, not copies
    assert reg.snapshot()["sub.deep.n"] == 9
    assert reg.collect("missing") == {}

    prom = reg.to_prometheus()
    assert "# TYPE hits counter\nhits 3" in prom
    assert "# TYPE lat histogram" in prom
    assert 'lat_bucket{le="+Inf"} 1' in prom and "lat_count 1" in prom
    assert "sub_deep_n 9" in prom


def test_prometheus_text_matches_reference():
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    regs = (MetricsRegistry(), JaxRegistry())
    for reg in regs:
        reg.counter("store.refreshes").inc(4)
        reg.gauge("queue-depth").set(1.5)
        h = reg.histogram("serving.latency.query")
        for x in (0.0003, 0.02, 0.02, 7.0):
            h.observe(x)
        reg.register_collector("launches", lambda: {
            "store": {"kernel_launches": 12}, "xs": [{"v": 2}]})
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].snapshot() == regs[1].snapshot()


def test_flatten_numeric_normalizes_lists_and_skips_nonnumeric():
    flat = flatten_numeric({"a": {"b": 1}, "xs": [{"v": 2}, {"v": 3}],
                            "s": "str", "f": True, "z": None})
    assert flat == {"a.b": 1, "xs.*.v": 3}
    assert undeclared({"size": 1, "bogus": {"leaf": 2}}) == \
        ["bogus.leaf"]


def test_schema_is_the_reference_schema():
    from repro.obs.schema import INDEX_REPORT_SCHEMA as JAX_SCHEMA
    assert INDEX_REPORT_SCHEMA == JAX_SCHEMA


# -- index_report ------------------------------------------------------
def test_index_report_schema_drift_check():
    """Every numeric key the fully-loaded report surfaces must be
    declared, the LM engine's sections included; an undeclared counter
    is exactly what this gate is for."""
    from repro_torch.serving.testing import make_test_engine
    corpus = _corpus(n=8)
    cfg = dataclasses.replace(
        CFG, index_shards=2, query_cache=True, quantized_scan=True,
        obs_trace=True, token_budget=192)
    rag = _rag(cfg, corpus)
    engine = make_test_engine(max_batch=4, max_seq_len=256,
                              max_new_tokens=3, seed=0,
                              prefix_cache_entries=4, device="cpu")
    svc = IngestService(rag)
    pipe = RAGPipeline(rag, engine=engine, ingest=svc)
    pipe.answer_batch([qa.question for qa in corpus.qa][:3])
    rep = pipe.index_report()
    assert undeclared(rep) == []
    assert "prefix_cache" in rep and "engine" in rep["launches"]
    assert rep["launches"]["store"]["kernel_launches"] >= 1
    assert rag.obs.registry.declared == INDEX_REPORT_SCHEMA
    # the check actually fires on a novel counter
    rep["launches"]["store"]["new_counter"] = 1
    assert undeclared(rep) == ["launches.store.new_counter"]
    # registry exposition walks the same collectors without error
    prom = rag.obs.registry.to_prometheus()
    assert "launches_store_kernel_launches" in prom
    assert "launches_engine_generate_batches" in prom


def test_index_report_values_match_live_objects():
    """The registry view must report the same numbers the owning
    objects hold — collectors are views, not copies."""
    corpus = _corpus(n=8)
    rag = _rag(dataclasses.replace(CFG, query_cache=True), corpus)
    pipe = RAGPipeline(rag)
    qs = [qa.question for qa in corpus.qa][:4]
    pipe.answer_batch(qs)
    pipe.answer_batch(qs)              # repeat: cache hits
    rep = pipe.index_report()
    assert rep["size"] == rag.store.size
    assert rep["epoch"] == rag.store.epoch
    assert rep["retrieval_rounds"] == rag.stats["retrieval_rounds"]
    assert rep["launches"]["retrieval_rounds"] == \
        rag.stats["retrieval_rounds"]
    assert rep["query_cache"] == rag.query_cache.stats.to_dict()
    assert rep["query_cache"]["hits"] > 0
    assert rep["stats"]["kernel_launches"] == \
        rag.store.stats.kernel_launches
    assert rep["launches"]["embedder"] == rag.graph.embedder.stats
    assert rep["launches"]["summarizer"] == rag.graph.stats
    assert rep["launches"]["summarizer"]["summarize_launches"] > 0
    assert rep["load"] == ShardLoadReport.from_store(rag.store).to_dict()
    assert rep["load"]["routing"] == rag.store.routing_cache_info()


def test_load_report_of_a_sharded_store():
    corpus = _corpus(n=10)
    rag = _rag(dataclasses.replace(CFG, index_shards=3), corpus)
    rag.query_batch([qa.question for qa in corpus.qa][:5])
    rag.remove_docs([corpus.docs[0][0]])
    store = rag.store
    # the report reads passively: it sees the graph's removal only
    # once a refresh has replayed it
    stale = ShardLoadReport.from_store(store)
    assert stale.dead == 0
    store.refresh()
    rep = ShardLoadReport.from_store(store)
    assert rep.n_shards == 3 and rep.epoch == store.epoch
    assert rep.size == store.size
    assert [s.rows for s in rep.shards] == \
        [sh.count - sh.n_dead for sh in store._shards]
    assert [s.query_hits for s in rep.shards] == \
        [int(h) for h in store.query_hits]
    assert sum(s.query_hits for s in rep.shards) == 5 * CFG.top_k
    assert rep.dead == sum(sh.n_dead for sh in store._shards) > 0
    assert rep.skew >= 1.0 and rep.migration is None
    assert rep.routing == store.routing_cache_info()
    assert rep.routing["misses"] > 0
    assert {s.device for s in rep.shards} == {"cpu"}


def test_index_report_ingest_section():
    rag = EraRAG(CFG, HashingEmbedder(dim=32), device="cpu")
    rag.insert_docs([(f"d{i}", f"doc {i} alpha beta. topic {i % 4} "
                               f"body text here.") for i in range(12)])
    pipe = RAGPipeline(rag)
    svc = IngestService(rag)
    pipe.attach_ingest(svc)
    svc.submit_many([(f"d{i}", f"doc {i} gamma. more words {i}.")
                     for i in range(12, 16)])
    svc.drain()
    rep = pipe.index_report()["ingest"]
    assert rep["summary_cache"]["misses"] > 0
    assert rep["summary_cache_entries"] == len(rag.graph.summary_cache)
    assert rep["service"]["committed_docs"] == 4
    assert rep["service"]["pending_docs"] == 0
    assert svc.tracer is rag.obs.tracer


# -- disabled path is bitwise inert ------------------------------------
def test_obs_disabled_is_bitwise_inert():
    """Counters-only default vs full tracing: identical answers,
    identical graphs through the streaming ingest path, and the
    default records zero spans."""
    corpus = _corpus(n=8)
    cfg_on = dataclasses.replace(CFG, obs_trace=True)
    rag_off = EraRAG(CFG, _mk_emb(HashingEmbedder), device="cpu")
    rag_on = EraRAG(cfg_on, _mk_emb(HashingEmbedder), device="cpu")
    pipes = []
    for rag in (rag_off, rag_on):
        rag.insert_docs(corpus.docs[:4])
        svc = IngestService(rag)
        svc.submit_many(corpus.docs[4:])
        svc.remove([corpus.docs[4][0]])
        svc.drain()
        rag.store.refresh()
        pipes.append(RAGPipeline(rag, ingest=svc))
    assert list(rag_off.graph.nodes) == list(rag_on.graph.nodes)
    for nid in rag_off.graph.nodes:
        assert np.array_equal(rag_off.graph.nodes[nid].embedding,
                              rag_on.graph.nodes[nid].embedding)
    qs = [qa.question for qa in corpus.qa][:6]
    a_off = [(a.answer, a.context, a.hits, a.epoch)
             for a in pipes[0].answer_batch(qs)]
    a_on = [(a.answer, a.context, a.hits, a.epoch)
            for a in pipes[1].answer_batch(qs)]
    assert a_off == a_on
    assert rag_off.obs.tracer is NULL_TRACER
    assert rag_off.obs.tracer.total_spans == 0
    assert not rag_off.obs.enabled and rag_on.obs.enabled
    assert rag_on.obs.tracer.total_spans > 0
    # the obs section only appears when tracing is on
    assert "obs" not in pipes[0].index_report()
    assert pipes[1].index_report()["obs"]["spans"] > 0


def test_query_span_tree_and_ingest_stage_spans():
    corpus = _corpus(n=8)
    rag = _rag(dataclasses.replace(CFG, obs_trace=True,
                                   query_cache=True), corpus)
    svc = IngestService(rag)
    pipe = RAGPipeline(rag, ingest=svc)
    pipe.answer_batch([qa.question for qa in corpus.qa][:4])
    tr = rag.obs.tracer
    [q] = [s for s in tr.roots() if s.name == "query"]
    kids = {s.name for s in tr.children(q)}
    assert kids == {"retrieve", "compose"}
    [ret] = [s for s in tr.spans if s.name == "retrieve"]
    rkids = {s.name for s in tr.children(ret)}
    assert {"embed", "cache_lookup", "route", "scan"} <= rkids
    assert ret.attrs["epoch"] == rag.store.epoch
    [scan] = [s for s in tr.spans if s.name == "scan"]
    assert scan.attrs["epoch"] == rag.store.epoch

    svc.submit("zz", "fresh doc text " * 6)
    while not svc.idle:
        svc.tick()
    svc.tick()                                   # one idle tick
    stages = [s.attrs["stage"] for s in tr.spans
              if s.name == "ingest_tick"]
    assert {"chunk", "embed", "commit", "idle"} <= set(stages)
