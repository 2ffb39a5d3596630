"""The LM summarizer and the LM reader of the port against the JAX
package's, on the CPU.

Both packages' engines run the JAX ``make_test_engine`` recipe on the
same weights (carried over with ``params_from_numpy``), and every
engine of the port is held launch by launch to its reference twin
(``test_torch_serving.Launches``: logits within 2e-6, every greedy
margin above it).  ``LMSummarizer`` through ``EraRAG`` build, growth
and removal gives the reference's node ids, summaries and
``UpdateReport`` tokens under both ``batch_summaries`` settings;
``RAGPipeline(engine=)`` gives its answers, contexts and report;
streaming ingest with an ``LMSummarizer`` batches its summaries.
"""
import jax
import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.core.summarize import LMSummarizer as JaxLMSummarizer
from repro.data.corpus import SyntheticCorpus as JaxCorpus
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.serving.rag_pipeline import RAGPipeline as JaxPipeline
from jax_engines import jax_engine
from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.summarize import LMSummarizer
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.ingest import IngestService
from repro_torch.serving.rag_pipeline import RAGPipeline
from repro_torch.serving.testing import make_test_engine
from test_torch_index_report import EXCEPTED, _leaves
from test_torch_serving import Launches
from torch_threads import one_blas_thread  # noqa: F401

# the JAX ingest suite's configuration (tests/test_ingest.py)
INGEST_KW = dict(embed_dim=32, n_hyperplanes=8, s_min=2, s_max=4,
                 max_layers=3, chunk_tokens=16, top_k=6, token_budget=512)
# the JAX caching suite's configuration (tests/test_caching.py)
CACHE_KW = dict(embed_dim=64, n_hyperplanes=8, s_min=3, s_max=9,
                max_layers=2, chunk_tokens=32, top_k=4, token_budget=256,
                query_cache=True, query_cache_size=64)
# the JAX serving suite's configuration (tests/test_serving_batch.py)
SERVE_KW = dict(embed_dim=64, n_hyperplanes=10, s_min=3, s_max=9,
                max_layers=3, chunk_tokens=32, top_k=6, token_budget=512)


def _docs(n, start=0):
    return [(f"d{i}", f"doc {i} alpha beta gamma. topic {i % 4} body "
                      f"text here. more words follow {i}.")
            for i in range(start, start + n)]


@pytest.fixture(scope="module")
def recipe_tree():
    return jax.tree.map(np.asarray, jax_engine().params)


@pytest.fixture
def twins(recipe_tree):
    """``make(**kw) -> (jax engine, port engine)`` on the recipe's
    weights; ``check()`` holds every pair made so far launch by
    launch."""
    pairs = []

    def make(**kw):
        je = jax_engine(**kw)
        pe = make_test_engine(device="cpu", params=recipe_tree, **kw)
        pairs.append((Launches(je, port=False), Launches(pe, port=True)))
        return je, pe

    def check():
        for want, got in pairs:
            got.assert_matches(want)

    make.check = check
    return make


def _assert_same_graph(a, b):
    assert list(a.nodes) == list(b.nodes)
    for nid, na in a.nodes.items():
        nb = b.nodes[nid]
        assert (na.text, na.n_tokens, na.key, na.layer) == \
            (nb.text, nb.n_tokens, nb.key, nb.layer)


def _tokens(rag):
    return [(r.tokens_in, r.tokens_out, r.n_resummarized)
            for r in rag.reports]


@pytest.mark.parametrize("batched", [True, False])
def test_lm_summarizer_matches_reference(twins, batched):
    """Build, a growth round and a removal with an LM summarizer: node
    ids (content hashes), summaries and update tokens equal the
    reference's, and so do the engines' stats."""
    kw = dict(INGEST_KW, batch_summaries=batched, summary_cache_size=0)
    je, pe = twins(max_batch=8, max_seq_len=64, max_new_tokens=4)
    jax_rag = JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=32),
                     summarizer=JaxLMSummarizer(engine=je, max_tokens=4))
    port = EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=32),
                  summarizer=LMSummarizer(engine=pe, max_tokens=4),
                  device="cpu")
    for rag in (jax_rag, port):
        rag.insert_docs(_docs(12))
        rag.insert_docs(_docs(6, start=12))
        rag.remove_docs(["d3"])
    _assert_same_graph(jax_rag.graph, port.graph)
    assert any(n.layer > 0 and n.text.startswith("tok")
               for n in port.graph.nodes.values())
    assert _tokens(port) == _tokens(jax_rag)
    assert port.graph.stats == jax_rag.graph.stats
    assert pe.stats == je.stats
    n_segments = sum(r.n_resummarized for r in port.reports)
    if not batched:
        assert pe.stats["generate_batches"] == n_segments
    twins.check()


def test_lm_summarizer_declares_prompt_prefix(twins):
    """The instruction block rides the KV prefix cache: segments after
    the first admission wave re-prefill only their passages."""
    kw = dict(INGEST_KW, summary_cache_size=0)
    je, pe = twins(max_batch=2, max_seq_len=64, max_new_tokens=4,
                   prefix_cache_entries=2)
    rags = [cls(cfg(**kw), emb(dim=32),
                summarizer=summ(engine=eng, max_tokens=4), **extra)
            for cls, cfg, emb, summ, eng, extra in (
                (JaxRAG, JaxConfig, JaxEmbedder, JaxLMSummarizer, je, {}),
                (EraRAG, EraRAGConfig, HashingEmbedder, LMSummarizer, pe,
                 {"device": "cpu"}))]
    for rag in rags:
        rag.insert_docs(_docs(10))
    _assert_same_graph(rags[0].graph, rags[1].graph)
    assert pe.stats == je.stats and pe.stats["prefix_hits"] > 0
    twins.check()


def test_ingest_batches_lm_summaries(recipe_tree):
    """The JAX ingest suite's batched-summarization test through
    ``IngestService``: an LM-summarized burst gives the same graph
    batched and serial (and the same as the reference's synchronous
    insert), the batched one in at most half the ``generate_batch``
    calls and half the launches."""
    jax_rag = JaxRAG(JaxConfig(**INGEST_KW), JaxEmbedder(dim=32),
                     summarizer=JaxLMSummarizer(
                         engine=jax_engine(max_batch=8, max_seq_len=64,
                                           max_new_tokens=4),
                         max_tokens=4))
    jax_rag.insert_docs(_docs(12))
    cfgs = {True: EraRAGConfig(**INGEST_KW),
            False: EraRAGConfig(**dict(INGEST_KW, batch_summaries=False,
                                       summary_cache_size=0))}
    rags, engines = {}, {}
    for batched, cfg in cfgs.items():
        eng = make_test_engine(max_batch=8, max_seq_len=64,
                               max_new_tokens=4, device="cpu",
                               params=recipe_tree)
        rag = EraRAG(cfg, HashingEmbedder(dim=32),
                     summarizer=LMSummarizer(engine=eng, max_tokens=4),
                     device="cpu")
        svc = IngestService(rag)
        svc.submit_many(_docs(12))
        while not svc.idle:
            svc.tick()
        rags[batched], engines[batched] = rag, eng
    _assert_same_graph(rags[True].graph, rags[False].graph)
    _assert_same_graph(jax_rag.graph, rags[True].graph)
    n_segments = sum(r.n_resummarized for r in rags[False].reports)
    assert n_segments >= 4
    assert engines[False].stats["generate_batches"] == n_segments
    assert engines[True].stats["generate_batches"] <= n_segments // 2
    assert engines[True].launches * 2 <= engines[False].launches


@pytest.fixture(scope="module")
def served():
    """Both packages' indexes over the JAX serving suite's corpus."""
    out = {}
    for name, rag in (
            ("jax", JaxRAG(JaxConfig(**SERVE_KW), JaxEmbedder(dim=64))),
            ("port", EraRAG(EraRAGConfig(**SERVE_KW),
                            HashingEmbedder(dim=64), device="cpu"))):
        corpus = (JaxCorpus if name == "jax" else SyntheticCorpus
                  ).generate(n_docs=24, n_topics=4, seed=0)
        rag.insert_docs(corpus.docs)
        out[name] = rag
    return out, corpus


def _mixed_multihop_block(corpus):
    """Two genuine two-hop questions, one whose bridge cannot be found
    (short-circuits after round 1), and two plain questions."""
    hop = [qa.question for qa in corpus.qa if qa.kind == "multihop"][:2]
    missing = "What is the color of the partner of ent_missing?"
    plain = [qa.question for qa in corpus.qa if qa.kind == "detailed"][:2]
    return hop + [missing] + plain


def _same_answers(a, b):
    assert [(x.answer, x.context, x.hits, x.n_context_tokens) for x in a] \
        == [(x.answer, x.context, x.hits, x.n_context_tokens) for x in b]


def test_lm_reader_matches_reference(served, twins):
    """``answer_batch`` (one generate_batch) and ``answer`` (one-slot
    oracle) give the reference's answers, and equal each other."""
    rags, corpus = served
    questions = [qa.question for qa in corpus.qa[:6]]
    je, pe = twins(max_batch=6, max_new_tokens=4)
    jo, po = twins(max_batch=1, max_new_tokens=4)
    out = {}
    for name, pipes in (("jax", (JaxPipeline(rags["jax"], engine=je),
                                 JaxPipeline(rags["jax"], engine=jo))),
                        ("port", (RAGPipeline(rags["port"], engine=pe),
                                  RAGPipeline(rags["port"], engine=po)))):
        out[name] = (pipes[0].answer_batch(questions),
                     [pipes[1].answer(q) for q in questions])
    _same_answers(out["port"][0], out["jax"][0])
    _same_answers(out["port"][1], out["jax"][1])
    _same_answers(out["port"][0], out["port"][1])
    assert pe.stats["generate_batches"] == 1
    assert (pe.stats, po.stats) == (je.stats, jo.stats)
    twins.check()


def test_lm_multihop_matches_reference(served, twins):
    """The batched multihop block costs exactly two ``generate_batch``
    calls and two retrieval rounds, and equals the reference's and the
    sequential oracle's answers."""
    rags, corpus = served
    block = _mixed_multihop_block(corpus)
    je, pe = twins(max_batch=len(block), max_new_tokens=4)
    jo, po = twins(max_batch=1, max_new_tokens=4)
    out = {}
    for name, pipe_cls, eng, oracle in (("jax", JaxPipeline, je, jo),
                                        ("port", RAGPipeline, pe, po)):
        rag = rags[name]
        before = rag.stats["retrieval_rounds"]
        batched = pipe_cls(rag, engine=eng).answer_batch(block,
                                                         mode="multihop")
        rounds = rag.stats["retrieval_rounds"] - before
        single = [pipe_cls(rag, engine=oracle).answer(q, mode="multihop")
                  for q in block]
        out[name] = (batched, single, rounds)
    _same_answers(out["port"][0], out["jax"][0])
    _same_answers(out["port"][1], out["jax"][1])
    assert [a.answer for a in out["port"][0]] == \
        [a.answer for a in out["port"][1]]
    assert out["port"][2] == out["jax"][2] == 2
    assert pe.stats["generate_batches"] == 2
    assert (pe.stats, po.stats) == (je.stats, jo.stats)
    twins.check()


def test_pipeline_with_both_caches_matches_cold_and_reference(twins):
    """The JAX caching suite's end-to-end case: on one index with the
    query cache on, a pipeline with the KV prefix cache answers as a
    cold one did; and its index report equals the reference's outside
    ``EXCEPTED``, its ``prefix_cache`` and ``launches.engine`` sections
    included."""
    kw = dict(CACHE_KW, token_budget=24, chunk_tokens=16, obs_trace=True)
    reports, answers = [], {}
    engines = [twins(max_batch=2), twins(max_batch=2,
                                         prefix_cache_entries=4)]
    for name, rag_cls, cfg_cls, emb, corpus_cls, pipe_cls in (
            ("jax", JaxRAG, JaxConfig, JaxEmbedder, JaxCorpus, JaxPipeline),
            ("port", EraRAG, EraRAGConfig, HashingEmbedder, SyntheticCorpus,
             RAGPipeline)):
        extra = {"device": "cpu"} if name == "port" else {}
        corpus = corpus_cls.generate(n_docs=12, n_topics=3, seed=0)
        questions = [corpus.qa[0].question, corpus.qa[1].question] * 2
        rag = rag_cls(cfg_cls(**kw), emb(dim=64), **extra)
        rag.insert_docs(corpus.docs)
        pick = 1 if name == "port" else 0
        cold = pipe_cls(rag, engine=engines[0][pick])
        warm = pipe_cls(rag, engine=engines[1][pick])
        a, b = cold.answer_batch(questions), warm.answer_batch(questions)
        assert [x.answer for x in a] == [x.answer for x in b]
        answers[name] = [x.answer for x in b]
        report = warm.index_report()
        assert report["prefix_cache"]["hits"] > 0
        assert report["query_cache"]["hits"] > 0
        reports.append(report)
    assert answers["port"] == answers["jax"]
    want, got = (_leaves(r) for r in reports)
    assert set(got) == set(want)
    differ = {k for k in got if got[k] != want[k]}
    assert differ <= EXCEPTED, sorted(differ - EXCEPTED)
    assert reports[1]["launches"]["engine"]["generate_batches"] == 1
    twins.check()


# ---------------------------------------------------------------------------
# the same with an MoE LM (the MoE engine recipe of test_torch_moe.py)
# ---------------------------------------------------------------------------
@pytest.fixture
def moe_twins():
    """``make(**kw) -> (jax engine, port engine)`` on the deepseek-style
    MoE recipe; ``check()`` holds every pair launch by launch."""
    from test_torch_moe import _engines
    checks = []

    def make(**kw):
        je, pe, check = _engines("deepseek", **kw)
        checks.append(check)
        return je, pe

    make.check = lambda: [c() for c in checks]
    return make


def test_moe_lm_summarizer_matches_reference(moe_twins):
    """Build, a growth round and a removal with an MoE LM summarizer
    (batched): node ids, summaries, update tokens and the engines'
    stats equal the reference's."""
    kw = dict(INGEST_KW, summary_cache_size=0)
    je, pe = moe_twins(max_batch=8, max_seq_len=64, max_new_tokens=4)
    assert pe.cfg.is_moe
    jax_rag = JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=32),
                     summarizer=JaxLMSummarizer(engine=je, max_tokens=4))
    port = EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=32),
                  summarizer=LMSummarizer(engine=pe, max_tokens=4),
                  device="cpu")
    for rag in (jax_rag, port):
        rag.insert_docs(_docs(12))
        rag.insert_docs(_docs(6, start=12))
        rag.remove_docs(["d3"])
    _assert_same_graph(jax_rag.graph, port.graph)
    assert any(n.layer > 0 and n.text.startswith("tok")
               for n in port.graph.nodes.values())
    assert _tokens(port) == _tokens(jax_rag)
    assert pe.stats == je.stats
    moe_twins.check()


def test_moe_lm_reader_matches_reference(served, moe_twins):
    """An MoE LM reader: ``answer_batch`` and a multihop block give the
    reference's answers (a launch's rows share expert capacity, so a
    batch and one-at-a-time answers may differ, in both packages
    alike)."""
    rags, corpus = served
    questions = [qa.question for qa in corpus.qa[:6]]
    block = _mixed_multihop_block(corpus)
    je, pe = moe_twins(max_batch=6, max_new_tokens=4)
    out = {}
    for name, pipe in (("jax", JaxPipeline(rags["jax"], engine=je)),
                       ("port", RAGPipeline(rags["port"], engine=pe))):
        out[name] = (pipe.answer_batch(questions),
                     pipe.answer_batch(block, mode="multihop"))
    for got, want in zip(out["port"], out["jax"]):
        _same_answers(got, want)
    assert pe.stats == je.stats and pe.stats["generate_batches"] == 3
    moe_twins.check()
