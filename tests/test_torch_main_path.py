"""The whole slice: the quickstart configuration (``examples/
quickstart.py``) through the JAX package and the PyTorch port on the
CPU, on the same seeded corpus.

Bitwise: node ids (content hashes), LSH keys, segments, per-round
``UpdateReport`` token counts, the store buffer, hit ids / layers /
seq, contexts and reader answers.  Scores: within 1e-5 (fp32 sums in
two libraries).  A JAX snapshot restored by the port must answer
identically, with no re-embedding.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.data.corpus import SyntheticCorpus
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.serving.rag_pipeline import RAGPipeline as JaxPipeline

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.serving.rag_pipeline import RAGPipeline
from torch_threads import one_blas_thread  # noqa: F401

SCORE_TOL = 1e-5
QUICKSTART = dict(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                  max_layers=3, chunk_tokens=32, top_k=8,
                  token_budget=1024)
MODES = ("collapsed", "detailed", "summarized", "multihop")
REPORT_COUNTS = ("n_new_chunks", "n_removed_chunks", "n_resummarized",
                 "n_affected_segments", "n_new_layers", "tokens_in",
                 "tokens_out", "summary_cache_hits",
                 "summary_tokens_saved")


def _build(n_docs, n_rounds):
    corpus = SyntheticCorpus.generate(n_docs=n_docs, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, n_rounds)
    jax_rag = JaxRAG(JaxConfig(**QUICKSTART),
                     JaxEmbedder(dim=QUICKSTART["embed_dim"]))
    port = EraRAG(EraRAGConfig(**QUICKSTART),
                  HashingEmbedder(dim=QUICKSTART["embed_dim"]),
                  device="cpu")
    reports = [(jax_rag.insert_docs(docs), port.insert_docs(docs))
               for docs in [init] + rounds]
    return corpus, jax_rag, port, reports


@pytest.fixture(scope="module")
def pair():
    return _build(60, 5)


def _report_counts(rep):
    return {f: getattr(rep, f) for f in REPORT_COUNTS}


def _assert_graphs_equal(ga, gb):
    assert list(ga.nodes) == list(gb.nodes)
    for nid, a in ga.nodes.items():
        b = gb.nodes[nid]
        assert (a.layer, a.key, a.children, a.text, a.doc_id,
                a.n_tokens) == (b.layer, b.key, b.children, b.text,
                                b.doc_id, b.n_tokens)
        np.testing.assert_array_equal(a.embedding, b.embedding)
    assert [list(d) for d in ga.layer_order] == \
        [list(d) for d in gb.layer_order]
    assert [[(s.members, s.min_key, s.parent) for s in segs]
            for segs in ga.segments] == \
        [[(s.members, s.min_key, s.parent) for s in segs]
         for segs in gb.segments]
    assert ga.version == gb.version
    assert ga.deltas_since(0) == gb.deltas_since(0)
    assert gb.check_integrity() == [] == ga.check_integrity()


def _assert_retrievals_equal(ra, rb):
    assert len(ra) == len(rb)
    for a, b in zip(ra, rb):
        assert [(h.node_id, h.layer, h.seq) for h in a.hits] == \
            [(h.node_id, h.layer, h.seq) for h in b.hits]
        np.testing.assert_allclose([h.score for h in b.hits],
                                   [h.score for h in a.hits],
                                   rtol=0, atol=SCORE_TOL)
        assert (a.context, a.n_tokens, a.epoch) == \
            (b.context, b.n_tokens, b.epoch)
        assert getattr(a, "hops", 1) == getattr(b, "hops", 1)
        assert getattr(a, "bridge_query", None) == \
            getattr(b, "bridge_query", None)


def test_build_and_growth_match(pair):
    _, jax_rag, port, reports = pair
    assert len(reports) == 6
    for rep_a, rep_b in reports:
        assert _report_counts(rep_a) == _report_counts(rep_b)
    assert sum(r.n_new_chunks for r, _ in reports) > 200
    assert port.graph.n_layers == jax_rag.graph.n_layers >= 2
    _assert_graphs_equal(jax_rag.graph, port.graph)
    assert port.total_tokens == jax_rag.total_tokens


def test_store_buffer_matches(pair):
    _, jax_rag, port, _ = pair
    a = jax_rag.store.state_dict()
    b = port.store.state_dict()
    assert (a["kind"], a["version"], a["next_seq"], a["quant"]) == \
        (b["kind"], b["version"], b["next_seq"], b["quant"])
    for key in ("buf", "row_layers", "row_seq", "alive"):
        np.testing.assert_array_equal(np.asarray(a["shard"][key]),
                                      b["shard"][key])
    assert a["shard"]["row_ids"] == b["shard"]["row_ids"]
    assert b["shard"]["buf"].shape[1] == QUICKSTART["embed_dim"] + 3
    assert port.store.size == jax_rag.store.size


@pytest.mark.parametrize("mode", MODES)
def test_hits_match_in_every_mode(pair, mode):
    corpus, jax_rag, port, _ = pair
    questions = [qa.question for qa in corpus.qa[:40]]
    questions += [qa.question for qa in corpus.qa
                  if qa.kind != "detailed"][:8]
    ra = jax_rag.query_batch(questions, mode=mode)
    rb = port.query_batch(questions, mode=mode)
    _assert_retrievals_equal(ra, rb)
    assert all(r.hits for r in rb)
    assert port.stats == jax_rag.stats
    assert vars(port.store.stats) == vars(jax_rag.store.stats)


def test_reader_answers_match(pair):
    corpus, jax_rag, port, _ = pair
    questions = [qa.question for qa in corpus.qa[:12]]
    questions += [qa.question for qa in corpus.qa
                  if qa.kind == "multihop"][:4]
    pa, pb = JaxPipeline(jax_rag), RAGPipeline(port)
    for q in questions:
        a, b = pa.answer(q), pb.answer(q)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    for mode in ("collapsed", "multihop"):
        assert [dataclasses.astuple(x)
                for x in pa.answer_batch(questions, mode=mode)] == \
            [dataclasses.astuple(x)
             for x in pb.answer_batch(questions, mode=mode)]


def test_jax_snapshot_restores_in_port(pair):
    corpus, jax_rag, _, _ = pair
    questions = [qa.question for qa in corpus.qa[:30]]
    state = jax_rag.state_dict(include_store=True)
    embedder = HashingEmbedder(dim=QUICKSTART["embed_dim"])
    port = EraRAG.from_state(state, embedder, device="cpu")
    assert embedder.stats["texts_encoded"] == 0   # nothing re-embedded
    for mode in MODES:
        _assert_retrievals_equal(jax_rag.query_batch(questions, mode=mode),
                                 port.query_batch(questions, mode=mode))
    # served from the snapshot's buffer: nothing staged again
    assert port.store.stats.full_rebuilds == 0
    assert port.store.stats.rows_staged == 0
    _assert_graphs_equal(jax_rag.graph, port.graph)
    # graph-only snapshot: the store replays the persisted delta log
    port2 = EraRAG.from_state(jax_rag.state_dict(), embedder,
                              device="cpu")
    _assert_retrievals_equal(jax_rag.query_batch(questions),
                             port2.query_batch(questions))
    assert port2.store.stats.rows_staged == jax_rag.store.stats.rows_staged
    assert port2.store.size == jax_rag.store.size


def test_port_snapshot_restores_in_both(pair):
    corpus, jax_rag, port, _ = pair
    questions = [qa.question for qa in corpus.qa[:20]]
    state = port.state_dict(include_store=True)
    again = EraRAG.from_state(state, HashingEmbedder(dim=128),
                              device="cpu")
    back = JaxRAG.from_state(state, JaxEmbedder(dim=128))
    want = port.query_batch(questions, mode="detailed")
    _assert_retrievals_equal(want, again.query_batch(questions,
                                                     mode="detailed"))
    _assert_retrievals_equal(back.query_batch(questions, mode="detailed"),
                             want)


def test_remove_then_reinsert_match():
    corpus, jax_rag, port, _ = _build(30, 2)
    victims = ["doc00003", "doc00011", "doc00020", "nope"]
    rep_a, rep_b = jax_rag.remove_docs(victims), port.remove_docs(victims)
    assert _report_counts(rep_a) == _report_counts(rep_b)
    assert rep_b.n_removed_chunks > 0
    _assert_graphs_equal(jax_rag.graph, port.graph)
    questions = [qa.question for qa in corpus.qa[:24]]
    for mode in MODES:
        _assert_retrievals_equal(jax_rag.query_batch(questions, mode=mode),
                                 port.query_batch(questions, mode=mode))
    back = [d for d in corpus.docs if d[0] in victims]
    rep_a, rep_b = jax_rag.insert_docs(back), port.insert_docs(back)
    assert _report_counts(rep_a) == _report_counts(rep_b)
    _assert_graphs_equal(jax_rag.graph, port.graph)
    _assert_retrievals_equal(jax_rag.query_batch(questions),
                             port.query_batch(questions))
    jax_rag.store.compact()
    port.store.compact()
    assert port.store.stats.compactions >= 1
    assert vars(port.store.stats) == vars(jax_rag.store.stats)
    _assert_retrievals_equal(jax_rag.query_batch(questions,
                                                 mode="summarized"),
                             port.query_batch(questions,
                                              mode="summarized"))
