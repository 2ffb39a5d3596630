"""The paper's baselines (``core/baselines.py``) in the PyTorch port
against the JAX package, on the CPU.

Each system takes a build plus three growth rounds of one
``SyntheticCorpus`` in both packages.  Bitwise: every round's
``UpdateReport`` token counts, ``n_new_chunks`` and
``n_resummarized``; each question's hit ids and order, context and
``n_tokens``; ``_kmeans`` assignments and GraphRAG's communities.
Scores: within ``SCORE_TOL``.  On the CPU the JAX side runs
``mips_topk``'s XLA reference and the port its plain torch version;
the two fp32 products may round differently in the last bit (observed:
1.2e-7 on unit vectors).  Ties go to the lowest row in both, which
``test_dense_ties_resolve_to_the_lowest_row`` plants on purpose.
"""
import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core import baselines as jax_baselines
from repro.embed.hashing import HashingEmbedder as JaxEmbedder

from repro_torch.common.config import EraRAGConfig
from repro_torch.core import baselines
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from torch_threads import one_blas_thread  # noqa: F401

SCORE_TOL = 1e-6
KW = dict(embed_dim=64, n_hyperplanes=8, s_min=3, s_max=9, max_layers=3,
          chunk_tokens=32, top_k=6, token_budget=256)
SYSTEMS = ("VanillaRAG", "BM25", "RaptorLike", "GraphRAGLike")
REPORT_COUNTS = ("tokens_in", "tokens_out", "n_new_chunks",
                 "n_resummarized")
N_QUESTIONS = 40


@pytest.fixture(scope="module")
def corpus():
    return SyntheticCorpus.generate(n_docs=80, n_topics=6, seed=0)


def _pair(name, corpus):
    jax_sys = getattr(jax_baselines, name)(JaxConfig(**KW),
                                           JaxEmbedder(dim=64))
    port = getattr(baselines, name)(EraRAGConfig(**KW),
                                    HashingEmbedder(dim=64), device="cpu")
    init, rounds = corpus.growth_rounds(0.5, 3)
    reports = [(jax_sys.insert_docs(docs), port.insert_docs(docs))
               for docs in [init] + rounds]
    return jax_sys, port, reports


def _assert_same_retrieval(rj, rp):
    assert [h.node_id for h in rj.hits] == [h.node_id for h in rp.hits]
    assert [h.layer for h in rj.hits] == [h.layer for h in rp.hits]
    np.testing.assert_allclose([h.score for h in rj.hits],
                               [h.score for h in rp.hits],
                               rtol=0, atol=SCORE_TOL)
    assert (rj.context, rj.n_tokens) == (rp.context, rp.n_tokens)


@pytest.mark.parametrize("name", SYSTEMS)
def test_baseline_matches_reference(name, corpus):
    jax_sys, port, reports = _pair(name, corpus)
    for rj, rp in reports:
        assert {f: getattr(rj, f) for f in REPORT_COUNTS} == \
            {f: getattr(rp, f) for f in REPORT_COUNTS}
    assert jax_sys.total_tokens == port.total_tokens
    assert port.reports[-1].n_new_chunks > 0
    for qa in corpus.qa[:N_QUESTIONS]:
        _assert_same_retrieval(jax_sys.query(qa.question),
                               port.query(qa.question))
    _assert_same_retrieval(jax_sys.query(corpus.qa[0].question, k=2),
                           port.query(corpus.qa[0].question, k=2))
    if name != "BM25":
        # the embedding matrix lives on the device, as one tensor
        embs = port._embs
        assert embs.device.type == "cpu" and embs.dtype.is_floating_point
        n = len(port.chunks) if name == "VanillaRAG" else len(port.texts)
        assert tuple(embs.shape) == (n, KW["embed_dim"])
        assert np.array_equal(embs.numpy(), np.asarray(jax_sys._embs))


@pytest.mark.parametrize("name", SYSTEMS)
def test_empty_baseline_returns_nothing(name):
    port = getattr(baselines, name)(EraRAGConfig(**KW),
                                    HashingEmbedder(dim=64), device="cpu")
    r = port.query("anything at all")
    assert (r.hits, r.context, r.n_tokens) == ([], "", 0)


@pytest.mark.parametrize("seed,n,c", [(0, 40, 5), (1, 97, 11), (3, 6, 9)])
def test_kmeans_assignments_bitwise(seed, n, c):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    for s in (0, 1, 2):
        got = baselines._kmeans(embs.copy(), c, seed=s)
        want = jax_baselines._kmeans(embs.copy(), c, seed=s)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_graphrag_communities_bitwise(corpus):
    from repro_torch.data.chunker import chunk_corpus
    jax_sys = jax_baselines.GraphRAGLike(JaxConfig(**KW),
                                         JaxEmbedder(dim=64))
    port = baselines.GraphRAGLike(EraRAGConfig(**KW),
                                  HashingEmbedder(dim=64), device="cpu")
    chunks = chunk_corpus(corpus.docs, port.tokenizer, KW["chunk_tokens"])
    comms = port._communities(chunks)
    assert comms == jax_sys._communities(chunks)
    assert sum(len(c) for c in comms) == len(chunks) and len(comms) > 1


@pytest.mark.parametrize("name", ["VanillaRAG", "RaptorLike"])
def test_dense_ties_resolve_to_the_lowest_row(name):
    """Three documents of one identical text: their chunks embed to
    the same row, so the scan sees an exact three-way tie; both
    packages must list the rows in insertion order."""
    text = ("The capital of ent_zorba is val_quux . "
            "The river of ent_zorba is val_blee .")
    docs = [(f"dup{i}", text) for i in range(3)] + \
        [("other", "The color of ent_mimi is val_red .")]
    jax_sys = getattr(jax_baselines, name)(JaxConfig(**KW),
                                           JaxEmbedder(dim=64))
    port = getattr(baselines, name)(EraRAGConfig(**KW),
                                    HashingEmbedder(dim=64), device="cpu")
    jax_sys.insert_docs(docs)
    port.insert_docs(docs)
    q = "What is the capital of ent_zorba ?"
    rj, rp = jax_sys.query(q, k=3), port.query(q, k=3)
    _assert_same_retrieval(rj, rp)
    scores = [h.score for h in rp.hits]
    assert scores[0] == scores[1] == scores[2]
    rows = [c.chunk_id for c in port.chunks] if name == "VanillaRAG" \
        else port.ids
    assert [h.node_id for h in rp.hits] == rows[:3]
