"""The two-stage quantized scan (``quantized_scan=True``) through the JAX
package and the PyTorch port on the CPU.

Kernel layer: ``QuantSpec``, the hyperplanes and the codes bitwise;
``quantized_flagged_topk`` with ids equal and scores within 1e-5, and
at C = n bitwise the port's exact ``flagged_mips_topk``.  Store layer:
the flat-store cases of ``tests/test_store_quantized.py`` run through
both packages (on its dyadic grid every inner product is exact, so
scores compare bitwise).  Facade: the quickstart with the quantized
scan, hits, contexts, answers and ``StoreStats`` equal.
"""
import dataclasses
from typing import List

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_store_fuzz import Oracle, ScriptGraph, _ids, _vec

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.core.store import VectorStore as JaxStore
from repro.data.corpus import SyntheticCorpus
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.kernels.quantized_scan import ops as jq
from repro.serving.rag_pipeline import RAGPipeline as JaxPipeline

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.store import VectorStore
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.kernels.quantized_scan import ops as tq
from repro_torch.serving.rag_pipeline import RAGPipeline
from torch_threads import one_blas_thread  # noqa: F401

SCORE_TOL = 1e-5
FULL = 10 ** 6      # coarse_mult that clamps C to the capacity
QKW = dict(quantized=True, scan_bits=64, scan_seed=7)
BIASES = [(mips_ops.MASK_BIAS, 0.0, 0.0),
          (mips_ops.MASK_BIAS, mips_ops.MASK_BIAS, 0.0),
          (mips_ops.MASK_BIAS, 0.0, mips_ops.MASK_BIAS)]
SPECS = [(64, 64, 3, 7), (128, 10, 3, 0), (64, 128, 3, 1), (32, 33, 2, 5)]


# ---------------------------------------------------------------------------
# kernel layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,bits,flags,seed", SPECS)
def test_quant_spec_and_hyperplanes(dim, bits, flags, seed):
    a, b = jq.QuantSpec(dim, bits, flags, seed), \
        tq.QuantSpec(dim, bits, flags, seed)
    assert (a.code_words, a.flag_words, a.n_words) == \
        (b.code_words, b.flag_words, b.n_words)
    assert [a.flag_group(f) for f in range(flags)] == \
        [b.flag_group(f) for f in range(flags)]
    assert tq.QuantSpec(256, 64, 3, 0).n_words == 11
    pa, pb = jq.hyperplanes(a), tq.hyperplanes(b)
    assert pb.dtype == np.float32 and pb.shape == (dim, bits)
    np.testing.assert_array_equal(pa, pb)


def _flagged_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[4, 9]] = emb[1]                    # duplicated rows: exact ties
    u = rng.random(n)
    flags = np.stack([(u < 0.2), (u > 0.6), (u <= 0.6)],
                     axis=1).astype(np.float32)
    flags[[1, 4, 9]] = (0.0, 0.0, 1.0)     # alive leaves
    q = rng.standard_normal((7, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = emb[1]
    return q, emb, flags


@pytest.mark.parametrize("dim,bits,flags,seed", SPECS[:3])
def test_codes_match_reference_bitwise(dim, bits, flags, seed):
    q, emb, fl = _flagged_rows(150, dim, seed)
    ja, tb = jq.QuantSpec(dim, bits, 3, seed), tq.QuantSpec(dim, bits, 3,
                                                            seed)
    planes = tq.hyperplanes(tb)
    want = np.asarray(jq.encode_rows(jnp.asarray(emb), jnp.asarray(fl),
                                     jnp.asarray(planes), ja))
    got = tq.encode_rows(torch.from_numpy(emb), torch.from_numpy(fl),
                         torch.from_numpy(planes), tb)
    assert got.dtype == torch.int32 and got.shape == (150, tb.n_words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    lo, hi = tb.flag_group(0)
    dead = fl[:, 0] > 0
    assert (got.numpy()[dead, lo:hi] == -1).all()
    for bias in BIASES:
        want = np.asarray(jq.encode_queries(jnp.asarray(q),
                                            jnp.asarray(planes), bias, ja))
        got = tq.encode_queries(torch.from_numpy(q),
                                torch.from_numpy(planes), bias, tb)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("n_coarse", [8, 40, 200])
def test_quantized_topk_matches_reference(bias, n_coarse):
    n, d, k = 200, 64, 8
    q, emb, fl = _flagged_rows(n, d, seed=3)
    db = np.ascontiguousarray(np.concatenate([emb, fl], axis=1))
    ja, tb = jq.QuantSpec(d, 64, 3, 7), tq.QuantSpec(d, 64, 3, 7)
    planes = tq.hyperplanes(tb)
    codes = tq.encode_rows(torch.from_numpy(emb), torch.from_numpy(fl),
                           torch.from_numpy(planes), tb)
    jv, ji = jq.quantized_flagged_topk(
        jnp.asarray(q), jnp.asarray(db),
        jnp.asarray(codes.numpy().view(np.uint32)), k, n_coarse, bias,
        jnp.asarray(planes), ja)
    tv, ti = tq.quantized_flagged_topk(
        torch.from_numpy(q), torch.from_numpy(db), codes, k, n_coarse,
        bias, torch.from_numpy(planes), tb)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=SCORE_TOL)
    if bias[2] == 0.0:   # leaves 1, 4, 9 tie exactly for query 0
        assert ti[0, :3].tolist() == [1, 4, 9]
    if n_coarse == n:    # full coverage: bitwise the exact scan
        ev, ei = mips_ops.flagged_mips_topk(torch.from_numpy(q),
                                            torch.from_numpy(db), k, bias)
        assert torch.equal(tv, ev) and torch.equal(ti, ei)


def test_rescore_keeps_each_query_to_its_own_candidates():
    q, emb, _ = _flagged_rows(60, 16, seed=4)
    db = torch.from_numpy(emb)
    cand = torch.tensor([[5, 7, 9, 11], [50, 40, 30, 20]], dtype=torch.int32)
    vals, idx = mips_ops.mips_rescore(torch.from_numpy(q[:2]), db, cand, 3)
    for b in range(2):
        own = cand[b].long()
        scores = torch.from_numpy(q[b]) @ db[own].T
        order = torch.sort(scores, descending=True, stable=True).indices
        assert idx[b].tolist() == own[order[:3]].tolist()
    alone = mips_ops.mips_rescore(torch.from_numpy(q[1:2]), db, cand[1:],
                                  3)
    assert alone[1].tolist() == idx[1:].tolist()
    with pytest.raises(ValueError):
        mips_ops.mips_rescore(torch.from_numpy(q[:2]), db, cand, 5)
    with pytest.raises(ValueError, match="k <= 64"):
        mips_ops.mips_rescore_cuda(torch.from_numpy(q[:2]), db,
                                   torch.zeros((2, 80), dtype=torch.int32),
                                   65)


def test_quantized_asserts_shapes():
    q, emb, fl = _flagged_rows(20, 16, seed=5)
    spec = tq.QuantSpec(16, 64, 3, 0)
    planes = torch.from_numpy(tq.hyperplanes(spec))
    db = torch.from_numpy(np.concatenate([emb, fl], axis=1))
    codes = tq.encode_rows(db[:, :16], db[:, 16:], planes, spec)
    bias = BIASES[0]
    with pytest.raises(AssertionError):   # C < k
        tq.quantized_flagged_topk(torch.from_numpy(q), db, codes, 8, 4,
                                  bias, planes, spec)
    with pytest.raises(AssertionError):   # C > rows
        tq.quantized_flagged_topk(torch.from_numpy(q), db, codes, 8, 21,
                                  bias, planes, spec)
    with pytest.raises(AssertionError):   # codes of another layout
        tq.quantized_flagged_topk(torch.from_numpy(q), db, codes[:, :-1],
                                  8, 16, bias, planes, spec)


# ---------------------------------------------------------------------------
# store layer: the flat cases of tests/test_store_quantized.py, both
# packages
# ---------------------------------------------------------------------------

def _scored(hits):
    return [(h.node_id, h.score, h.layer) for h in hits]


def _pair(g, **kw):
    return JaxStore(g, **kw), VectorStore(g, device="cpu", **kw)


def _assert_same(a_hits, b_hits):
    """Port equal to the reference: ids, layers, seq and scores (the
    dyadic grid makes every score exact in both libraries)."""
    for a, b in zip(a_hits, b_hits):
        assert [(h.node_id, h.score, h.layer, h.seq) for h in a] == \
            [(h.node_id, h.score, h.layer, h.seq) for h in b]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_full_coverage_is_bitwise_exact_in_both(seed):
    rng = np.random.default_rng(seed)
    g = ScriptGraph()
    oracle = Oracle()
    kw = dict(compact_threshold=0.3, min_capacity=8)
    exact = VectorStore(g, device="cpu", **kw)
    jflat, qflat = _pair(g, coarse_mult=FULL, **kw, **QKW)
    queries = np.stack([_vec(rng) for _ in range(3)])
    next_id = 0
    removed_pool: List[str] = []
    for step in range(14):
        op = rng.choice(["add", "add", "remove", "readd", "compact"])
        if op == "add" or not (oracle.order or removed_pool):
            items = []
            for _ in range(int(rng.integers(1, 9))):
                items.append((f"n{next_id:05d}", _vec(rng),
                              int(rng.integers(0, 2))))
                next_id += 1
            g.add(items)
            oracle.add(items)
        elif op == "remove" and oracle.order:
            m = int(rng.integers(1, min(5, len(oracle.order)) + 1))
            picks = [oracle.order[int(i)] for i in
                     rng.choice(len(oracle.order), size=m, replace=False)]
            g.remove(picks)
            oracle.remove(picks)
            removed_pool.extend(picks)
        elif op == "readd" and removed_pool:
            nid = removed_pool.pop()
            items = [(nid, _vec(rng), int(rng.integers(0, 2)))]
            g.add(items)
            oracle.add(items)
        elif op == "compact":
            for s in (exact, jflat, qflat):
                s.compact()
        for filt in (None, "leaf", "summary"):
            want = oracle.search_batch(queries, 5, filt)
            got_e = exact.search_batch(queries, 5, filt)
            got_q = qflat.search_batch(queries, 5, filt)
            _assert_same(jflat.search_batch(queries, 5, filt), got_q)
            for w, e, f in zip(want, got_e, got_q):
                assert _ids(e) == w, (seed, step, filt)
                assert _scored(f) == _scored(e), (seed, step, filt)
    assert qflat.size == jflat.size == len(oracle.order)
    assert vars(qflat.stats) == vars(jflat.stats)
    if oracle.order:
        assert qflat.stats.quantized_scans > 0
    # the code plane equals the reference's, padding rows included
    np.testing.assert_array_equal(
        qflat._group.codes.numpy().view(np.uint32),
        np.asarray(jflat._group.codes))


def _grown_graph(rng, n):
    g = ScriptGraph()
    items = [(f"n{i:05d}", _vec(rng), i % 2) for i in range(n)]
    g.add(items)
    return g, items


def test_rescored_scores_are_exact_in_both():
    rng = np.random.default_rng(11)
    g, items = _grown_graph(rng, 260)
    embs = {nid: emb for nid, emb, _ in items}
    jstore, store = _pair(g, coarse_mult=3, **QKW)
    queries = np.stack([_vec(rng) for _ in range(4)])
    for filt in (None, "leaf", "summary"):
        hits_b = store.search_batch(queries, 8, filt)
        _assert_same(jstore.search_batch(queries, 8, filt), hits_b)
        for b, hits in enumerate(hits_b):
            assert hits
            for h in hits:
                true = float(np.float32(
                    queries[b].astype(np.float32) @ embs[h.node_id]))
                assert h.score == true, filt


def test_tombstoned_rows_never_return_in_both():
    rng = np.random.default_rng(12)
    g, items = _grown_graph(rng, 120)
    jstore, store = _pair(g, coarse_mult=2, **QKW)
    store.refresh()
    jstore.refresh()
    dead = [nid for nid, _, _ in items[::3]]
    g.remove(dead)
    queries = np.stack([_vec(rng) for _ in range(4)])
    got = store.search_batch(queries, 10)
    _assert_same(jstore.search_batch(queries, 10), got)
    for hits in got:
        assert hits and not set(h.node_id for h in hits) & set(dead)
    for hits in store.search_batch(queries, 10, layer_filter="leaf"):
        assert all(h.layer == 0 for h in hits)


def test_state_roundtrip_and_reference_snapshot():
    rng = np.random.default_rng(15)
    g, _ = _grown_graph(rng, 90)
    jstore, store = _pair(g, coarse_mult=3, **QKW)
    queries = np.stack([_vec(rng) for _ in range(3)])
    want = [_scored(h) for h in store.search_batch(queries, 6)]
    _assert_same(jstore.search_batch(queries, 6),
                 store.search_batch(queries, 6))
    state = store.state_dict()
    assert state["quant"] == {"quantized": True, "coarse_mult": 3,
                              "scan_bits": 64, "scan_seed": 7}
    assert "codes" not in state["shard"]     # derived, never saved
    for snap in (state, jstore.state_dict()):
        back = VectorStore.from_state(snap, g, device="cpu")
        assert back.quantized and back.coarse_mult == 3
        assert back.scan_bits == 64 and back.scan_seed == 7
        assert [_scored(h) for h in back.search_batch(queries, 6)] == want
        np.testing.assert_array_equal(back._group.codes.numpy(),
                                      store._group.codes.numpy())
        assert back.stats.rows_staged == 0   # restored, not replayed
    # explicit kwargs still win over the snapshot
    exact = VectorStore.from_state(state, g, quantized=False, device="cpu")
    assert not exact.quantized and exact._group.codes is None
    # and the reference restores the port's snapshot
    jback = JaxStore.from_state(state, g)
    assert jback.quantized
    assert [_scored(h) for h in jback.search_batch(queries, 6)] == want


# ---------------------------------------------------------------------------
# facade: the quickstart with the quantized scan, both packages
# ---------------------------------------------------------------------------

QUICKSTART_Q = dict(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                    max_layers=3, chunk_tokens=32, top_k=8,
                    token_budget=1024, quantized_scan=True)
MODES = ("collapsed", "detailed", "summarized", "multihop")


@pytest.fixture(scope="module")
def qpair():
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)
    jax_rag = JaxRAG(JaxConfig(**QUICKSTART_Q), JaxEmbedder(dim=128))
    port = EraRAG(EraRAGConfig(**QUICKSTART_Q), HashingEmbedder(dim=128),
                  device="cpu")
    for docs in [init] + rounds:
        jax_rag.insert_docs(docs)
        port.insert_docs(docs)
    return corpus, jax_rag, port


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


@pytest.mark.parametrize("mode", MODES)
def test_quickstart_quantized_matches(qpair, mode):
    corpus, jax_rag, port = qpair
    assert port.store.quantized and jax_rag.store.quantized
    questions = [qa.question for qa in corpus.qa[:40]]
    _assert_retrievals_equal(jax_rag.query_batch(questions, mode=mode),
                             port.query_batch(questions, mode=mode))
    assert port.store.stats.quantized_scans > 0
    assert vars(port.store.stats) == vars(jax_rag.store.stats)


def test_quickstart_quantized_answers_and_snapshot(qpair):
    corpus, jax_rag, _ = qpair
    questions = [qa.question for qa in corpus.qa[:12]]
    port = EraRAG.from_state(jax_rag.state_dict(include_store=True),
                             HashingEmbedder(dim=128), device="cpu")
    assert port.store.quantized and port.store.stats.rows_staged == 0
    pa, pb = JaxPipeline(jax_rag), RAGPipeline(port)
    assert [dataclasses.astuple(pa.answer(q)) for q in questions] == \
        [dataclasses.astuple(pb.answer(q)) for q in questions]
    for mode in MODES:
        _assert_retrievals_equal(jax_rag.query_batch(questions, mode=mode),
                                 port.query_batch(questions, mode=mode))
