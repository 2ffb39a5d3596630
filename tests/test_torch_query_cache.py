"""The semantic query cache (``core/query_cache.py``) and the cache path
of ``EraRAG.query_batch`` in the PyTorch port, on the CPU.

The first two groups are the port's counterparts of the engine-free
cases of ``tests/test_caching.py``: the cache is invalidated exactly by
the store ``cache_token`` (epoch, graph version), a cached retrieval is
never served stale across inserts or committed reshards, and queries
issued mid-migration keep hitting, because the store itself serves the
old epoch until the atomic install (the explicit ``Resharder.begin``,
which the port has; no lifecycle policy is needed).  The last group
runs one ``query_batch`` script through the JAX package and the port:
retrievals (hit ids, layers, sequence numbers, contexts; scores within
``SCORE_TOL``) and ``QueryCacheStats`` must be equal, and so must the
span tree under a manual clock.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.erarag import EraRAG as JaxRAG
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.obs import ManualClock as JaxClock, use_clock as jax_use_clock

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.query_cache import SemanticQueryCache, _digest, \
    _normalized
from repro_torch.core.retrieve import Retrieval
from repro_torch.core.store import Hit
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.lifecycle.reshard import Resharder
from repro_torch.obs import ManualClock, use_clock
from torch_threads import one_blas_thread  # noqa: F401

SCORE_TOL = 1e-6     # the reference's own batch-size drift is ~1e-7
CACHE_KW = dict(embed_dim=64, n_hyperplanes=8, s_min=3, s_max=9,
                max_layers=2, chunk_tokens=32, top_k=4,
                token_budget=256, query_cache=True, query_cache_size=64)
CFG = EraRAGConfig(**CACHE_KW)


def _build(cfg=CFG, n_docs=12):
    corpus = SyntheticCorpus.generate(n_docs=n_docs, n_topics=3, seed=0)
    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), device="cpu")
    rag.insert_docs(corpus.docs)
    return rag, corpus


# ----------------------------------------------------------------------
# SemanticQueryCache unit behavior
# ----------------------------------------------------------------------

TOK = (0, 1)
KEY = (4, "collapsed", 256, 0.6)


def _ret(ctx):
    return Retrieval(hits=[Hit("n", 1.0, 0, seq=0)], context=ctx,
                     n_tokens=1)


def _unit(seed=0, dim=16):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=dim).astype(np.float32)
    return e / np.linalg.norm(e)


def test_exact_hit_and_key_isolation():
    c = SemanticQueryCache(capacity=8)
    e = _unit()
    assert c.lookup(TOK, KEY, e) is None
    c.put(TOK, KEY, e, _ret("ctx"))
    hit = c.lookup(TOK, KEY, e)
    assert hit is not None and hit.context == "ctx"
    # a different retrieval key must not serve this entry
    assert c.lookup(TOK, (8, "detailed", 256, 0.6), e) is None
    assert c.stats.hits_exact == 1 and c.stats.misses == 2


def test_semantic_hit_under_threshold_cache():
    c = SemanticQueryCache(capacity=8, threshold=0.8)
    exact_only = SemanticQueryCache(capacity=8, threshold=1.0)
    e1 = _unit(0)
    near = e1 + 0.05 * _unit(1)
    near = near / np.linalg.norm(near)
    assert float(near @ e1) > 0.8          # test precondition
    for cache in (c, exact_only):
        cache.put(TOK, KEY, e1, _ret("ctx"))
    hit = c.lookup(TOK, KEY, near)
    assert hit is not None and hit.context == "ctx"
    assert c.stats.hits_semantic == 1
    # threshold 1.0 keeps only the exact path
    assert exact_only.lookup(TOK, KEY, near) is None


def test_token_move_drops_generation():
    c = SemanticQueryCache(capacity=8)
    e = _unit()
    c.put(TOK, KEY, e, _ret("ctx"))
    assert c.lookup((0, 2), KEY, e) is None       # graph version moved
    assert c.stats.invalidations == 1 and len(c) == 0
    c.put((0, 2), KEY, e, _ret("ctx2"))
    assert c.lookup((1, 2), KEY, e) is None       # epoch moved
    assert c.stats.invalidations == 2


def test_lru_eviction_bounds():
    c = SemanticQueryCache(capacity=2)
    embs = [_unit(s) for s in range(3)]
    for i, e in enumerate(embs):
        c.put(TOK, KEY, e, _ret(f"c{i}"))
        assert len(c) <= 2
    assert c.stats.evictions == 1
    assert c.lookup(TOK, KEY, embs[0]) is None    # oldest evicted
    assert c.lookup(TOK, KEY, embs[2]).context == "c2"


def test_cached_payloads_are_copy_isolated():
    c = SemanticQueryCache(capacity=8)
    e = _unit()
    c.put(TOK, KEY, e, _ret("ctx"))
    first = c.lookup(TOK, KEY, e)
    first.hits.append(Hit("rogue", 0.0, 0))
    assert len(c.lookup(TOK, KEY, e).hits) == 1


def test_config_validation():
    with pytest.raises(ValueError):
        SemanticQueryCache(capacity=0)
    with pytest.raises(ValueError):
        SemanticQueryCache(threshold=0.0)
    with pytest.raises(ValueError):
        EraRAGConfig(query_cache_threshold=1.5)


def test_digests_bitwise_the_reference():
    """The exact path's key: the same blake2 digest of the same
    normalized embedding bytes, and the same key fold, in both
    packages."""
    from repro.core import query_cache as jax_qc
    for seed in range(4):
        e = (3.0 * _unit(seed, dim=64)).astype(np.float32)
        assert np.array_equal(_normalized(e), jax_qc._normalized(e))
        assert _digest(_normalized(e)) == \
            jax_qc._digest(jax_qc._normalized(e))
        assert SemanticQueryCache._fold(KEY, _digest(e)) == \
            jax_qc.SemanticQueryCache._fold(KEY, jax_qc._digest(e))


# ----------------------------------------------------------------------
# EraRAG integration: hits, key scoping, exact invalidation
# ----------------------------------------------------------------------

def test_exact_repeat_serves_cache_without_a_round():
    rag, corpus = _build()
    q = corpus.qa[0].question
    r1 = rag.query(q)
    rounds = rag.stats["retrieval_rounds"]
    r2 = rag.query(q)
    assert rag.stats["retrieval_rounds"] == rounds
    assert rag.query_cache.stats.hits_exact == 1
    assert r2.context == r1.context
    assert [h.node_id for h in r2.hits] == [h.node_id for h in r1.hits]
    assert r2.epoch == r1.epoch


def test_mode_and_k_scope_the_cache_key():
    rag, corpus = _build()
    q = corpus.qa[0].question
    rag.query(q)
    rag.query(q, mode="detailed")
    rag.query(q, k=2)
    assert rag.query_cache.stats.hits == 0
    rag.query(q, mode="detailed")
    assert rag.query_cache.stats.hits_exact == 1


def _bits(rets):
    return [[(h.node_id, h.layer, h.seq,
              np.float32(h.score).tobytes()) for h in r.hits]
            + [r.context, r.n_tokens, r.epoch] for r in rets]


@pytest.mark.parametrize("mode", ["collapsed", "detailed", "summarized"])
def test_cache_on_matches_cache_off(mode):
    """Cold and warm batches equal a cache-off twin, score bits
    included; the warm batch takes no retrieval round and no scan."""
    rag_c, corpus = _build()
    rag_u, _ = _build(dataclasses.replace(CFG, query_cache=False))
    assert rag_u.query_cache is None
    questions = [qa.question for qa in corpus.qa[:6]]
    want = _bits(rag_u.query_batch(questions, mode=mode))
    assert _bits(rag_c.query_batch(questions, mode=mode)) == want
    rounds = rag_c.stats["retrieval_rounds"]
    scans = rag_c.store.stats.kernel_launches
    assert _bits(rag_c.query_batch(questions, mode=mode)) == want
    assert rag_c.stats["retrieval_rounds"] == rounds
    assert rag_c.store.stats.kernel_launches == scans
    assert rag_c.query_cache.stats.hits_exact == len(questions)


def test_partial_hits_make_one_sweep_of_the_misses():
    rag, corpus = _build()
    qs = [qa.question for qa in corpus.qa]
    old, new = qs[:3], [q + " really" for q in qs[3:6]]
    rag.query_batch(old)
    rounds = rag.stats["retrieval_rounds"]
    out = rag.query_batch(old + new)
    assert rag.stats["retrieval_rounds"] == rounds + 1
    assert rag.query_cache.stats.hits_exact == 3
    assert rag.query_cache.stats.misses == 6
    rag_u, _ = _build(dataclasses.replace(CFG, query_cache=False))
    assert _bits(out) == _bits(rag_u.query_batch(old + new))


def test_multihop_bypasses_the_cache():
    rag, corpus = _build()
    q = corpus.qa[0].question
    rag.query(q, mode="multihop")
    rag.query(q, mode="multihop")
    assert len(rag.query_cache) == 0
    assert rag.query_cache.stats.misses == 0


def test_insert_invalidates_and_next_query_sees_new_doc():
    rag, _ = _build()
    rag_u, _ = _build(dataclasses.replace(CFG, query_cache=False))
    q = "What is the capital of Flooglestan ?"
    rag.query(q)
    tok = rag.store.cache_token
    doc = ("new", "The capital of Flooglestan is Quuxville .")
    rag.insert_docs([doc])
    rag_u.insert_docs([doc])
    assert rag.store.cache_token != tok
    r2 = rag.query(q)
    assert rag.query_cache.stats.invalidations >= 1
    assert "Quuxville" in r2.context
    assert r2.context == rag_u.query(q).context


def test_remove_and_compaction_move_the_token():
    """A removal moves the graph version; a compaction changes no
    result, so it needs no token move, and the cache keeps serving the
    same bits as a cache-off twin."""
    rag, corpus = _build()
    rag_u, _ = _build(dataclasses.replace(CFG, query_cache=False))
    qs = [qa.question for qa in corpus.qa[:4]]
    # both stores refresh at the same versions, so their rows (and
    # sequence numbers) keep one history
    assert _bits(rag.query_batch(qs)) == _bits(rag_u.query_batch(qs))
    tok = rag.store.cache_token
    victim = corpus.docs[0][0]
    rag.remove_docs([victim])
    rag_u.remove_docs([victim])
    assert rag.store.cache_token[1] > tok[1]
    assert _bits(rag.query_batch(qs)) == _bits(rag_u.query_batch(qs))
    tok = rag.store.cache_token
    rag.store.compact()
    rag_u.store.compact()
    assert rag.store.cache_token == tok
    hits = rag.query_cache.stats.hits_exact
    assert _bits(rag.query_batch(qs)) == _bits(rag_u.query_batch(qs))
    assert rag.query_cache.stats.hits_exact == hits + len(qs)


# ----------------------------------------------------------------------
# migration semantics: old epoch keeps serving, install invalidates
# ----------------------------------------------------------------------

def test_mid_migration_serves_old_epoch_install_invalidates():
    rag, corpus = _build(dataclasses.replace(CFG, index_shards=2))
    q = corpus.qa[0].question
    r1 = rag.query(q)
    tok1 = rag.store.cache_token
    mig = Resharder().begin(rag.store, 3, "caching-test")
    while not mig.done:
        mig.step()
        # the store serves the OLD epoch until the atomic install, so
        # the cache token is unchanged and hits are legitimate
        r = rag.query(q)
        assert r.context == r1.context and r.epoch == r1.epoch
        assert rag.store.cache_token == tok1
    assert rag.query_cache.stats.hits_exact >= 1
    mig.install()
    assert rag.store.cache_token != tok1
    r2 = rag.query(q)
    assert rag.query_cache.stats.invalidations >= 1
    assert r2.epoch == r1.epoch + 1
    # an epoch-swapped reshard is result-transparent
    assert r2.context == r1.context


@pytest.mark.parametrize("n_from,n_to", [(1, 2), (2, 4), (2, 1)])
def test_explicit_reshard_clears_cache(n_from, n_to):
    rag, corpus = _build(dataclasses.replace(CFG, index_shards=n_from))
    q = corpus.qa[0].question
    r1 = rag.query(q)
    rag.reshard(n_to)
    assert len(rag.query_cache) == 0
    r2 = rag.query(q)
    assert r2.context == r1.context
    assert rag.query_cache.stats.misses == 2


def test_from_state_starts_an_empty_cache():
    rag, corpus = _build()
    q = corpus.qa[0].question
    r1 = rag.query(q)
    back = EraRAG.from_state(rag.state_dict(include_store=True),
                             HashingEmbedder(dim=CFG.embed_dim),
                             device="cpu")
    assert back.query_cache is not None and len(back.query_cache) == 0
    assert back.query(q).context == r1.context
    assert back.query(q).context == r1.context
    assert back.query_cache.stats.hits_exact == 1


# ----------------------------------------------------------------------
# the JAX package against the port on one script
# ----------------------------------------------------------------------

def _script(rag, corpus):
    """Cold batch, warm batch, a half-new batch in each mode, an
    insert, and the batch again: the retrievals of every call."""
    qs = [qa.question for qa in corpus.qa[:8]]
    out = []
    for mode in ("collapsed", "detailed", "summarized"):
        out.append(rag.query_batch(qs[:6], mode=mode))
        out.append(rag.query_batch(qs[:6], mode=mode))
        out.append(rag.query_batch(qs[3:8], mode=mode))
    rag.insert_docs([("late", "The river of Quux is Zorbel . "
                              "Zorbel flows north .")])
    out.append(rag.query_batch(qs[:6]))
    out.append(rag.query_batch(qs[:6] + ["What is the river of Quux ?"]))
    return out


def _assert_same_retrievals(ja, pa):
    assert len(ja) == len(pa)
    for rj, rp in zip(ja, pa):
        assert [(h.node_id, h.layer, h.seq) for h in rj.hits] == \
            [(h.node_id, h.layer, h.seq) for h in rp.hits]
        np.testing.assert_allclose([h.score for h in rj.hits],
                                   [h.score for h in rp.hits],
                                   rtol=0, atol=SCORE_TOL)
        assert (rj.context, rj.n_tokens, rj.epoch) == \
            (rp.context, rp.n_tokens, rp.epoch)


@pytest.mark.parametrize("shards,threshold", [(1, 1.0), (2, 1.0),
                                              (1, 0.9)])
def test_query_batch_script_matches_reference(shards, threshold):
    kw = dict(CACHE_KW, index_shards=shards,
              query_cache_threshold=threshold)
    corpus = SyntheticCorpus.generate(n_docs=12, n_topics=3, seed=0)
    jax_rag = JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=kw["embed_dim"]))
    port = EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=kw["embed_dim"]),
                  device="cpu")
    for rag in (jax_rag, port):
        rag.insert_docs(corpus.docs)
    ja, pa = _script(jax_rag, corpus), _script(port, corpus)
    for bj, bp in zip(ja, pa):
        _assert_same_retrievals(bj, bp)
    assert jax_rag.query_cache.stats.to_dict() == \
        port.query_cache.stats.to_dict()
    assert jax_rag.stats == port.stats
    assert jax_rag.store.cache_token == port.store.cache_token


def _span_rows(tracer):
    return [(s.name, s.depth, s.duration, sorted(s.attrs.items()))
            for s in tracer.spans]


def test_cached_query_batch_span_tree_matches_reference():
    """Under a manual clock (one tick a clock read) the traced cold,
    warm and half-new batches record the same spans in the same order,
    nesting, durations and attributes in both packages."""
    kw = dict(CACHE_KW, obs_trace=True)
    corpus = SyntheticCorpus.generate(n_docs=12, n_topics=3, seed=0)
    qs = [qa.question for qa in corpus.qa[:6]]
    rows = []
    for rag, clock, use in (
            (JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=64)), JaxClock,
             jax_use_clock),
            (EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=64),
                    device="cpu"), ManualClock, use_clock)):
        rag.insert_docs(corpus.docs)
        rag.store.refresh()
        rag.obs.tracer.reset()
        with use(clock(tick=1.0)):
            rag.query_batch(qs)
            rag.query_batch(qs)
            rag.query_batch(qs[:3] + ["an unseen question"])
        rows.append(_span_rows(rag.obs.tracer))
    assert rows[0] == rows[1]
    names = [r[0] for r in rows[1]]
    assert names.count("cache_lookup") == 3 and "scan" in names
