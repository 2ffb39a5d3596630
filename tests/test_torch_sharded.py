"""The sharded store through the JAX package and the PyTorch port on the
CPU (plain versions of the kernels).

Against the port's flat store: ids, layers, sequence numbers and order
equal and scores bitwise equal, through growth, removal, resurrection,
per-shard compaction, renumbering and reshards.  Against the JAX
package's mesh-free ``ShardedVectorStore`` (its per-shard loop): the
same equalities with scores within 1e-6 (the reference's own
batch-size drift, a reference gap), and within 1e-5 on the quantized
scan (the quantized slice's tolerance).  Routing, the merge, the
store's counters and the snapshots are compared exactly.  The cases of
``tests/test_store_sharded.py`` and the non-policy cases of
``tests/test_lifecycle.py`` are ported here, each against the port's
own oracle (the flat store or a fresh build).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import EraRAGConfig as JaxConfig
from repro.common.sharding import padded_slot_count as jax_padded
from repro.core import store as jstore
from repro.core.erarag import EraRAG as JaxRAG
from repro.core.graph import EraGraph as JaxGraph
from repro.data.chunker import Chunk as JaxChunk
from repro.data.corpus import SyntheticCorpus
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.kernels.mips_topk.ops import _merge_sharded_topk as jax_merge
from repro.lifecycle.reshard import Resharder as JaxResharder
from repro.serving.rag_pipeline import RAGPipeline as JaxPipeline

from repro_torch.common.config import EraRAGConfig
from repro_torch.common.sharding import padded_slot_count, \
    shard_placements
from repro_torch.core import store as tstore
from repro_torch.core.erarag import EraRAG
from repro_torch.core.graph import EraGraph
from repro_torch.core.retrieve import collapsed_search_batch
from repro_torch.core.store import ShardedVectorStore, VectorStore, \
    store_from_state
from repro_torch.data.chunker import Chunk
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.lifecycle import Resharder
from repro_torch.serving.rag_pipeline import RAGPipeline

JAX_TOL = 1e-6      # the reference's batch-size drift (a reference gap)
QUANT_TOL = 1e-5    # the quantized slice's tolerance
FULL = 10 ** 6      # coarse_mult that clamps C to the capacity
FILTERS = (None, "leaf", "summary")
SHARDS = (1, 2, 3, 4, 8)
CFG_KW = dict(embed_dim=32, n_hyperplanes=10, s_min=3, s_max=9,
              max_layers=3, chunk_tokens=32)
CFG = EraRAGConfig(**CFG_KW)
_EMB = HashingEmbedder(dim=CFG.embed_dim)
_JEMB = JaxEmbedder(dim=CFG.embed_dim)
_WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
          "eta", "theta", "iota", "kappa"]
CPU = dict(device="cpu")


def _chunks(seed: int, n: int, cls=Chunk):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = [_WORDS[int(w)] for w in
                 rng.integers(0, len(_WORDS), size=12)]
        out.append(cls(chunk_id=f"c{seed}-{i:04d}", doc_id=f"d{i % 5}",
                       text=f"Chunk {i} says " + " ".join(words) + ".",
                       n_tokens=15))
    return out


def _queries(seed: int, n: int = 4) -> np.ndarray:
    texts = [f"what does chunk {i + seed} say about "
             f"{_WORDS[(i + seed) % len(_WORDS)]}?" for i in range(n)]
    return np.asarray(_EMB.encode(texts), np.float32)


def _graph():
    return EraGraph(CFG, _EMB, **CPU)


def _bits(score: float) -> int:
    return int(np.float32(score).view(np.uint32))


def _exact(hits, seqs=True):
    return [(h.node_id, h.layer, h.seq if seqs else None, _bits(h.score))
            for h in hits]


def _ids(hits):
    return [(h.node_id, h.layer, h.seq) for h in hits]


def _assert_bitwise(a, b, queries, k=6, seqs=True):
    """Hits equal, scores bitwise; ``seqs`` compares the sequence
    numbers too (stores with one delta history share them; a fresh
    build numbers its rows from 0)."""
    for filt in FILTERS:
        for ha, hb in zip(a.search_batch(queries, k, filt),
                          b.search_batch(queries, k, filt)):
            assert _exact(ha, seqs) == _exact(hb, seqs), (filt, ha, hb)


def _assert_near(port, ref, queries, k=6, tol=JAX_TOL):
    for filt in FILTERS:
        got = port.search_batch(queries, k, filt)
        want = ref.search_batch(queries, k, filt)
        assert len(got) == len(want)
        for hg, hw in zip(got, want):
            assert _ids(hg) == _ids(hw), (filt, hg, hw)
            np.testing.assert_allclose([h.score for h in hg],
                                       [h.score for h in hw],
                                       rtol=0, atol=tol)


def _assert_matches_fresh(store, graph, queries, n_shards, k=6):
    """Bitwise oracle: a store freshly built at the target count."""
    fresh = ShardedVectorStore(graph, n_shards=n_shards, **CPU)
    fresh.rebuild()
    _assert_bitwise(store, fresh, queries, k, seqs=False)


def _stats(stats) -> dict:
    """The maintenance and routing counters (the scan counters move
    with how often a test searches each store)."""
    out = dataclasses.asdict(stats)
    for key in ("kernel_launches", "quantized_scans"):
        out.pop(key)
    return out


# ---------------------------------------------------------------------------
# routing and the placement rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", range(1, 10))
def test_routing_bitwise_the_jax_routing(n_shards):
    ids = [f"node-{i}-{'x' * (i % 7)}" for i in range(5000)]
    want = np.asarray([jstore._route(i, n_shards) for i in ids])
    got = np.asarray([tstore._route(i, n_shards) for i in ids])
    np.testing.assert_array_equal(got, want)
    # both sides of the bulk threshold, through a private router each
    for n in (tstore._BULK_ROUTE_MIN - 1, tstore._BULK_ROUTE_MIN):
        jr, tr = jstore._Router(), tstore._Router()
        for _ in range(2):       # misses, then the LRU's hits
            np.testing.assert_array_equal(tr.many(ids[:n], n_shards),
                                          jr.many(ids[:n], n_shards))
            assert tr.info() == jr.info()
        np.testing.assert_array_equal(tr.many(ids[:n], n_shards),
                                      want[:n])
    np.testing.assert_array_equal(
        tstore._bulk_route(ids, n_shards),
        jstore._bulk_route(ids, n_shards))
    assert tstore._BULK_ROUTE_MIN == jstore._BULK_ROUTE_MIN == 4096
    assert tstore.shard_of(ids[0], n_shards) == want[0]
    np.testing.assert_array_equal(tstore.shard_of_many(ids, n_shards),
                                  want)


@pytest.mark.parametrize("n_shards,n_devices", [(1, 1), (4, 1), (3, 2),
                                                (8, 4), (5, 4)])
def test_placement_rules(n_shards, n_devices):
    assert padded_slot_count(n_shards, n_devices) == \
        jax_padded(n_shards, n_devices)
    devs = [torch.device("cpu", i) for i in range(n_devices)]
    place = shard_placements(devs, n_shards)
    assert len(place) == n_shards
    assert len(set(place)) == min(n_shards, n_devices)
    if n_shards % n_devices == 0:    # contiguous shard groups
        per = n_shards // n_devices
        assert place == [devs[i // per] for i in range(n_shards)]


# ---------------------------------------------------------------------------
# the merge alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_jax_on_ties_pads_and_signed_zero(seed):
    rng = np.random.default_rng(seed)
    s, b, kk = 4, 5, 6
    # few distinct scores: many ties across and within shards
    vals = rng.choice(np.float32([0.5, 0.25, 0.0, -0.0, -0.125]),
                      size=(s, b, kk)).astype(np.float32)
    seqs = rng.permutation(s * b * kk).reshape(s, b, kk).astype(np.int32)
    # a shard padded past its k_s, as slot_topk pads
    vals[1, :, 4:] = mips_ops.VAL_PAD
    seqs[1, :, 4:] = mips_ops.SEQ_PAD
    for k in (1, kk, s * kk):
        jv, js = jax_merge(jnp.asarray(vals), jnp.asarray(seqs), k)
        before = mips_ops.merge_launch_count()
        tv, ts = mips_ops.merge_sharded_topk(torch.from_numpy(vals),
                                             torch.from_numpy(seqs), k)
        assert mips_ops.merge_launch_count() == before + 1
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


# ---------------------------------------------------------------------------
# against the flat store and the JAX package, over growth and removal
# ---------------------------------------------------------------------------

def _script(seed):
    """Growth batches, a document removed and re-inserted (content-
    addressed resurrection), more growth."""
    rng = np.random.default_rng(seed)
    chunks = _chunks(seed, 90)
    pos, ops = 0, []
    while pos < 60:
        bs = int(rng.integers(1, 20))
        ops.append(("insert", (pos, pos + bs)))
        pos += bs
    ops.append(("remove", "d1"))
    ops.append(("reinsert", "d1"))
    ops.append(("insert", (pos, 90)))
    return chunks, ops


def _run_script(seed, stores_for, check):
    chunks, ops = _script(seed)
    jchunks = _chunks(seed, 90, JaxChunk)
    g, jg = _graph(), JaxGraph(JaxConfig(**CFG_KW), _JEMB)
    stores = stores_for(g, jg)
    removed = []
    for op, arg in ops:
        if op == "insert":
            a, b = arg
            g.insert_chunks(chunks[a:b])
            jg.insert_chunks(jchunks[a:b])
        elif op == "remove":
            removed = [i for i, c in enumerate(chunks[:60])
                       if c.doc_id == arg]
            for graph in (g, jg):
                graph.remove_chunks([chunks[i].chunk_id for i in removed])
        else:
            g.insert_chunks([chunks[i] for i in removed])
            jg.insert_chunks([jchunks[i] for i in removed])
        check(stores)
    return g, jg, stores


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_matches_flat_and_jax_over_growth(n_shards):
    """Growth, summary churn (tombstones), removal and resurrection:
    bitwise the port's flat store, and the JAX sharded store's ids,
    layers and sequence numbers with scores within 1e-6, after every
    step; the counters equal the JAX store's field for field."""
    queries = _queries(n_shards)

    def stores_for(g, jg):
        return (VectorStore(g, **CPU),
                ShardedVectorStore(g, n_shards=n_shards, **CPU),
                jstore.ShardedVectorStore(jg, n_shards=n_shards))

    def check(stores):
        flat, sharded, ref = stores
        _assert_bitwise(sharded, flat, queries)
        _assert_near(sharded, ref, queries)

    g, _, (flat, sharded, ref) = _run_script(n_shards, stores_for, check)
    st = sharded.stats
    assert st.full_rebuilds == 0 and st.rows_tombstoned > 0, st
    assert st.rows_staged == flat.stats.rows_staged
    assert _stats(st) == _stats(ref.stats)
    assert [_stats(s) for s in sharded.shard_stats()] == \
        [_stats(s) for s in ref.shard_stats()]
    assert sharded.size == flat.size == len(g.nodes)
    # a batch: one scan per non-empty shard plus the merge, as the JAX
    # store counts it
    launches = [st.stats.kernel_launches for st in (sharded, ref)]
    for st in (sharded, ref):
        st.search_batch(queries, 6)
    non_empty = sum(sh.count > 0 for sh in sharded._shards)
    assert [st.stats.kernel_launches - n for st, n in
            zip((sharded, ref), launches)] == [non_empty + 1] * 2
    rep = sharded.shard_report()
    assert [r["device"] for r in rep] == ["cpu"] * n_shards
    assert all(r["capacity"] == sharded._group.capacity for r in rep)
    # the device sequence plane mirrors every shard's host sequence
    for sh in sharded._shards:
        np.testing.assert_array_equal(
            sharded._group.seq_view(sh.slot)[:sh.count].numpy(),
            sh.row_seq[:sh.count])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_compaction_rotation_matches_jax(n_shards):
    """An aggressive threshold forces per-shard compactions mid-stream:
    at most one a refresh, the rest counted in ``compactions_skipped``,
    as in the JAX store; results stay bitwise the flat store's."""
    queries = _queries(5)

    def stores_for(g, jg):
        return (VectorStore(g, compact_threshold=0.01, **CPU),
                ShardedVectorStore(g, n_shards=n_shards,
                                   compact_threshold=0.01, **CPU),
                jstore.ShardedVectorStore(jg, n_shards=n_shards,
                                          compact_threshold=0.01))

    def check(stores):
        flat, sharded, ref = stores
        _assert_bitwise(sharded, flat, queries)
        _assert_near(sharded, ref, queries)
        assert sharded.pending_compaction == ref.pending_compaction

    _, _, (_, sharded, ref) = _run_script(5, stores_for, check)
    assert sharded.stats.compactions > 0
    assert sharded.stats.compactions_skipped > 0
    assert _stats(sharded.stats) == _stats(ref.stats)
    for st in sharded.shard_stats():
        if st.compactions == 0:
            assert st.rows_compacted == 0


def test_sharded_single_vs_batch_bitwise_identical():
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, **CPU)
    g.insert_chunks(_chunks(3, 60))
    queries = _queries(3, n=7)
    batched = sharded.search_batch(queries, 5)
    for q, hb in zip(queries, batched):
        # one query's scan on the CPU route takes another summation
        # order than the batch's (gemv), so a single query is held
        # against the flat store's single query
        flat = VectorStore(g, **CPU)
        assert _exact(sharded.search(q, 5)) == _exact(flat.search(q, 5))
        assert _ids(sharded.search(q, 5)) == _ids(hb)


# ---------------------------------------------------------------------------
# delta locality
# ---------------------------------------------------------------------------

def test_single_doc_insert_stages_rows_on_exactly_one_shard():
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, **CPU)
    g.insert_chunks(_chunks(10, 8))   # 8 leaves < s_max: no summary
    sharded.refresh()
    before = [st.rows_staged for st in sharded.shard_stats()]
    g.insert_chunks(_chunks(11, 1))
    sharded.refresh()
    staged = [st.rows_staged - b
              for st, b in zip(sharded.shard_stats(), before)]
    assert sorted(staged) == [0, 0, 0, 1], staged
    nid = _chunks(11, 1)[0].chunk_id
    assert staged[sharded.owner(nid)] == 1
    assert sharded.owner(nid) == jstore._route(nid, 4)


def test_delta_staging_confined_to_owner_shards():
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, **CPU)
    g.insert_chunks(_chunks(12, 70))
    sharded.refresh()
    v0 = g.version
    before = [st.rows_staged for st in sharded.shard_stats()]
    g.insert_chunks(_chunks(13, 1))
    sharded.refresh()
    (added, _removed), = g.deltas_since(v0)
    owners = {sharded.owner(nid) for nid in added}
    staged = [st.rows_staged - b
              for st, b in zip(sharded.shard_stats(), before)]
    assert sum(staged) == len(added)
    for s, n in enumerate(staged):
        if s not in owners:
            assert n == 0, (s, staged, owners)


# ---------------------------------------------------------------------------
# edges
# ---------------------------------------------------------------------------

def test_sharded_edge_cases_match_flat_and_jax():
    """Empty store and empty shards, zero queries, k <= 0, k above the
    live rows, per-shard candidates padded where k_s < k_eff, layer
    filters."""
    g = _graph()
    jg = JaxGraph(JaxConfig(**CFG_KW), _JEMB)
    flat = VectorStore(g, min_capacity=8, **CPU)
    sharded = ShardedVectorStore(g, n_shards=8, min_capacity=8, **CPU)
    ref = jstore.ShardedVectorStore(jg, n_shards=8, min_capacity=8)
    q = _queries(15, n=2)
    assert sharded.search_batch(q, 5) == [[], []]
    assert sharded.size == 0
    g.insert_chunks(_chunks(15, 3))
    jg.insert_chunks(_chunks(15, 3, JaxChunk))
    assert sum(sh.count == 0 for sh in sharded._shards) > 0  # empty shards
    _assert_bitwise(sharded, flat, q, k=2)
    g.insert_chunks(_chunks(16, 40))
    jg.insert_chunks(_chunks(16, 40, JaxChunk))
    assert sharded.search_batch(np.zeros((0, CFG.embed_dim)), 5) == []
    assert sharded.search_batch(q, 0) == [[], []]
    cap = sharded._group.capacity
    k_big = sharded.size + 5
    assert k_big > cap       # every shard pads its candidates
    for k in (cap - 1, cap + 3, k_big):
        _assert_bitwise(sharded, flat, q, k=k)
        _assert_near(sharded, ref, q, k=k)
    for hits in sharded.search_batch(q, k_big):
        assert len(hits) == sharded.size
    with pytest.raises(ValueError):
        sharded.search_batch(np.zeros((3,)), 5)
    assert sharded.size == flat.size == len(g.nodes)


def test_seq_renumbering_near_int32_limit_preserves_parity():
    """The global sequence counter renumbers itself before reaching
    the int32 merge range; order, flat parity, the JAX store's numbers
    and the device sequence plane must survive the rewrite."""
    g = _graph()
    jg = JaxGraph(JaxConfig(**CFG_KW), _JEMB)
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=4, **CPU)
    ref = jstore.ShardedVectorStore(jg, n_shards=4)
    g.insert_chunks(_chunks(17, 40))
    jg.insert_chunks(_chunks(17, 40, JaxChunk))
    queries = _queries(17)
    _assert_bitwise(sharded, flat, queries)
    for store in (flat, sharded, ref):
        store.refresh()
        store._next_seq = tstore._SEQ_LIMIT - 1
    g.insert_chunks(_chunks(18, 20))
    jg.insert_chunks(_chunks(18, 20, JaxChunk))
    _assert_bitwise(sharded, flat, queries)
    _assert_near(sharded, ref, queries)
    assert sharded._next_seq == ref._next_seq < tstore._SEQ_LIMIT // 2
    for sh in sharded._shards:
        assert all(int(sh.row_seq[r]) < sharded._next_seq
                   for r in range(sh.count))
        np.testing.assert_array_equal(
            sharded._group.seq_view(sh.slot)[:sh.count].numpy(),
            sh.row_seq[:sh.count])


# ---------------------------------------------------------------------------
# snapshots, both ways between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax",
                                       "jax_to_port"])
def test_snapshot_roundtrip_between_packages(direction, quantized):
    qkw = dict(quantized=quantized, scan_bits=64, scan_seed=3)
    g = _graph()
    jg = JaxGraph(JaxConfig(**CFG_KW), _JEMB)
    port = ShardedVectorStore(g, n_shards=4, **qkw, **CPU)
    ref = jstore.ShardedVectorStore(jg, n_shards=4, **qkw)
    g.insert_chunks(_chunks(16, 50))
    jg.insert_chunks(_chunks(16, 50, JaxChunk))
    queries = _queries(16)
    src = ref if direction == "jax_to_port" else port
    state = src.state_dict()
    assert state["kind"] == "sharded" and state["n_shards"] == 4
    assert state["quant"]["quantized"] == quantized
    if direction == "port_to_jax":
        back = jstore.ShardedVectorStore.from_state(state, jg)
        _assert_near(port, back, queries,
                     tol=QUANT_TOL if quantized else JAX_TOL)
    else:
        back = ShardedVectorStore.from_state(state, g, **CPU)
        assert back.quantized == quantized
        _assert_bitwise(back, port, queries)
        if direction == "jax_to_port":
            _assert_near(back, ref, queries,
                         tol=QUANT_TOL if quantized else JAX_TOL)
    assert back.stats.full_rebuilds == 0
    assert back.stats.rows_staged == 0   # restored, not replayed


# ---------------------------------------------------------------------------
# quantized sharded scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_quantized_sharded_matches_jax_and_exact_at_full_coverage(
        n_shards):
    """C clamps per shard, so the quantized sharded result is the JAX
    sharded store's (ids equal, scores within 1e-5), and at C = cap the
    exact sharded store's, bitwise."""
    qkw = dict(quantized=True, scan_bits=64, scan_seed=7, coarse_mult=2)
    queries = _queries(9)

    def stores_for(g, jg):
        return (ShardedVectorStore(g, n_shards=n_shards, **qkw, **CPU),
                ShardedVectorStore(g, n_shards=n_shards, **CPU),
                jstore.ShardedVectorStore(jg, n_shards=n_shards, **qkw))

    def check(stores):
        quant, exact, ref = stores
        _assert_near(quant, ref, queries, tol=QUANT_TOL)
        quant.coarse_mult = FULL
        _assert_bitwise(quant, exact, queries)
        quant.coarse_mult = 2

    _, _, (quant, exact, ref) = _run_script(9, stores_for, check)
    assert quant.stats.quantized_scans > 0
    assert _stats(quant.stats) == _stats(ref.stats)
    for sh in quant._shards:    # the codes ride compaction row-aligned
        np.testing.assert_array_equal(
            quant._group.codes_view(sh.slot).numpy().view(np.uint32),
            np.asarray(ref._group.codes_view(sh.slot)))


# ---------------------------------------------------------------------------
# lifecycle: reshard == fresh build at the target count
# ---------------------------------------------------------------------------

def _churned(n_shards, seed, compact_threshold=0.05):
    g = _graph()
    store = ShardedVectorStore(g, n_shards=n_shards,
                               compact_threshold=compact_threshold, **CPU)
    chunks = _chunks(seed, 70)
    for i in range(0, len(chunks), 16):   # staged: summary churn
        g.insert_chunks(chunks[i:i + 16])
        store.refresh()
    return g, store


@pytest.mark.parametrize("n_from,n_to", [(3, 5), (4, 2), (2, 7)])
def test_reshard_matches_fresh_build_and_jax(n_from, n_to):
    g, store = _churned(n_from, n_from)
    jg = JaxGraph(JaxConfig(**CFG_KW), _JEMB)
    ref = jstore.ShardedVectorStore(jg, n_shards=n_from,
                                    compact_threshold=0.05)
    jchunks = _chunks(n_from, 70, JaxChunk)
    for i in range(0, len(jchunks), 16):
        jg.insert_chunks(jchunks[i:i + 16])
        ref.refresh()
    queries = _queries(n_from)
    assert store.stats.rows_tombstoned > 0

    out = Resharder().reshard(store, n_to)
    JaxResharder().reshard(ref, n_to)
    assert out is store and store.n_shards == n_to
    assert store.epoch == 1 and store.stats.reshards == 1
    _assert_matches_fresh(store, g, queries, n_to)
    _assert_near(store, ref, queries)
    assert _stats(store.stats) == _stats(ref.stats)

    g.insert_chunks(_chunks(n_from + 100, 25))
    jg.insert_chunks(_chunks(n_from + 100, 25, JaxChunk))
    store.refresh()
    assert store.stats.full_rebuilds == 0
    _assert_matches_fresh(store, g, queries, n_to)
    _assert_near(store, ref, queries)


def test_reshard_to_flat_and_back():
    g = _graph()
    store = ShardedVectorStore(g, n_shards=3, **CPU)
    g.insert_chunks(_chunks(11, 50))
    queries = _queries(11)
    oracle = VectorStore(g, **CPU)
    flat = Resharder().reshard(store, 1)
    assert isinstance(flat, VectorStore)
    assert flat.epoch == store.epoch + 1 and flat.stats.reshards == 1
    _assert_bitwise(flat, oracle, queries, seqs=False)
    sharded = Resharder().reshard(flat, 4)
    assert isinstance(sharded, ShardedVectorStore)
    assert sharded.n_shards == 4 and sharded.epoch == flat.epoch + 1
    _assert_matches_fresh(sharded, g, queries, 4)
    g.insert_chunks(_chunks(12, 15))
    sharded.refresh()
    assert sharded.stats.full_rebuilds == 0
    _assert_matches_fresh(sharded, g, queries, 4)
    _assert_bitwise(sharded, oracle, queries, seqs=False)


def test_queries_mid_migration_serve_old_epoch():
    g = _graph()
    store = ShardedVectorStore(g, n_shards=2, **CPU)
    g.insert_chunks(_chunks(21, 60))
    queries = _queries(21)
    store.refresh()
    before = [_exact(h) for h in store.search_batch(queries, 6)]
    mig = Resharder().begin(store, 5, "test")
    assert mig.staging.n_shards == 5 and mig.plan.n_to == 5
    while not mig.done:
        mig.step()
        rets = collapsed_search_batch(g, store, queries, 6,
                                      CFG.token_budget)
        assert [_exact(r.hits) for r in rets] == before
        assert [r.epoch for r in rets] == [0] * len(queries)
        assert store.epoch == 0 and store.migration is None
    assert len(mig.state_dict()["built"]) == 5
    mig.install()
    assert store.epoch == 1 and store.cache_token[0] == 1
    rets = collapsed_search_batch(g, store, queries, 6, CFG.token_budget)
    assert [r.epoch for r in rets] == [1] * len(queries)
    _assert_matches_fresh(store, g, queries, 5)


def test_growth_during_migration_replays_into_new_epoch():
    g = _graph()
    store = ShardedVectorStore(g, n_shards=2, **CPU)
    g.insert_chunks(_chunks(31, 40))
    queries = _queries(31)
    store.refresh()
    mig = Resharder().begin(store, 4, "growth-test")
    mig.step()
    g.insert_chunks(_chunks(32, 20))   # grows the OLD epoch
    store.refresh()
    mig.run()
    mig.install()
    store.refresh()                    # the tail into the new epoch
    assert store.stats.full_rebuilds == 0
    _assert_matches_fresh(store, g, queries, 4)


def test_reshard_to_flat_inherits_maintenance_tuning():
    g = _graph()
    store = ShardedVectorStore(g, n_shards=2, compact_threshold=0.05,
                               min_capacity=8, **CPU)
    g.insert_chunks(_chunks(151, 20))
    flat = Resharder().reshard(store, 1)
    assert isinstance(flat, VectorStore)
    assert flat._compact_threshold == store._compact_threshold
    assert flat._group.min_capacity == 8
    assert flat.device == store.device


# ---------------------------------------------------------------------------
# from_state: snapshot / config shard-count disagreement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_to", [1, 2, 6])
def test_from_state_shard_mismatch_replays(n_to):
    g = _graph()
    store = ShardedVectorStore(g, n_shards=4, **CPU)
    g.insert_chunks(_chunks(81, 50))
    state = store.state_dict()
    queries = _queries(81)
    g2 = EraGraph.from_state(g.state_dict(), _EMB, **CPU)
    restored = store_from_state(state, g2, n_shards=n_to, **CPU)
    if n_to == 1:
        assert isinstance(restored, VectorStore)
    else:
        assert isinstance(restored, ShardedVectorStore)
        assert restored.n_shards == n_to
    assert restored.stats.full_rebuilds == 0
    _assert_matches_fresh(restored, g2, queries, n_to)
    staged0 = restored.stats.rows_staged
    rep = g2.insert_chunks(_chunks(82, 5))
    restored.refresh()
    assert restored.stats.full_rebuilds == 0
    assert restored.stats.rows_staged - staged0 <= 5 + rep.n_resummarized
    _assert_matches_fresh(restored, g2, queries, n_to)


def test_from_state_explicit_classmethod_mismatch():
    g = _graph()
    store = ShardedVectorStore(g, n_shards=3, **CPU)
    g.insert_chunks(_chunks(91, 40))
    state = store.state_dict()
    restored = ShardedVectorStore.from_state(state, g, n_shards=5, **CPU)
    assert restored.n_shards == 5
    _assert_matches_fresh(restored, g, _queries(91), 5)
    same = ShardedVectorStore.from_state(state, g, **CPU)
    assert same.n_shards == 3


def test_flat_snapshot_restores_into_sharded():
    g = _graph()
    flat = VectorStore(g, **CPU)
    g.insert_chunks(_chunks(95, 40))
    restored = store_from_state(flat.state_dict(), g, n_shards=4, **CPU)
    assert isinstance(restored, ShardedVectorStore)
    _assert_matches_fresh(restored, g, _queries(95), 4)
    _assert_bitwise(restored, flat, _queries(95))


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index_shards", [0, 2, 4, 8])
def test_facade_serves_index_shards(index_shards):
    cfg = EraRAGConfig(**{**CFG_KW, "index_shards": index_shards})
    rag = EraRAG(cfg, _EMB, **CPU)
    assert isinstance(rag.store, ShardedVectorStore)
    # 0 = one shard per device of the store's device type: 1 on the CPU
    assert rag.store.n_shards == (index_shards or 1)
    assert rag.store.collective and not rag.store.collective_active
    rag.insert_docs([(f"doc{i}", f"Document {i} about " +
                      " ".join(_WORDS[(i + j) % 10] for j in range(20)))
                     for i in range(6)])
    assert all(r.hits for r in rag.query_batch(["document alpha?"] * 3))


def test_erarag_reshard_facade():
    rag = EraRAG(EraRAGConfig(**{**CFG_KW, "index_shards": 3}), _EMB,
                 **CPU)
    rag.insert_docs([(f"doc{i}", f"Document {i} about " +
                      " ".join(_WORDS[(i + j) % 10] for j in range(20)))
                     for i in range(12)])
    queries = _queries(71)
    before = [_exact(h) for h in rag.store.search_batch(queries, 6)]
    token = rag.store.cache_token
    store = rag.reshard(5)
    assert store is rag.store and store.n_shards == 5
    assert rag.cfg.index_shards == 5
    assert store.cache_token == (token[0] + 1, token[1])
    assert store.tracer is rag.obs.tracer
    _assert_matches_fresh(store, rag.graph, queries, 5)
    assert [_exact(h) for h in rag.store.search_batch(queries, 6)] == \
        before
    flat = rag.reshard(1)
    assert isinstance(flat, VectorStore) and rag.cfg.index_shards == 1
    assert [_exact(h) for h in flat.search_batch(queries, 6)] == before
    back = rag.reshard(2)
    assert isinstance(back, ShardedVectorStore) and back.epoch == 3
    assert [_exact(h) for h in back.search_batch(queries, 6)] == before


def test_policy_and_thresholds_still_raise():
    """The lifecycle policy, once unported and raising, is served: the
    thresholds attach it, a refresh consults it and starts a migration,
    and ``None`` detaches it (the policy cases themselves are in
    ``tests/test_torch_lifecycle.py``)."""
    from repro_torch.lifecycle import LifecyclePolicy
    g = _graph()
    store = ShardedVectorStore(g, n_shards=2, **CPU)
    store.attach_lifecycle(None)
    assert store._policy is None
    for kw in ({"reshard_skew_threshold": 1.5},
               {"reshard_tombstone_threshold": 0.2}):
        cfg = EraRAGConfig(**{**CFG_KW, "index_shards": 2, **kw})
        rag = EraRAG(cfg, _EMB, **CPU)
        assert rag.store._policy == LifecyclePolicy.from_config(cfg)
    g.insert_chunks(_chunks(23, 30))
    store.attach_lifecycle(LifecyclePolicy(skew_threshold=1e-6,
                                           min_rows=1, max_shards=4))
    store.refresh()
    assert store.migration is not None and store.migration.plan.n_to == 4
    store.attach_lifecycle(None)
    while store.migration is not None:   # a detached policy lets the
        store.refresh()                  # migration in flight finish
    assert store.n_shards == 4 and store.migration is None
    _assert_matches_fresh(store, g, _queries(23), 4)


# ---------------------------------------------------------------------------
# the quickstart with index_shards = 4, both packages
# ---------------------------------------------------------------------------

QUICKSTART = dict(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                  max_layers=3, chunk_tokens=32, top_k=8,
                  token_budget=1024, index_shards=4)
MODES = ("collapsed", "detailed", "summarized", "multihop")


@pytest.fixture(scope="module", params=[False, True],
                ids=["exact", "quantized"])
def quickstart_pair(request):
    kw = dict(QUICKSTART, quantized_scan=request.param)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 3)
    jax_rag = JaxRAG(JaxConfig(**kw), JaxEmbedder(dim=128))
    port = EraRAG(EraRAGConfig(**kw), HashingEmbedder(dim=128), **CPU)
    for docs in [init] + rounds:
        jax_rag.insert_docs(docs)
        port.insert_docs(docs)
    return corpus, jax_rag, port, request.param


@pytest.mark.parametrize("mode", MODES)
def test_quickstart_sharded_matches_jax(quickstart_pair, mode):
    corpus, jax_rag, port, quantized = quickstart_pair
    assert list(jax_rag.graph.nodes) == list(port.graph.nodes)
    assert port.store.n_shards == jax_rag.store.n_shards == 4
    questions = [qa.question for qa in corpus.qa[:20]]
    tol = QUANT_TOL if quantized else JAX_TOL
    for a, b in zip(jax_rag.query_batch(questions, mode=mode),
                    port.query_batch(questions, mode=mode)):
        assert _ids(a.hits) == _ids(b.hits)
        np.testing.assert_allclose([h.score for h in b.hits],
                                   [h.score for h in a.hits],
                                   rtol=0, atol=tol)
        assert (a.context, a.n_tokens, a.epoch) == \
            (b.context, b.n_tokens, b.epoch)
    if mode == "collapsed":
        pj, pt = JaxPipeline(jax_rag), RAGPipeline(port)
        assert [pj.answer(q).answer for q in questions[:8]] == \
            [pt.answer(q).answer for q in questions[:8]]
        assert (port.store.stats.quantized_scans > 0) == quantized
