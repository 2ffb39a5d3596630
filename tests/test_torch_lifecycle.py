"""The index lifecycle in the PyTorch port (``lifecycle/{policy,manager}``
and the store's policy path), held against the JAX package on the CPU.

Each policy case runs the same chunks through a port store and a JAX
store in lockstep and compares them at every ``refresh()`` turn: the
plans, the migration's progress, epochs and shard counts, the store
counters, and the hits (ids, layers, sequence numbers and order equal,
scores within 1e-6, the reference's own batch drift).  Each resharded
port store is also held bitwise to a store freshly built at the target
count.  These are the policy and manager cases of
``tests/test_lifecycle.py`` (the explicit ``Resharder`` cases are in
``tests/test_torch_sharded.py``): one target shard per ``refresh()``,
old-epoch serving mid-migration, growth during a migration replayed
into the new epoch, the tombstone trigger, an explicit reshard
pre-empting a policy migration, small and flat stores ignored,
``max_shards`` falling through to the tombstone trigger, the config's
thresholds and growth factor.  The manager cases snapshot a
half-built migration and resume or replay it, in each package and
across them.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core import store as jstore
from repro.core.erarag import EraRAG as JaxRAG
from repro.core.graph import EraGraph as JaxGraph
from repro.data.chunker import Chunk as JaxChunk
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.lifecycle import LifecycleManager as JaxManager, \
    LifecyclePolicy as JaxPolicy, Resharder as JaxResharder
from repro.obs import Tracer as JaxTracer

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.graph import EraGraph
from repro_torch.core.retrieve import collapsed_search_batch
from repro_torch.core.store import ShardedVectorStore, VectorStore
from repro_torch.data.chunker import Chunk
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.lifecycle import LifecycleManager, LifecyclePolicy, \
    Resharder, ShardLoadReport
from repro_torch.obs import Tracer

pytestmark = pytest.mark.lifecycle

JAX_TOL = 1e-6      # the reference's batch-size drift (a reference gap)
QUANT_TOL = 1e-5    # the quantized slice's tolerance
FILTERS = (None, "leaf", "summary")
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


def _bits(score: float) -> int:
    return int(np.float32(score).view(np.uint32))


def _exact(hits, seqs=True):
    return [(h.node_id, h.layer, h.seq if seqs else None, _bits(h.score))
            for h in hits]


def _ids(hits):
    return [(h.node_id, h.layer, h.seq) for h in hits]


def _assert_bitwise(a, b, queries, k=6, seqs=True):
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
    out = dataclasses.asdict(stats)
    for key in ("kernel_launches", "quantized_scans"):
        out.pop(key)
    return out


class Twin:
    """A port store and a JAX store over graphs fed the same chunks."""

    def __init__(self, n_shards: int, **kw):
        self.g = EraGraph(CFG, _EMB, **CPU)
        self.jg = JaxGraph(JaxConfig(**CFG_KW), _JEMB)
        self.store = ShardedVectorStore(self.g, n_shards=n_shards,
                                        **kw, **CPU)
        self.ref = jstore.ShardedVectorStore(self.jg, n_shards=n_shards,
                                             **kw)

    def insert(self, seed: int, n: int, step: int = 0) -> None:
        port, ref = _chunks(seed, n), _chunks(seed, n, JaxChunk)
        step = step or n
        for i in range(0, n, step):
            self.g.insert_chunks(port[i:i + step])
            self.jg.insert_chunks(ref[i:i + step])
            if step < n:
                self.refresh()

    def attach(self, **kw) -> None:
        self.store.attach_lifecycle(LifecyclePolicy(**kw))
        self.ref.attach_lifecycle(JaxPolicy(**kw))

    def refresh(self) -> None:
        self.store.refresh()
        self.ref.refresh()

    def assert_same(self, queries) -> None:
        """Lockstep: migration, epoch, shard count, counters, hits."""
        mig, jmig = self.store.migration, self.ref.migration
        assert (mig is None) == (jmig is None)
        if mig is not None:
            assert mig.describe() == jmig.describe()
        assert self.store.epoch == self.ref.epoch
        assert self.store.n_shards == self.ref.n_shards
        assert _stats(self.store.stats) == _stats(self.ref.stats)
        _assert_near(self.store, self.ref, queries)


# ---------------------------------------------------------------------------
# the policy path: refresh() schedules and advances
# ---------------------------------------------------------------------------

def test_policy_migration_advances_one_shard_per_refresh():
    t = Twin(2)
    t.attach(skew_threshold=1.0001, min_rows=10, growth_factor=2)
    t.insert(41, 40)
    queries = _queries(41)
    t.refresh()     # consults the policy -> schedules a migration
    assert t.store.migration is not None and t.store.epoch == 0
    assert t.store.migration.plan.to_dict() == \
        t.ref.migration.plan.to_dict()
    t.assert_same(queries)
    steps = 0
    while t.store.epoch == 0:
        t.store.search_batch(queries, 6)
        t.ref.search_batch(queries, 6)
        # queries in between are served (old epoch) without advancing
        assert t.store.migration is None or not t.store.migration.done
        t.refresh()
        steps += 1
        t.assert_same(queries)
        assert steps <= 8, "migration never committed"
    assert steps == 4    # 4 target shards -> 4 step turns
    assert t.store.n_shards == 4
    assert t.store.stats.reshard_steps == 4
    assert t.store.stats.reshards == 1
    _assert_matches_fresh(t.store, t.g, queries, 4)


def test_queries_mid_policy_migration_serve_old_epoch():
    """Version-synced queries never advance a migration: between turns
    every answer is the old epoch's, bitwise, and stamped with it."""
    t = Twin(2)
    t.insert(21, 60)
    t.refresh()
    queries = _queries(21)
    before = [_exact(h) for h in t.store.search_batch(queries, 6)]
    t.attach(skew_threshold=1e-6, min_rows=1, max_shards=5,
             growth_factor=3)
    t.refresh()
    assert t.store.migration.plan.n_to == 5
    while t.store.migration is not None:
        for _ in range(3):     # queries alone never move the migration
            rets = collapsed_search_batch(t.g, t.store, queries, 6,
                                          CFG.token_budget)
            assert [_exact(r.hits) for r in rets] == before
            assert [r.epoch for r in rets] == [0] * len(queries)
        built = len(t.store.migration.built)
        t.store.search_batch(queries, 6)
        assert len(t.store.migration.built) == built
        assert ShardLoadReport.from_store(t.store).migration == \
            t.store.migration.describe()
        t.refresh()
        t.assert_same(queries)
    assert t.store.epoch == 1 and t.store.n_shards == 5
    rets = collapsed_search_batch(t.g, t.store, queries, 6,
                                  CFG.token_budget)
    assert [r.epoch for r in rets] == [1] * len(queries)
    assert [_exact(r.hits, False) for r in rets] == \
        [_exact(h, False) for h in t.store.search_batch(queries, 6)]
    _assert_matches_fresh(t.store, t.g, queries, 5)


def test_growth_during_policy_migration_replays_into_new_epoch():
    t = Twin(2)
    t.attach(skew_threshold=1.0001, min_rows=10)
    t.insert(31, 40)
    queries = _queries(31)
    t.refresh()
    assert t.store.migration is not None
    t.refresh()                 # one target shard built
    t.insert(32, 20)            # grows the OLD epoch mid-migration
    while t.store.epoch == 0:
        t.refresh()
        t.assert_same(queries)
    t.refresh()
    t.assert_same(queries)
    assert t.store.stats.full_rebuilds == 0
    _assert_matches_fresh(t.store, t.g, queries, 4)


def test_policy_tombstone_trigger_replays_at_same_width():
    # threshold 1.0 never compacts a shard, so tombstones pile up
    t = Twin(3, compact_threshold=1.0)
    t.insert(51, 60, step=12)
    assert sum(sh.n_dead for sh in t.store._shards) > 0
    queries = _queries(51)
    t.attach(tombstone_threshold=0.05, min_rows=10)
    t.refresh()
    assert t.store.migration is not None, ShardLoadReport.from_store(
        t.store)
    assert "tombstone" in t.store.migration.plan.reason
    while t.store.epoch == 0:
        t.refresh()
        t.assert_same(queries)
    assert t.store.n_shards == 3
    assert sum(sh.n_dead for sh in t.store._shards) == 0
    _assert_matches_fresh(t.store, t.g, queries, 3)


def test_explicit_reshard_preempts_policy_migration():
    t = Twin(2)
    t.attach(skew_threshold=1e-6, min_rows=10, max_shards=4)
    t.insert(65, 40)
    queries = _queries(65)
    t.refresh()
    assert t.store.migration is not None   # the policy scheduled 2 -> 4
    out = Resharder().reshard(t.store, 3)  # explicit pre-empts
    JaxResharder().reshard(t.ref, 3)
    assert out is t.store and t.store.n_shards == 3
    assert t.store.epoch == 1 and t.store._policy is not None
    t.assert_same(queries)
    _assert_matches_fresh(t.store, t.g, queries, 3)


def test_policy_ignores_small_and_flat_stores():
    t = Twin(2)
    t.attach(skew_threshold=1.0001, min_rows=10 ** 6)
    t.insert(61, 30)
    t.refresh()
    assert t.store.migration is None and t.ref.migration is None
    flat = VectorStore(t.g, **CPU)
    flat.attach_lifecycle(LifecyclePolicy(skew_threshold=1.0001,
                                          min_rows=1))
    flat.refresh()
    assert flat.migration is None      # flat stores don't self-reshard
    assert LifecyclePolicy(skew_threshold=1.0, min_rows=1) \
        .decide(flat) is None
    flat.attach_lifecycle(None)
    assert flat._policy is None


def test_skew_trigger_at_max_shards_falls_through_to_tombstone():
    t = Twin(2, compact_threshold=1.0)
    t.insert(55, 40, step=8)
    assert sum(sh.n_dead for sh in t.store._shards) > 0
    skew = ShardLoadReport.from_store(t.store).skew
    cases = [dict(skew_threshold=1e-6, tombstone_threshold=0.01,
                  min_rows=10, max_shards=2),
             dict(skew_threshold=1e-6, min_rows=10, max_shards=2),
             dict(skew_threshold=1e-6, min_rows=10, max_shards=8,
                  growth_factor=3)]
    plans = [LifecyclePolicy(**kw).decide(t.store) for kw in cases]
    want = [JaxPolicy(**kw).decide(t.ref) for kw in cases]
    assert skew > 1e-6
    assert [p and p.to_dict() for p in plans] == \
        [p and p.to_dict() for p in want]
    assert plans[0].n_from == plans[0].n_to == 2
    assert "tombstone" in plans[0].reason
    assert plans[1] is None
    assert plans[2].n_to == 6     # 2 * 3


# ---------------------------------------------------------------------------
# the facade and the config
# ---------------------------------------------------------------------------

def _docs(n):
    return [(f"doc{i}", f"Document {i} about " +
             " ".join(_WORDS[(i + j) % len(_WORDS)] for j in range(20)))
            for i in range(n)]


@pytest.mark.parametrize("kw,n_to", [
    ({"reshard_skew_threshold": 1.0001}, 4),
    ({"reshard_skew_threshold": 1e-6, "reshard_growth_factor": 4}, 8),
    ({"reshard_tombstone_threshold": 1e-6}, 2)],
    ids=["skew", "growth-factor-4", "tombstone"])
def test_config_thresholds_attach_policy(kw, n_to):
    full = {**CFG_KW, "index_shards": 2, "reshard_min_rows": 10, **kw}
    rag = EraRAG(EraRAGConfig(**full), _EMB, **CPU)
    jrag = JaxRAG(JaxConfig(**full), _JEMB)
    policy = rag.store._policy
    assert isinstance(policy, LifecyclePolicy)
    assert dataclasses.asdict(policy) == \
        dataclasses.asdict(jrag.store._policy)
    assert policy.growth_factor == full.get("reshard_growth_factor", 2)
    for r in (rag, jrag):
        r.insert_docs(_docs(10))
        if "reshard_tombstone_threshold" in kw:
            r.store.refresh()
            r.remove_docs(["doc0", "doc1"])     # tombstones
    rag.store.refresh()
    jrag.store.refresh()
    assert rag.store.migration is not None
    assert rag.store.migration.plan.to_dict() == \
        jrag.store.migration.plan.to_dict()
    assert rag.store.migration.plan.n_to == n_to
    while rag.store.epoch == 0:
        rag.store.refresh()
        jrag.store.refresh()
    assert rag.store.n_shards == jrag.store.n_shards == n_to
    queries = _queries(72)
    _assert_matches_fresh(rag.store, rag.graph, queries, n_to)
    _assert_near(rag.store, jrag.store, queries)
    # the facade re-attaches the policy after an explicit reshard
    rag.reshard(3)
    assert rag.store._policy is not None
    with pytest.raises(ValueError):
        EraRAGConfig(reshard_skew_threshold=-1.0)
    with pytest.raises(ValueError):
        EraRAGConfig(reshard_growth_factor=1)


def test_from_state_attaches_the_config_policy():
    full = {**CFG_KW, "index_shards": 2, "reshard_skew_threshold": 1.5}
    rag = EraRAG(EraRAGConfig(**full), _EMB, **CPU)
    rag.insert_docs(_docs(6))
    state = rag.state_dict(include_store=True)
    back = EraRAG.from_state(state, _EMB, **CPU)
    assert isinstance(back.store._policy, LifecyclePolicy)
    assert back.store._policy.skew_threshold == 1.5
    assert EraRAG(CFG, _EMB, **CPU).store._policy is None


def test_reshard_spans_and_counters_match_reference():
    t = Twin(2)
    t.store.tracer, t.ref.tracer = Tracer(), JaxTracer()
    t.attach(skew_threshold=1.0001, min_rows=10)
    t.insert(43, 40)
    while t.store.epoch == 0:
        t.refresh()
    spans = [[(s.name, s.attrs) for s in tr.spans
              if s.name.startswith("reshard")]
             for tr in (t.store.tracer, t.ref.tracer)]
    assert spans[0] == spans[1]
    assert [n for n, _ in spans[0]] == ["reshard_step"] * 4 + \
        ["reshard_install"]
    assert spans[0][-1][1] == {"old_epoch": 0, "new_epoch": 1}
    assert t.store.stats.reshard_steps == t.ref.stats.reshard_steps == 4


# ---------------------------------------------------------------------------
# epoch snapshots: resume or replay a half-built migration
# ---------------------------------------------------------------------------

def _half_built(t, built: int = 1):
    """A 2 -> 4 migration handed to the refresh loop, ``built`` of its
    target shards staged, in both stores of the twin."""
    t.insert(111, 40)
    t.refresh()
    for store, resharder in ((t.store, Resharder()),
                             (t.ref, JaxResharder())):
        mig = resharder.begin(store, 4, "snapshot-test")
        store._migration = mig
        for _ in range(built):
            mig.step()


@pytest.mark.parametrize("resume", [True, False])
def test_manager_snapshot_restores_half_finished_migration(tmp_path,
                                                           resume):
    t = Twin(2)
    _half_built(t)
    queries = _queries(111)
    mgr = LifecycleManager(t.store, tmp_path)
    assert mgr.snapshot(block=True) == 1
    restored = mgr.restore(t.g, resume=resume)
    assert restored is mgr.store and restored.device.type == "cpu"
    assert restored.migration is not None
    assert len(restored.migration.built) == (1 if resume else 0)
    turns = 0
    while restored.epoch == 0:
        restored.refresh()
        turns += 1
        assert turns <= 6
    assert turns == (3 if resume else 4)   # resumed shards are free
    assert restored.n_shards == 4
    _assert_matches_fresh(restored, t.g, queries, 4)
    # bitwise the unbroken migration
    while t.store.epoch == 0:
        t.store.refresh()
    _assert_bitwise(restored, t.store, queries)


def test_manager_snapshot_roundtrip_without_migration(tmp_path):
    t = Twin(3)
    t.insert(121, 30)
    t.refresh()
    t.store.epoch = 2   # pretend two reshards happened
    mgr = LifecycleManager(t.store, tmp_path)
    mgr.snapshot()          # async
    mgr.wait()
    restored = mgr.restore(t.g)
    assert restored.epoch == 2 and restored.migration is None
    _assert_matches_fresh(restored, t.g, _queries(121), 3)
    _assert_bitwise(restored, t.store, _queries(121))
    for _ in range(4):
        mgr.snapshot(block=True)
    assert len(mgr.ckpt.steps()) == 3   # keep-rotation
    assert mgr.report().n_shards == 3


def test_manager_async_snapshots_never_collide(tmp_path):
    t = Twin(2)
    t.insert(141, 20)
    t.refresh()
    mgr = LifecycleManager(t.store, tmp_path)
    steps = [mgr.snapshot() for _ in range(3)]
    mgr.wait()
    assert steps == [1, 2, 3]
    assert mgr.ckpt.steps() == [1, 2, 3]


def test_manager_carries_the_policy_and_restores_flat(tmp_path):
    t = Twin(2)
    t.insert(151, 30)
    t.refresh()
    policy = LifecyclePolicy(skew_threshold=1e-6, min_rows=1,
                             max_shards=4)
    mgr = LifecycleManager(t.store, tmp_path / "sharded", policy=policy)
    assert t.store._policy is policy
    mgr.snapshot(block=True)
    restored = mgr.restore(t.g)
    assert restored._policy is policy
    restored.refresh()       # the carried policy triggers on restore
    assert restored.migration.plan.n_to == 4
    flat = VectorStore(t.g, **CPU)
    fmgr = LifecycleManager(flat, tmp_path / "flat")
    fmgr.snapshot(block=True)
    back = fmgr.restore(t.g, n_shards=3)
    assert isinstance(back, ShardedVectorStore) and back.n_shards == 3
    _assert_matches_fresh(back, t.g, _queries(151), 3)


@pytest.mark.parametrize("resume", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_crosses_packages_and_resumes(tmp_path, writer, resume):
    """A half-built migration snapshot taken by one package restores in
    the other, resumes (or replays) there, and lands on the same hits
    as the writer's own restore."""
    t = Twin(2)
    _half_built(t, built=2)
    queries = _queries(111)
    if writer == "jax":
        JaxManager(t.ref, tmp_path).snapshot(block=True)
    else:
        LifecycleManager(t.store, tmp_path).snapshot(block=True)
    port = LifecycleManager(t.store, tmp_path).restore(t.g, resume=resume)
    ref = JaxManager(t.ref, tmp_path).restore(t.jg, resume=resume)
    assert len(port.migration.built) == len(ref.migration.built) == \
        (2 if resume else 0)
    assert port.migration.describe() == ref.migration.describe()
    turns = 0
    while port.epoch == 0:
        port.refresh()
        ref.refresh()
        turns += 1
    assert turns == (2 if resume else 4)
    assert ref.epoch == port.epoch == 1
    assert port.n_shards == ref.n_shards == 4
    _assert_near(port, ref, queries)
    _assert_matches_fresh(port, t.g, queries, 4)


def test_quantized_store_restores_exact_unless_asked(tmp_path):
    """A reference gap the port keeps: a snapshot holds no ``quant``
    entry, so a quantized store restores exact unless the caller passes
    the scan settings; with them, its hits equal the live store's."""
    qkw = dict(quantized=True, coarse_mult=4, scan_bits=64, scan_seed=0)
    t = Twin(2, **qkw)
    _half_built(t, built=1)
    queries = _queries(111)
    mgr = LifecycleManager(t.store, tmp_path)
    mgr.snapshot(block=True)
    exact = mgr.restore(t.g)
    jexact = JaxManager(t.ref, tmp_path).restore(t.jg)
    assert exact.quantized is False and jexact.quantized is False
    assert exact.migration.staging.quantized is False
    quant = mgr.restore(t.g, **qkw)
    assert quant.quantized and quant.migration.staging.quantized
    while quant.epoch == 0:
        quant.refresh()
        t.store.refresh()
    _assert_bitwise(quant, t.store, queries)
    jquant = JaxManager(t.ref, tmp_path).restore(t.jg, **qkw)
    while jquant.epoch == 0:
        jquant.refresh()
    _assert_near(quant, jquant, queries, tol=QUANT_TOL)
