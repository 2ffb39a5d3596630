"""The sharded store's collective query over a process group, on the CPU:
four gloo ranks, each holding one slot of the stacked buffer.

The cases of ``tests/test_store_collective.py``, ported to
``repro_torch.launch.mesh``'s ``DataGroup``: the collective's hits
(node ids, layers, sequence numbers, score bits) equal the loop route's
and the flat store's across appends, tombstones, layer filters and
compaction, the quantized collective equals the quantized loop, and
reshards, snapshots and the ``EraRAG`` facade on the group give what they
give without one.  Every rank returns the same hits.  The JAX package's
own mesh path fails under JAX 0.9.0 (a reference gap), so the collective
is held within 1e-6 of its mesh-free loop, ids equal.

The ranks are spawned once for the module (``run_ranks``): the workers
below run every case on every rank and return plain records, which the
tests check in the parent.  This module imports only ``repro_torch`` at
its top level, since each spawned rank imports it; the JAX package is
imported inside the parent-side tests.
"""
import time
import uuid

import numpy as np
import pytest

from repro_torch.common.config import EraRAGConfig
from repro_torch.core import store as tstore
from repro_torch.core.erarag import EraRAG
from repro_torch.core.graph import EraGraph
from repro_torch.core.store import ShardedVectorStore, VectorStore
from repro_torch.data.chunker import Chunk
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.launch.mesh import local_data_group, run_ranks
from repro_torch.lifecycle import LifecycleManager, Resharder
from torch_threads import one_blas_thread  # noqa: F401

WORLD = 4
JAX_TOL = 1e-6      # the reference's batch-size drift (a reference gap)
FULL = 10 ** 6      # coarse_mult that clamps C to the capacity
FILTERS = (None, "leaf", "summary")
MODES = ("collapsed", "detailed", "summarized")
CFG_KW = dict(embed_dim=64, n_hyperplanes=10, s_min=3, s_max=9,
              max_layers=3, chunk_tokens=32)
CFG = EraRAGConfig(**CFG_KW)
_EMB = HashingEmbedder(dim=CFG.embed_dim)
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


def _queries(n: int = 4) -> np.ndarray:
    texts = [f"what does chunk {i} say about "
             f"{_WORDS[i % len(_WORDS)]}?" for i in range(n)]
    return np.asarray(_EMB.encode(texts), np.float32)


def _graph():
    return EraGraph(CFG, _EMB, **CPU)


def _rec(batch, seqs=True):
    """Hits as plain tuples: (node id, layer, sequence, score bits)."""
    return [[(h.node_id, h.layer, h.seq if seqs else None,
              int(np.float32(h.score).view(np.uint32))) for h in hits]
            for hits in batch]


def _both_paths(store, q, k, filt):
    assert store.collective_active
    coll = _rec(store.search_batch(q, k, filt))
    store.collective = False
    loop = _rec(store.search_batch(q, k, filt))
    store.collective = True
    return coll, loop


def _growth_schedule(seed: int, n: int = 90):
    """The parity cases' insert batches: (chunks, batch sizes)."""
    rng = np.random.default_rng(seed)
    sizes, pos = [], 0
    while pos < n:
        sizes.append(int(rng.integers(1, 20)))
        pos += sizes[-1]
    return sizes


# ---------------------------------------------------------------------------
# the ranks' side: every case, on every rank
# ---------------------------------------------------------------------------

def _parity(group, seed):
    g = _graph()
    flat = VectorStore(g, compact_threshold=0.05, **CPU)
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 compact_threshold=0.05)
    chunks, q, pos, steps = _chunks(seed, 90), _queries(), 0, []
    for bs in _growth_schedule(seed):
        g.insert_chunks(chunks[pos:pos + bs])
        pos += bs
        for filt in FILTERS:
            want = _rec(flat.search_batch(q, 6, filt))
            steps.append((filt, want, *_both_paths(sharded, q, 6, filt)))
    st = sharded.stats
    return {"steps": steps, "full_rebuilds": st.full_rebuilds,
            "rows_tombstoned": st.rows_tombstoned,
            "compactions": st.compactions}


def _renumbering(group):
    g = _graph()
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=4, group=group)
    g.insert_chunks(_chunks(7, 40))
    q = _queries()
    first = (_rec(flat.search_batch(q, 6)), _rec(sharded.search_batch(q, 6)))
    flat._next_seq = tstore._SEQ_LIMIT - 1
    sharded._next_seq = tstore._SEQ_LIMIT - 1
    g.insert_chunks(_chunks(8, 20))
    after = [(_rec(flat.search_batch(q, 6, f)),
              _rec(sharded.search_batch(q, 6, f))) for f in FILTERS]
    return {"first": first, "after": after,
            "next_seq": sharded._next_seq}


def _k_beyond_capacity(group):
    g = _graph()
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 min_capacity=8)
    g.insert_chunks(_chunks(9, 60))
    q = _queries(2)
    return {"flat": _rec(flat.search_batch(q, 10_000)),
            "sharded": _rec(sharded.search_batch(q, 10_000)),
            "size": sharded.size, "capacity": sharded._group.capacity}


def _launches(group):
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, group=group)
    g.insert_chunks(_chunks(3, 60))
    q = _queries()
    sharded.refresh()

    def moved(filt):
        before = (mips_ops.collective_launch_count(),
                  sharded.stats.kernel_launches,
                  mips_ops.merge_launch_count(), mips_ops.launch_count())
        sharded.search_batch(q, 6, filt)
        after = (mips_ops.collective_launch_count(),
                 sharded.stats.kernel_launches,
                 mips_ops.merge_launch_count(), mips_ops.launch_count())
        return [a - b for a, b in zip(after, before)]

    out = {"collective": [moved(None), moved("leaf")]}
    sharded.collective = False
    out["loop"] = moved(None)
    out["nonempty"] = sum(1 for sh in sharded._shards if sh.count)
    out["local_nonempty"] = sum(
        1 for sh in sharded._shards
        if sh.count and sharded._group.holds(sh.slot))
    return out


def _lockstep(group):
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 min_capacity=8)
    rng = np.random.default_rng(11)
    chunks, pos, out = _chunks(11, 40), 0, []
    while pos < len(chunks):
        bs = int(rng.integers(1, 16))
        g.insert_chunks(chunks[pos:pos + bs])
        pos += bs
        sharded.refresh()
        caps = sorted({sh.capacity for sh in sharded._shards})
        out.append((caps, tuple(sharded._group.buf.shape),
                    max(sh.count for sh in sharded._shards)))
    return out


def _uneven(group):
    g = _graph()
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=group.world_size + 1,
                                 group=group)
    g.insert_chunks(_chunks(13, 50))
    sharded.refresh()
    q = _queries()
    return {"n_slots": sharded._group.n_slots,
            "local_slots": sharded._group.buf.shape[0],
            "flat": _rec(flat.search_batch(q, 6)),
            "sharded": _rec(sharded.search_batch(q, 6))}


def _auto_off(group):
    out = {"too_few": local_data_group(min_devices=group.world_size + 1,
                                       device=group.device) is None}
    one = local_data_group(min_devices=1, n_devices=1, device=group.device)
    out["in_one_rank_group"] = one is not None
    g = _graph()
    flat = VectorStore(g, **CPU)
    meshless = ShardedVectorStore(g, n_shards=4, **CPU)
    out["meshless_active"] = meshless.collective_active
    stores = [meshless]
    if one is not None:
        degraded = ShardedVectorStore(g, n_shards=3, group=one)
        out["one_rank_active"] = degraded.collective_active
        out["one_rank_world"] = one.world_size
        stores.append(degraded)
    g.insert_chunks(_chunks(14, 30))
    q = _queries()
    out["flat"] = _rec(flat.search_batch(q, 5))
    out["stores"] = [_rec(s.search_batch(q, 5)) for s in stores]
    return out


def _rotation(group):
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 compact_threshold=0.01)
    flat = VectorStore(g, compact_threshold=0.01, **CPU)
    chunks, q = _chunks(5, 80), _queries()
    per_refresh, pairs, committed_before = [], [], 0
    for i in range(0, len(chunks), 11):
        g.insert_chunks(chunks[i:i + 11])
        sharded.refresh()
        committed = sum(sh.stats.compactions for sh in sharded._shards)
        per_refresh.append(committed - committed_before)
        committed_before = committed
        pairs.append((_rec(flat.search_batch(q, 6)),
                      _rec(sharded.search_batch(q, 6))))
    out = {"per_refresh": per_refresh, "pairs": pairs,
           "compactions": committed_before,
           "skipped": sharded.stats.compactions_skipped}
    sharded.compact()
    flat.compact()
    out["drained"] = (sharded.pending_compaction is None and
                      all(sh.n_dead == 0 for sh in sharded._shards))
    out["after_compact"] = (_rec(flat.search_batch(q, 6)),
                            _rec(sharded.search_batch(q, 6)))
    return out


def _double_buffer(group):
    g = _graph()
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=2 * group.world_size,
                                 group=group, compact_threshold=0.01)
    g.insert_chunks(_chunks(6, 40))
    sharded.refresh()
    s = None
    for seed in range(20, 40):
        g.insert_chunks(_chunks(seed, 9))
        sharded.refresh()
        s = sharded.pending_compaction
        if s is not None:
            break
    sh = sharded._shards[s]
    out = {"staged": s, "dead_before_swap": sh.n_dead}
    buf_before = sharded._group.buf
    q = _queries()
    # the flat store numbers its rows in one rebuild: no sequences
    out["pair"] = (_rec(flat.search_batch(q, 6), False),
                   _rec(sharded.search_batch(q, 6), False))
    out["query_swapped"] = sharded._group.buf is not buf_before
    sharded.refresh()
    out["pending_after"] = sharded.pending_compaction
    out["dead_after_swap"] = sh.n_dead
    out["compactions"] = sh.stats.compactions
    return out


def _quantized(group, coarse_mult):
    g = _graph()
    flat = VectorStore(g, **CPU)
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 quantized=True, coarse_mult=coarse_mult,
                                 compact_threshold=0.05)
    chunks, q, pos, steps = _chunks(21, 70), _queries(), 0, []
    for bs in (20, 7, 30, 13):
        g.insert_chunks(chunks[pos:pos + bs])
        pos += bs
        for filt in FILTERS:
            steps.append((filt, _rec(flat.search_batch(q, 6, filt)),
                          *_both_paths(sharded, q, 6, filt)))
    return {"steps": steps,
            "quantized_scans": sharded.stats.quantized_scans}


def _reshard(group):
    g = _graph()
    sharded = ShardedVectorStore(g, n_shards=4, group=group,
                                 compact_threshold=0.05)
    flat = VectorStore(g, **CPU)
    for seed, n in ((31, 40), (32, 25)):
        g.insert_chunks(_chunks(seed, n))
        sharded.refresh()
    same = Resharder().reshard(sharded, 8) is sharded
    q = _queries()
    fresh = ShardedVectorStore(g, n_shards=8, **CPU)
    fresh.rebuild()
    out = {"same_object": same, "n_shards": sharded.n_shards,
           "epoch": sharded.epoch, "active": sharded.collective_active,
           "local_slots": sharded._group.buf.shape[0],
           "vs_fresh": [(_rec(fresh.search_batch(q, 6, f), False),
                         _rec(sharded.search_batch(q, 6, f), False))
                        for f in FILTERS]}
    g.insert_chunks(_chunks(33, 15))
    out["after_growth"] = [(_rec(flat.search_batch(q, 6, f), False),
                            _rec(sharded.search_batch(q, 6, f), False))
                           for f in FILTERS]
    return out


def _state_digest(state: dict) -> list:
    """A snapshot's content, comparable exactly (the row bytes)."""
    return [state["kind"], state["n_shards"], state["version"],
            state["next_seq"], sorted(state["quant"].items()),
            [(np.asarray(sh["buf"], np.float32).tobytes(),
              list(sh["row_ids"]), np.asarray(sh["row_layers"]).tolist(),
              np.asarray(sh["row_seq"]).tolist(),
              np.asarray(sh["alive"]).tolist())
             for sh in state["shards"]]]


def _snapshots(group, path):
    g = _graph()
    on_group = ShardedVectorStore(g, n_shards=4, group=group,
                                  compact_threshold=0.05)
    plain = ShardedVectorStore(g, n_shards=4, compact_threshold=0.05,
                               **CPU)
    for seed, n in ((41, 45), (42, 20)):
        g.insert_chunks(_chunks(seed, n))
        on_group.refresh()
        plain.refresh()
    q = _queries()
    s_group, s_plain = on_group.state_dict(), plain.state_dict()
    out = {"group_state": _state_digest(s_group),
           "plain_state": _state_digest(s_plain),
           "want": [_rec(plain.search_batch(q, 6, f)) for f in FILTERS]}
    restored = {
        "plain_into_group": ShardedVectorStore.from_state(
            s_plain, g, group=group),
        "group_into_plain": ShardedVectorStore.from_state(s_group, g, **CPU),
        "group_into_group": tstore.store_from_state(s_group, g,
                                                    group=group)}
    out["restored"] = {name: [_rec(st.search_batch(q, 6, f))
                              for f in FILTERS]
                       for name, st in restored.items()}
    out["group_active"] = restored["plain_into_group"].collective_active
    eight = tstore.store_from_state(s_group, g, group=group, n_shards=8)
    fresh = ShardedVectorStore(g, n_shards=8, **CPU)
    fresh.rebuild()
    out["resharded_on_load"] = [
        (_rec(fresh.search_batch(q, 6, f), False),
         _rec(eight.search_batch(q, 6, f), False)) for f in FILTERS]
    mgr = LifecycleManager(on_group, path)
    out["step"] = mgr.snapshot()
    mgr.wait()
    back = mgr.restore(g, group=group)
    out["manager_restored"] = [_rec(back.search_batch(q, 6, f))
                               for f in FILTERS]
    out["manager_active"] = back.collective_active
    return out


def _facade_corpus():
    corpus = SyntheticCorpus.generate(n_docs=20, n_topics=4, seed=0)
    return corpus, [qa.question for qa in corpus.qa[:8]]


def _facade_hits(rag, questions):
    return {mode: [_rec([r.hits])[0]
                   for r in rag.query_batch(questions, mode=mode)]
            for mode in MODES}


def _facade(group):
    """``EraRAG`` on the group: built, resharded 4 -> 8, its snapshot
    restored onto the group (the parent holds each against the same
    steps without a group)."""
    corpus, questions = _facade_corpus()
    cfg = EraRAGConfig(**{**CFG_KW, "index_shards": 4})
    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), group=group)
    rag.insert_docs(corpus.docs)
    out = {"active": rag.store.collective_active,
           "built": _facade_hits(rag, questions)}
    rag.reshard(8)
    out["resharded"] = _facade_hits(rag, questions)
    out["resharded_active"] = rag.store.collective_active
    out["state"] = rag.state_dict(include_store=True)
    back = EraRAG.from_state(out["state"], HashingEmbedder(
        dim=cfg.embed_dim), group=group)
    out["restored"] = _facade_hits(back, questions)
    out["restored_active"] = back.store.collective_active
    return out


def _every_case(group, path):
    return {"world": group.world_size, "backend": group.backend,
            "parity_0": _parity(group, 0), "parity_1": _parity(group, 1),
            "renumbering": _renumbering(group),
            "k_beyond": _k_beyond_capacity(group),
            "launches": _launches(group), "lockstep": _lockstep(group),
            "uneven": _uneven(group), "auto_off": _auto_off(group),
            "rotation": _rotation(group),
            "double_buffer": _double_buffer(group),
            "quantized": _quantized(group, 2),
            "quantized_full": _quantized(group, FULL),
            "reshard": _reshard(group),
            "snapshots": _snapshots(group, path),
            "facade": _facade(group)}


def _hang(group):
    """Rank 0 never joins the collective that rank 1 waits in."""
    if group.rank == 0:
        time.sleep(120)
    group.barrier()


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("collective_snapshots")
    out = run_ranks(_every_case, WORLD, device="cpu", timeout_s=300,
                    args=(str(path),))
    return out, path


@pytest.fixture(scope="module")
def rank0(ranks):
    return ranks[0][0]


def test_ranks_form_one_gloo_group_and_agree(ranks):
    out, _ = ranks
    assert [r["world"] for r in out] == [WORLD] * WORLD
    assert {r["backend"] for r in out} == {"gloo"}
    for r in out[1:]:
        for case, rec in r.items():
            if case == "facade":   # its snapshot holds arrays
                rec = {k: v for k, v in rec.items() if k != "state"}
                assert rec == {k: v for k, v in out[0][case].items()
                               if k != "state"}
            elif case != "auto_off":
                assert rec == out[0][case], case


@pytest.mark.parametrize("seed", [0, 1])
def test_collective_matches_loop_and_flat_bitwise(rank0, seed):
    rec = rank0[f"parity_{seed}"]
    for filt, want, coll, loop in rec["steps"]:
        assert coll == want, filt
        assert loop == want, filt
    assert rec["full_rebuilds"] == 0
    assert rec["rows_tombstoned"] > 0
    assert rec["compactions"] > 0


def test_collective_survives_seq_renumbering(rank0):
    rec = rank0["renumbering"]
    assert rec["first"][0] == rec["first"][1]
    for want, got in rec["after"]:
        assert got == want
    assert rec["next_seq"] < tstore._SEQ_LIMIT // 2


def test_collective_k_beyond_shard_capacity(rank0):
    rec = rank0["k_beyond"]
    assert rec["capacity"] < rec["size"]
    assert rec["sharded"] == rec["flat"]
    assert all(len(hits) == rec["size"] for hits in rec["sharded"])


def test_collective_query_is_one_count(rank0):
    """One count on the collective counter and on the store's
    ``kernel_launches`` a collective call, one merge; the loop pays one
    launch a non-empty slot of this rank, plus the merge.  On the CPU
    the plain versions run, so the CUDA launch counter does not move."""
    rec = rank0["launches"]
    for moved in rec["collective"]:
        assert moved == [1, 1, 1, 0]
    assert rec["nonempty"] > 1
    assert rec["local_nonempty"] == 1       # rank 0 holds one slot
    assert rec["loop"] == [0, rec["local_nonempty"] + 1, 1, 0]


def test_lockstep_growth_after_any_delta_replay(rank0):
    dim = CFG.embed_dim + tstore.N_FLAGS
    for caps, shape, most in rank0["lockstep"]:
        assert len(caps) == 1
        # each rank's tensor holds its one slot of the four
        assert shape == (1, caps[0], dim)
        assert most <= caps[0]


def test_uneven_shard_count_pads_slots_not_ranks(rank0):
    rec = rank0["uneven"]
    assert rec["n_slots"] == 2 * WORLD
    assert rec["local_slots"] == 2
    assert rec["sharded"] == rec["flat"]


def test_collective_auto_off(ranks):
    """Off without a group and on a one-rank group (the reference's
    degraded single-device mesh); ``local_data_group`` gives ``None``
    when the ranks are too few, or to the ranks left out."""
    out, _ = ranks
    for rank, rec in enumerate(out):
        assert rec["auto_off"]["too_few"]
        assert rec["auto_off"]["in_one_rank_group"] == (rank == 0)
        assert not rec["auto_off"]["meshless_active"]
        for got in rec["auto_off"]["stores"]:
            assert got == rec["auto_off"]["flat"]
    assert not out[0]["auto_off"]["one_rank_active"]
    assert out[0]["auto_off"]["one_rank_world"] == 1


def test_refresh_compacts_at_most_one_shard(rank0):
    rec = rank0["rotation"]
    assert max(rec["per_refresh"]) <= 1
    assert rec["compactions"] > 0 and rec["skipped"] > 0
    for want, got in rec["pairs"]:
        assert got == want
    assert rec["drained"]
    assert rec["after_compact"][0] == rec["after_compact"][1]


def test_compaction_swap_is_double_buffered(rank0):
    rec = rank0["double_buffer"]
    assert rec["staged"] is not None and rec["dead_before_swap"] > 0
    assert rec["pair"][0] == rec["pair"][1]
    assert not rec["query_swapped"]
    assert rec["pending_after"] != rec["staged"]
    assert rec["dead_after_swap"] == 0 and rec["compactions"] == 1


@pytest.mark.parametrize("case", ["quantized", "quantized_full"])
def test_quantized_collective_matches_quantized_loop(rank0, case):
    """The two-stage collective equals the two-stage loop; at C =
    capacity both equal the exact flat store."""
    rec = rank0[case]
    for filt, exact, coll, loop in rec["steps"]:
        assert coll == loop, filt
        if case == "quantized_full":
            assert coll == exact, filt
    assert rec["quantized_scans"] == 2 * len(rec["steps"])


def test_reshard_under_group(rank0):
    rec = rank0["reshard"]
    assert rec["same_object"] and rec["n_shards"] == 8
    assert rec["epoch"] == 1 and rec["active"]
    assert rec["local_slots"] == 2
    for want, got in rec["vs_fresh"] + rec["after_growth"]:
        assert got == want


def test_snapshots_cross_group_and_no_group(rank0):
    """A snapshot taken under the group is byte for byte the one taken
    without; each restores on the other side, and on load into 8
    shards, with the same hits."""
    rec = rank0["snapshots"]
    assert rec["group_state"] == rec["plain_state"]
    for name, got in rec["restored"].items():
        assert got == rec["want"], name
    assert rec["group_active"]
    for want, got in rec["resharded_on_load"]:
        assert got == want


def test_lifecycle_snapshot_written_once_restores_anywhere(ranks):
    """Only rank 0 writes; every rank learns its step; the snapshot
    restores under the group and, here, under none."""
    out, path = ranks
    rec = out[0]["snapshots"]
    assert [r["snapshots"]["step"] for r in out] == [1] * WORLD
    assert rec["manager_restored"] == rec["want"] and \
        rec["manager_active"]
    g = _graph()
    for seed, n in ((41, 45), (42, 20)):
        g.insert_chunks(_chunks(seed, n))
    plain = ShardedVectorStore(g, n_shards=4, **CPU)
    back = LifecycleManager(plain, path).restore(g)
    assert [_rec(back.search_batch(_queries(), 6, f))
            for f in FILTERS] == rec["want"]


def test_erarag_on_group_matches_no_group(rank0):
    rec = rank0["facade"]
    assert rec["active"] and rec["resharded_active"] and \
        rec["restored_active"]
    corpus, questions = _facade_corpus()
    cfg = EraRAGConfig(**{**CFG_KW, "index_shards": 4})
    plain = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), **CPU)
    plain.insert_docs(corpus.docs)
    assert rec["built"] == _facade_hits(plain, questions)
    plain.reshard(8)
    want = _facade_hits(plain, questions)
    assert rec["resharded"] == want
    assert rec["restored"] == want
    back = EraRAG.from_state(rec["state"],
                             HashingEmbedder(dim=cfg.embed_dim), **CPU)
    assert _facade_hits(back, questions) == want


def test_collective_within_jax_mesh_free_loop(rank0):
    """Against the JAX package's mesh-free sharded store on the same
    inserts: ids, layers and sequence numbers equal, scores within
    1e-6 (its mesh path fails under JAX 0.9.0)."""
    from repro.common.config import EraRAGConfig as JaxConfig
    from repro.core.graph import EraGraph as JaxGraph
    from repro.core.store import ShardedVectorStore as JaxSharded
    from repro.data.chunker import Chunk as JaxChunk
    from repro.embed.hashing import HashingEmbedder as JaxEmbedder

    g = JaxGraph(JaxConfig(**CFG_KW), JaxEmbedder(dim=CFG.embed_dim))
    ref = JaxSharded(g, n_shards=4, compact_threshold=0.05)
    chunks, q, pos = _chunks(0, 90, cls=JaxChunk), _queries(), 0
    steps = iter(rank0["parity_0"]["steps"])
    for bs in _growth_schedule(0):
        g.insert_chunks(chunks[pos:pos + bs])
        pos += bs
        for filt in FILTERS:
            _, _, coll, _ = next(steps)
            want = ref.search_batch(q, 6, filt)
            assert [[h[:3] for h in hits] for hits in coll] == \
                [[(h.node_id, h.layer, h.seq) for h in hits]
                 for hits in want], filt
            got = [np.uint32([h[3] for h in hits]).view(np.float32)
                   for hits in coll]
            for g_scores, hits in zip(got, want):
                np.testing.assert_allclose(
                    g_scores, [h.score for h in hits], rtol=0,
                    atol=JAX_TOL)


def test_routing_cache_counters_match_reference():
    """The module-level ``routing_cache_info`` moves as the reference's
    on the same id batches, on both sides of the bulk pass (the global
    routers are process-wide, so the ids are fresh and the counters are
    compared by their movement)."""
    from repro.core import store as jstore

    tag = uuid.uuid4().hex
    batches = [[f"{tag}-bulk-{i}" for i in range(tstore._BULK_ROUTE_MIN)],
               [f"{tag}-small-{i}" for i in range(16)],
               [f"{tag}-small-{i}" for i in range(16)],
               [f"{tag}-edge-{i}" for i in range(tstore._BULK_ROUTE_MIN - 1)],
               [f"{tag}-edge-{i}" for i in range(tstore._BULK_ROUTE_MIN)]]
    assert tstore._BULK_ROUTE_MIN == jstore._BULK_ROUTE_MIN

    def moves(mod):
        out = []
        for ids in batches:
            before = mod.routing_cache_info()
            owners = mod.shard_of_many(ids, 4)
            after = mod.routing_cache_info()
            out.append(({k: after[k] - before[k]
                         for k in ("hits", "misses", "bulk_routed")},
                        np.asarray(owners).tolist()))
        return out

    got, want = moves(tstore), moves(jstore)
    assert got == want
    assert got[0][0] == {"hits": 0, "misses": 0,
                         "bulk_routed": tstore._BULK_ROUTE_MIN}
    assert got[2][0] == {"hits": 16, "misses": 0, "bulk_routed": 0}
    assert got[0][1] == [tstore.shard_of(i, 4) for i in batches[0]]


def test_a_rank_left_in_a_collective_stops_the_run():
    """A rank alone in a collective raises at the group's timeout, and
    ``run_ranks`` stops the other rank and raises."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        run_ranks(_hang, 2, device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 30
