"""mips_topk parity: the port's plain version (what a CPU tensor runs)
against the JAX package's Pallas kernel in interpret mode and its
``flagged_mips_topk``, on numpy-seeded unit-norm rows with exact ties
(duplicated rows, masked rows) and dead / summary / leaf flags.

Ids must be equal and scores within 1e-6 (fp32 sums in two orders).
Each case first asserts that its data has no DISTINCT scores closer
than 1e-5 where they would decide the ids, so a failure names a real
divergence, not a rounding race.  The CUDA kernel itself is tested
in ``test_torch_cuda.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mips_topk.kernel import mips_topk_pallas
from repro.kernels.mips_topk.ops import MASK_BIAS as JAX_MASK_BIAS
from repro.kernels.mips_topk.ops import augment_queries as jax_augment
from repro.kernels.mips_topk.ops import flagged_mips_topk as jax_flagged

from repro_torch.kernels import common
from repro_torch.kernels.common import CSRC_DIR, MIPS_TILE_ROWS, scan_ranges
from repro_torch.kernels.mips_topk import breakdown, ops
from repro_torch.kernels.mips_topk.ref import mips_topk_ref
from repro_torch.kernels.timing import instrumented_source
from torch_threads import one_blas_thread  # noqa: F401

SCORE_TOL = 1e-6
NEAR_TIE = 1e-5
BIASES = {
    "collapsed": (ops.MASK_BIAS, 0.0, 0.0),
    "leaf": (ops.MASK_BIAS, ops.MASK_BIAS, 0.0),
    "summary": (ops.MASK_BIAS, 0.0, ops.MASK_BIAS),
}


def _data(b, n, d, seed):
    """Unit rows with duplicates, flags, and a query equal to a row."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[5, 9, n - 1]] = emb[2]            # exact ties at the top
    u = rng.random(n)
    dead = (u < 0.15).astype(np.float32)
    dead[[2, 5, 9, n - 1]] = 0.0
    summary = (u > 0.7).astype(np.float32)
    db = np.concatenate([emb, dead[:, None], summary[:, None],
                         1.0 - summary[:, None]], axis=1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = emb[2]
    return q, emb, np.ascontiguousarray(db)


def _assert_no_near_ties(q, db, k):
    """Distinct scores that decide the top-k ids lie > 1e-5 apart."""
    s = np.sort((q.astype(np.float64) @ db.T.astype(np.float64)),
                axis=1)[:, ::-1]
    stop = min(k + 1, s.shape[1])
    gaps = np.abs(np.diff(s[:, :stop], axis=1))
    assert not ((gaps > 0) & (gaps <= NEAR_TIE)).any(), \
        "test data has a near-tie that decides ids; pick another seed"


def _check(got, want_v, want_i):
    gv, gi = got
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(gv.numpy(), np.asarray(want_v),
                               rtol=0, atol=SCORE_TOL)


def test_mask_bias_matches_reference():
    assert ops.MASK_BIAS == JAX_MASK_BIAS


@pytest.mark.parametrize("b,n,d,k,seed", [
    (4, 300, 64, 1, 0), (4, 300, 64, 8, 0), (3, 120, 32, 120, 4),
    (9, 700, 259, 8, 2)])
def test_plain_matches_pallas_interpret(b, n, d, k, seed):
    q, emb, _ = _data(b, n, d, seed)
    _assert_no_near_ties(q, emb, k)
    got = ops.mips_topk(torch.from_numpy(q), torch.from_numpy(emb), k)
    # small blocks: several n-tiles, so ties cross tile boundaries
    want = mips_topk_pallas(jnp.asarray(q), jnp.asarray(emb), k,
                            block_q=8, block_n=64, block_d=128,
                            interpret=True)
    _check(got, *want)
    assert got[1][0, :1].tolist() == [2]   # exact tie: lowest index


@pytest.mark.parametrize("mode", sorted(BIASES))
@pytest.mark.parametrize("n,k", [(200, 8), (60, 60)])
def test_flagged_matches_reference(mode, n, k):
    q, _, db = _data(6, n, 48, seed=1)
    bias = BIASES[mode]
    q_aug = np.asarray(jax_augment(jnp.asarray(q), bias))
    np.testing.assert_array_equal(
        ops.augment_queries(torch.from_numpy(q), bias).numpy(), q_aug)
    _assert_no_near_ties(q_aug, db, k)
    got = ops.flagged_mips_topk(torch.from_numpy(q), torch.from_numpy(db),
                                k, bias)
    _check(got, *jax_flagged(jnp.asarray(q), jnp.asarray(db), k, bias))
    _check(got, *jax_flagged(jnp.asarray(q), jnp.asarray(db), k, bias,
                             use_pallas=True, interpret=True))
    if k == n:   # every row: masked rows rank last, ties by index
        vals = got[0].numpy()
        assert (np.diff(vals, axis=1) <= 0).all()
        masked = vals < -1e29
        assert masked.any() and (~masked).any()


def test_plain_ties_go_to_lowest_index():
    """torch.topk does not promise it; the stable sort does."""
    q = torch.ones((1, 1))
    db = torch.tensor([[3.0], [1.0], [3.0], [2.0], [3.0]])
    vals, idx = mips_topk_ref(q, db, 2)
    assert idx.tolist() == [[0, 2]] and vals.tolist() == [[3.0, 3.0]]
    vals, idx = ops.mips_topk(q, db, 5)
    assert idx.tolist() == [[0, 2, 4, 3, 1]]


def test_shape_and_k_checks():
    q = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        ops.mips_topk(q, torch.zeros((3, 5)), 1)
    with pytest.raises(ValueError):
        ops.mips_topk(q, torch.zeros((3, 4)), 4)
    with pytest.raises(ValueError, match="k <= 64"):
        ops.mips_topk_cuda(q, torch.zeros((100, 4)), 65)


@pytest.mark.parametrize("b,n", [(1, 1), (64, 1000), (16, 129)])
def test_scan_ranges_cover_rows(b, n):
    for sms in (1, 132):
        rows, ranges = scan_ranges(b, n, sms)
        assert rows % 128 == 0 and ranges * rows >= n
        assert (ranges - 1) * rows < n


@pytest.mark.parametrize("b,n", [(1, 1), (1, 255), (15, 256), (16, 257),
                                 (17, 35839), (64, 35840), (65, 35841),
                                 (130, 1 << 22), (1000, 70000)])
def test_mips_scan_grid_covers_rows(b, n):
    for sms in (1, 7, 132):
        tile, tile_rows, rows, ranges = ops.mips_scan_grid(b, n, sms)
        assert tile == (16 if b <= 16 else 64)
        assert tile_rows in MIPS_TILE_ROWS
        assert rows % tile_rows == 0 and ranges * rows >= n
        assert (ranges - 1) * rows < n
        # about one block per SM: never more blocks than SMs, unless
        # the query tiles alone outnumber them
        q_tiles = -(-b // tile)
        assert ranges * q_tiles <= max(sms, q_tiles)


def test_mips_scan_grid_fills_the_card():
    # 2^22 rows: 512-row tiles, one range per SM
    assert ops.mips_scan_grid(64, 1 << 22, 132) == (64, 512, 63 * 512, 131)
    assert ops.mips_scan_grid(1, 1 << 22, 132) == (16, 512, 63 * 512, 131)
    # the main path's store buffer: 512-row tiles would fill 64 of 132
    # SMs, so 256-row tiles, one per block
    assert ops.mips_scan_grid(64, 32768, 132) == (64, 256, 256, 128)
    assert ops.mips_scan_grid(1, 32768, 132) == (16, 256, 256, 128)


def test_sm_count_reads_each_device_once(monkeypatch):
    from repro_torch.kernels import common

    calls = []

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: calls.append(i) or Props())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(common, "_SM_COUNTS", {})
    for dev in ("cuda:0", "cuda:0", "cuda", "cuda:1"):
        assert common.sm_count(torch.device(dev)) == 132
    assert calls == [0, 1]


def test_cuda_wrapper_hands_the_scan_grid_to_the_launcher(monkeypatch):
    """The wrapper's arguments, in the order of the C entry point's
    ctypes signature (the kernel itself runs only on the card)."""
    seen = []

    class Lib:
        def mips_topk_launch(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(ops, "load_kernel", lambda name, sigs: Lib())
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "stream_ptr", lambda dev: None)
    before = ops.launch_count()
    ops.mips_topk_cuda(torch.zeros((17, 259)), torch.zeros((70000, 259)), 8)
    assert ops.launch_count() == before + 1
    (args,) = seen
    assert len(args) == len(ops._SIGNATURES["mips_topk_launch"][0])
    assert args[6:14] == (17, 70000, 259, 8,
                          *ops.mips_scan_grid(17, 70000, 132))


@pytest.mark.parametrize("variant", sorted(breakdown.VARIANTS))
def test_breakdown_switches_apply_to_the_shipped_source(variant):
    """Each instrumented copy that the breakdown tool builds is the
    kernel source with exactly its switches applied."""
    source = (CSRC_DIR / "mips_topk.cu").read_text()
    switches = breakdown.VARIANTS[variant]
    copy = instrumented_source(source, breakdown.SWITCHES, switches)
    assert (copy == source) == (not switches)
    for name in switches:
        assert breakdown.SWITCHES[name][1] in copy
    with pytest.raises(ValueError):
        instrumented_source(source, breakdown.SWITCHES,
                            ("NO_LOAD", "NO_LOAD"))


def _rescore_cover(g, b, c):
    """How often ``mips_rescore_kernel`` scores each (query, candidate)
    under grid ``g``: the kernel's own mapping, block by block and warp
    by warp (a block's rank in its cluster, its queries, each warp's
    tiles).  Queries in one block group share the candidate pattern, so
    it is built once per (rank, warp) and added to each query."""
    per_query = np.zeros((g.cluster, g.warps_per_query, c), np.int64)
    tile = common.RESCORE_TILE
    stride = tile * g.warps_per_query
    for rank in range(g.cluster):
        p_end = min(c, (rank + 1) * g.cands_per_block)
        for j in range(g.warps_per_query):
            first = rank * g.cands_per_block + tile * j
            if first >= p_end:
                continue
            p = (np.arange(first, p_end, stride)[:, None]
                 + np.arange(tile)[None, :]).ravel()
            per_query[rank, j] = np.bincount(p[p < p_end], minlength=c)
    cover = np.zeros((b, c), np.int64)
    warps = g.queries_per_block * g.warps_per_query
    for block in range(common.cdiv(b, g.queries_per_block) * g.cluster):
        rank = block % g.cluster
        for w in range(warps):
            qi = block // g.cluster * g.queries_per_block + \
                w // g.warps_per_query
            if qi < b:
                cover[qi] += per_query[rank, w % g.warps_per_query]
    return cover


def _rescore_smem_bytes(source, warps):
    """A rescore block's dynamic shared memory, from ``mips_topk.cu``'s
    own constants: each warp's ring of stages and its top-k list."""
    c = {name: _cu_int(source, name) for name in (
        "kRescoreTile", "kRescoreChunk", "kRescoreStages", "kMaxK")}
    pitch = 4 * (c["kRescoreChunk"] // 4 + 1)   # a row's 16-byte blocks
    stage = c["kRescoreTile"] * pitch + c["kRescoreChunk"]
    return warps * (c["kRescoreStages"] * stage * 4 + 8 * c["kMaxK"])


def _cu_int(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         source).group(1))


@pytest.mark.parametrize("b", [1, 5, 64, 65, 1000])
@pytest.mark.parametrize("c", [1, 8, 31, 32, 33, 100, 128, 129, 256, 257,
                               288, 512, 3000, 4096, 4200, 1 << 15, 1 << 22])
def test_rescore_grid_scores_every_candidate_once(b, c):
    """Every (query, candidate) is scored by exactly one warp, in one
    launch: at most 8 warps a block, clusters of at most 8 blocks (one
    query a block there), a cluster exactly as long as the candidates
    need, and each block within the shared memory of an SM."""
    source = (CSRC_DIR / "mips_topk.cu").read_text()
    for sms in (1, 132):
        g = common.rescore_grid(b, c, sms)
        warps = g.queries_per_block * g.warps_per_query
        assert 1 <= warps <= common.RESCORE_MAX_WARPS
        assert 1 <= g.cluster <= common.RESCORE_MAX_CLUSTER
        assert g.cluster == common.cdiv(c, g.cands_per_block)
        assert g.cluster == 1 or g.queries_per_block == 1
        assert _rescore_smem_bytes(source, warps) <= \
            _cu_int(source, "kSmemMax")
        if b * c <= 1 << 24:
            assert (_rescore_cover(g, b, c) == 1).all()
        else:   # one query stands for all: every query gets the same warps
            assert (_rescore_cover(g, 1, c) == 1).all()


def test_rescore_grid_at_the_serving_shapes():
    # the main path (C = 32): one warp a query, one query a block
    assert common.rescore_grid(64, 32, 132) == (1, 1, 32, 1)
    assert common.rescore_grid(64, 128, 132) == (1, 4, 128, 1)
    # C = 4096: a cluster of 8 blocks of 2 warps a query, 512 candidates
    # a block (512 blocks, about 4 a SM, in one wave)
    assert common.rescore_grid(64, 4096, 132) == (1, 2, 512, 8)
    assert common.rescore_grid(1, 4096, 132) == (1, 2, 512, 8)
    # full coverage at 2^22: 8 blocks, 2^19 candidates each
    assert common.rescore_grid(64, 1 << 22, 132) == (1, 2, 1 << 19, 8)
    # more queries than SMs: several a block
    assert common.rescore_grid(1000, 32, 132) == (7, 1, 32, 1)


def test_rescore_constants_match_the_source():
    """The Python grid's limits are the kernel's, and the launcher's C
    signature has the arguments the wrapper passes."""
    source = (CSRC_DIR / "mips_topk.cu").read_text()
    assert _cu_int(source, "kRescoreTile") == common.RESCORE_TILE
    assert _cu_int(source, "kRescoreMaxWarps") == common.RESCORE_MAX_WARPS
    assert _cu_int(source, "kMaxCluster") == common.RESCORE_MAX_CLUSTER
    assert _cu_int(source, "kMaxK") == ops.MAX_K
    assert common.RESCORE_CLUSTER_WARPS <= common.RESCORE_MAX_WARPS
    launcher = source[source.index('extern "C" int mips_rescore_launch('):]
    params = launcher[:launcher.index(")")].split(",")
    assert len(params) == len(ops._SIGNATURES["mips_rescore_launch"][0])


@pytest.mark.parametrize("b,c", [(64, 32), (65, 4096), (3, 288), (0, 32)])
def test_rescore_wrapper_hands_the_grid_to_one_launch(monkeypatch, b, c):
    """The wrapper's arguments, in the order of the C entry point's
    ctypes signature (the kernel runs only on the card): the grid of
    ``rescore_grid``, one launch counted, and no tensor allocated but
    the two outputs."""
    q, db = torch.zeros((b, 259)), torch.zeros((5000, 259))
    cand = torch.zeros((b, c), dtype=torch.int32)
    seen, allocs = [], []

    class Lib:
        def mips_rescore_launch(self, *args):
            seen.append(args)
            return 0

    empty = torch.empty

    def recording_empty(*args, **kwargs):
        allocs.append((tuple(args[0]), kwargs.get("dtype")))
        return empty(*args, **kwargs)

    monkeypatch.setattr(ops, "load_kernel", lambda name, sigs: Lib())
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(torch, "empty", recording_empty)
    before = ops.rescore_launch_count()
    vals, idx = ops.mips_rescore_cuda(q, db, cand, 8)
    assert allocs == [((b, 8), torch.float32), ((b, 8), torch.int32)]
    assert vals.shape == idx.shape == (b, 8)
    if b == 0:
        assert not seen and ops.rescore_launch_count() == before
        return
    assert ops.rescore_launch_count() == before + 1
    (args,) = seen
    assert len(args) == len(ops._SIGNATURES["mips_rescore_launch"][0])
    assert args[5:] == (b, 5000, 259, c, 8,
                        *common.rescore_grid(b, c, 132), None)


@pytest.mark.parametrize("variant", sorted(breakdown.RESCORE_VARIANTS))
def test_rescore_breakdown_switches_apply_to_the_shipped_source(variant):
    """Each instrumented copy of the rescore that the breakdown tool
    builds is the kernel source with exactly its switches applied."""
    source = (CSRC_DIR / "mips_topk.cu").read_text()
    switches = breakdown.RESCORE_VARIANTS[variant]
    copy = instrumented_source(source, breakdown.SWITCHES, switches)
    assert (copy == source) == (not switches)
    for name in switches:
        assert breakdown.SWITCHES[name][1] in copy
