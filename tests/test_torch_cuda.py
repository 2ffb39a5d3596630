"""The port's CUDA kernels on the card, against their plain PyTorch
versions (which ``test_torch_lsh_hash.py``, ``test_torch_mips_topk.py``,
``test_torch_hamming_topk.py``, ``test_torch_quantized_scan.py``,
``test_torch_flash_attention.py`` and ``test_torch_train.py`` hold
against the JAX package on the CPU).

Every test here carries the ``cuda`` marker and skips without a card:
the kernels have no CPU interpret mode.  This file imports no JAX (the
card's machine has none), so on the card it runs without the suite's
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels import common
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.hamming_topk import ops as ham_ops
from repro_torch.kernels.hamming_topk.ref import hamming_topk_ref
from repro_torch.kernels.lsh_hash import ops as lsh_ops
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_grads_ref, \
    attention_lse_ref, attention_ref
from repro_torch.kernels.quantized_scan import ops as quant_ops

pytestmark = pytest.mark.cuda

FLIP_BAND = 1e-5    # |fp64 projection| within which a sign may flip
SCORE_TOL = 1e-5    # fp32 sums in two orders, unit-norm rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k", [(1, 256, 12), (300, 256, 12),
                                   (77, 259, 33), (64, 128, 64),
                                   (20000, 256, 12), (300, 256, 128),
                                   (129, 64, 200)])
def test_lsh_kernel_matches_plain(cuda, n, d, k):
    rng = np.random.default_rng(n + d + k)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[0] = 0.0
    h = rng.standard_normal((d, k)).astype(np.float32)
    before = lsh_ops.launch_count()
    got = lsh_ops.lsh_hash(torch.from_numpy(v).to(cuda),
                           torch.from_numpy(h).to(cuda))
    assert lsh_ops.launch_count() == before + 1
    want = lsh_ops.lsh_hash(torch.from_numpy(v), torch.from_numpy(h))
    diff = lsh_ops.unpack_bits(got.cpu(), k) != lsh_ops.unpack_bits(want, k)
    if diff.any():   # only bits within rounding of a zero projection
        proj = v.astype(np.float64) @ h.astype(np.float64)
        assert np.abs(proj[diff.numpy()]).max() <= FLIP_BAND
    assert lsh_ops.codes_to_int(got[:1].cpu().numpy(), k)[0] == \
        (1 << k) - 1


def _lsh_assert_matches_plain(got, v, h):
    """Codes of the kernel against the plain version: a bit may differ
    only where the fp64 projection lies within the flip band."""
    k = h.shape[1]
    want = lsh_ops.lsh_hash(v.cpu(), h.cpu())
    diff = lsh_ops.unpack_bits(got.cpu(), k) != lsh_ops.unpack_bits(want, k)
    if diff.any():
        proj = v.cpu().double() @ h.cpu().double()
        assert float(proj.abs()[diff].max()) <= FLIP_BAND


@pytest.mark.parametrize("k", [12, 64, 128])
def test_lsh_code_is_invariant(cuda, k):
    """A row's code is bitwise the same hashed alone, in a batch of 64,
    at offset 7 of a 20000-row batch and among 2^16 rows: each call takes
    another grid (lsh_grid splits rows and planes by shape), never d."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    rows = torch.randn(1 << 16, 256, device=cuda, generator=gen)
    h = torch.randn(256, k, device=cuda, generator=gen)
    row = rows[7:8].contiguous()
    batch = torch.cat([row, rows[100:163]])
    alone = lsh_ops.lsh_hash(row, h)
    grids = {common.lsh_grid(n, k, sm_count(cuda))
             for n in (1, 64, 20000, 1 << 16)}
    assert len(grids) >= 3
    for got in (lsh_ops.lsh_hash(batch, h)[:1],
                lsh_ops.lsh_hash(rows[:20000].contiguous(), h)[7:8],
                lsh_ops.lsh_hash(rows, h)[7:8]):
        assert torch.equal(got, alone)
    _lsh_assert_matches_plain(alone, row, h)


@pytest.mark.parametrize("n,k", [(3000, 12), (3000, 64), (700, 128)])
def test_lsh_code_is_invariant_to_the_grid(cuda, n, k):
    """Every split of rows and planes the kernel was built for (each
    (planes, rows) a thread may hold, laid out by lsh_layout) gives
    bitwise the codes of lsh_grid's own."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    v = torch.randn(n, 256, device=cuda, generator=gen)
    h = torch.randn(256, k, device=cuda, generator=gen)
    want = lsh_ops.lsh_hash(v, h)
    lib = common.load_kernel("lsh_hash", lsh_ops._SIGNATURES)
    tried = 0
    for kp, r in common.LSH_KERNELS:
        if kp == 12 and k > 12:     # KP 12 holds one group only
            continue
        grid = common.lsh_layout(n, k, sm_count(cuda), kp, r)
        out = torch.full_like(want, 7)
        assert lib.lsh_hash_launch(
            v.data_ptr(), h.data_ptr(), out.data_ptr(), n, 256, k, *grid,
            common.stream_ptr(cuda)) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), grid
        tried += 1
    assert tried >= 4


def test_lsh_plane_groups_are_the_narrower_codes(cuda):
    """The first two words of a k = 128 code are bitwise the k = 64 code
    under the first 64 planes: a plane's bit never depends on the
    others."""
    gen = torch.Generator(device=cuda).manual_seed(128)
    v = torch.randn(12510, 256, device=cuda, generator=gen)
    h = torch.randn(256, 128, device=cuda, generator=gen)
    wide = lsh_ops.lsh_hash(v, h)
    narrow = lsh_ops.lsh_hash(v, h[:, :64].contiguous())
    assert torch.equal(wide[:, :2], narrow)
    _lsh_assert_matches_plain(wide, v, h)


@pytest.mark.parametrize("k", [12, 33, 64])
def test_lsh_takes_rows_not_16_byte_aligned(cuda, k):
    """A contiguous view one float in (v[1:], d = 259) is hashed through
    the 4-byte copies: the same codes as an aligned copy of it, within
    the flip band of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    n, d = 3000, 259
    base = torch.randn(n * d + 1, device=cuda, generator=gen)
    v = base[1:].view(n, d)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    h = torch.randn(d, k, device=cuda, generator=gen)
    got = lsh_ops.lsh_hash(v, h)
    assert torch.equal(got, lsh_ops.lsh_hash(v.clone(), h))
    _lsh_assert_matches_plain(got, v, h)


def test_lsh_takes_planes_held_in_chunks(cuda):
    """d = 1024 at k = 64: 32 chunks of features, each staged with the
    same features of all 64 planes (64 KB of planes would not fit whole
    beside a ring of tiles), match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1024)
    v = torch.randn(30000, 1024, device=cuda, generator=gen)
    h = torch.randn(1024, 64, device=cuda, generator=gen)
    _lsh_assert_matches_plain(lsh_ops.lsh_hash(v, h), v, h)


def test_lsh_smem_formula_is_the_launchers(cuda):
    """lsh_grid sizes its grids with the launcher's own shared-memory
    layout (csrc/lsh_hash.cu Layout)."""
    lib = common.load_kernel("lsh_hash", lsh_ops._SIGNATURES)
    for n, k in [(12510, 12), (64, 64), (30189, 64), (12510, 128),
                 (1 << 22, 12), (100000, 512), (3000, 64), (77, 33)]:
        g = common.lsh_grid(n, k, sm_count(cuda))
        assert lib.lsh_hash_smem_bytes(
            k, g.planes_per_thread, g.rows_per_thread, g.plane_groups,
            g.row_lanes, g.stages) == common.lsh_smem_bytes(g, k)


def test_lsh_refused_launch_raises(cuda, monkeypatch):
    """A grid asking for more shared memory than a block has is refused
    and raises: no other route runs and nothing is counted."""
    v = torch.randn(5000, 256, device=cuda)
    h = torch.randn(256, 12, device=cuda)
    monkeypatch.setattr(lsh_ops, "lsh_grid",
                        lambda n, k, sms: common.LshGrid(
                            12, 4, 1, 128, 8, 5000))
    assert common.lsh_smem_bytes(lsh_ops.lsh_grid(5000, 12, 132),
                                 12) > common.SMEM_MAX
    before = lsh_ops.launch_count()
    with pytest.raises(RuntimeError, match="CUDA error"):
        lsh_ops.lsh_hash(v, h)
    assert lsh_ops.launch_count() == before


def _flagged_data(b, n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[5, 9, n - 1]] = emb[2]            # exact ties
    u = rng.random(n)
    dead = (u < 0.15).astype(np.float32)
    dead[[2, 5, 9, n - 1]] = 0.0
    summary = (u > 0.7).astype(np.float32)
    db = np.concatenate([emb, dead[:, None], summary[:, None],
                         1.0 - summary[:, None]], axis=1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = emb[2]
    return q, np.ascontiguousarray(db)


@pytest.mark.parametrize("b,n,d,k", [(4, 300, 64, 8), (9, 700, 256, 8),
                                     (64, 50000, 256, 8), (5, 300, 64, 64),
                                     (3, 130, 32, 130 - 70)])
@pytest.mark.parametrize("bias", [(mips_ops.MASK_BIAS, 0.0, 0.0),
                                  (mips_ops.MASK_BIAS, mips_ops.MASK_BIAS,
                                   0.0)])
def test_mips_kernel_matches_plain(cuda, b, n, d, k, bias):
    q, db = _flagged_data(b, n, d, seed=b + n)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    before = mips_ops.launch_count()
    vals, idx = mips_ops.flagged_mips_topk(qt, dbt, k, bias)
    assert mips_ops.launch_count() == before + 1
    want_v, want_i = mips_ops.flagged_mips_topk(
        torch.from_numpy(q), torch.from_numpy(db), k, bias)
    np.testing.assert_allclose(vals.cpu().numpy(), want_v.numpy(),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_i.numpy())
    if bias[1] == 0.0:   # rows 2, 5, 9, n-1 tie exactly, all alive
        assert idx[0, :4].tolist() == [2, 5, 9, n - 1][:min(4, k)]
    for j in range(b):   # batch invariance, bitwise
        v1, i1 = mips_ops.flagged_mips_topk(qt[j:j + 1].contiguous(), dbt,
                                            k, bias)
        assert torch.equal(v1, vals[j:j + 1])
        assert torch.equal(i1, idx[j:j + 1])


def _unit_rows(rng, m, d):
    x = rng.standard_normal((m, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_matches_plain(vals, idx, q, db, k):
    """Scores within SCORE_TOL of the plain version; ids equal except at
    a near-tie (a plain neighbour within SCORE_TOL, which the two
    summation orders may swap)."""
    pv, pi = mips_ops.mips_topk(q.cpu(), db.cpu(), min(k + 1, db.shape[0]))
    vals, idx = vals.cpu(), idx.cpu()
    assert float((vals - pv[:, :k]).abs().max()) <= SCORE_TOL
    near = torch.zeros_like(pv, dtype=torch.bool)
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= SCORE_TOL
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert not ((idx != pi[:, :k]) & ~near[:, :k]).any()


# b across the query tiles (16 and 64, larger b in tiles of 64); n one
# below, at and one above a row tile (256 rows where 512-row tiles
# would leave SMs idle) and, past 132 tiles, a range of two tiles (one
# block per SM); d across the 16-feature stages and their tails; d = 256
# and 260 stage rows that start on a 16-byte block, the odd d rows
# that do not
MIPS_TILING_EDGES = [                   # b, n, d, k
    (1, 100, 259, 8),                   # n below one tile
    (15, 255, 1, 1),                    # d = 1: every row +-1, all ties
    (16, 256, 3, 8),                    # a tail chunk alone
    (17, 257, 35, 64),                  # two chunks + 3
    (63, 140 * 256 - 1, 256, 8),        # 256-row tiles, ranges of two
    (64, 140 * 256, 259, 8),
    (65, 140 * 256 + 1, 260, 64),       # a last range of one row
    (130, 140 * 256 + 1, 259, 1),       # three query tiles
    (1, 140 * 256, 259, 64),
    (16, 1000, 260, 64),
    (64, 140 * 512 + 1, 259, 8),        # 512-row tiles
    (33, 140 * 512, 260, 64),
    (1, 140 * 512 - 1, 259, 8),
    (16, 140 * 512 + 1, 35, 64)]


@pytest.mark.parametrize("b,n,d,k", MIPS_TILING_EDGES)
def test_mips_scan_at_the_edges_of_its_tiling(cuda, b, n, d, k):
    rng = np.random.default_rng(b + n + d + k)
    db, q = _unit_rows(rng, n, d), _unit_rows(rng, b, d)
    # exact duplicates across the first tile and the first range
    # boundary, and query 0 equal to them: lowest index first
    _, tile_rows, per_range, _ = mips_ops.mips_scan_grid(
        b, n, sm_count(cuda))
    dups = sorted({r for r in (tile_rows - 1, tile_rows,
                               per_range - 1, per_range)
                   if r < n})
    if d > 1 and len(dups) > 1:
        db[dups] = db[dups[0]]
        q[0] = db[dups[0]]
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    before = mips_ops.launch_count()
    vals, idx = mips_ops.mips_topk(qt, dbt, k)
    assert mips_ops.launch_count() == before + 1
    _assert_matches_plain(vals, idx, qt, dbt, k)
    if d > 1 and len(dups) > 1:
        m = min(k, len(dups))
        assert idx[0, :m].tolist() == dups[:m]
        assert bool((vals[0, :m] == vals[0, 0]).all())
    for j in range(b):   # each query alone: its row of the batch, bitwise
        v1, i1 = mips_ops.mips_topk(qt[j:j + 1].contiguous(), dbt, k)
        assert torch.equal(v1, vals[j:j + 1]) and torch.equal(i1,
                                                               idx[j:j + 1])


@pytest.mark.parametrize("b,n,k", [(64, 140 * 256, 8), (64, 300 * 512, 8),
                                   (1, 140 * 512, 64), (16, 5000, 1)])
def test_mips_scan_with_tiles_of_tied_rows(cuda, b, n, k):
    """Whole tiles whose rows tie exactly: a run of copies of query 0
    (the best score, so the lowest indices must win) and, like the
    store's padding, a tail of rows that all score the mask bias."""
    rng = np.random.default_rng(n + k)
    d = 256                                     # + 3 flag columns
    emb, q = _unit_rows(rng, n, d), _unit_rows(rng, b, d)
    emb[n // 3:n // 3 + 2000] = q[0]
    dead = np.zeros((n, 1), np.float32)
    emb[-n // 4:] = 0.0
    dead[-n // 4:] = 1.0                        # scores the bias
    db = np.concatenate([emb, dead, np.zeros((n, 2), np.float32)], axis=1)
    q = np.concatenate([q, np.full((b, 1), mips_ops.MASK_BIAS, np.float32),
                        np.zeros((b, 2), np.float32)], axis=1)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    vals, idx = mips_ops.mips_topk(qt, dbt, k)
    _assert_matches_plain(vals, idx, qt, dbt, k)
    assert idx[0].tolist() == list(range(n // 3, n // 3 + k))
    for j in (0, b - 1):
        v1, i1 = mips_ops.mips_topk(qt[j:j + 1].contiguous(), dbt, k)
        assert torch.equal(v1, vals[j:j + 1]) and torch.equal(i1,
                                                               idx[j:j + 1])


def test_mips_scan_takes_a_db_not_16_byte_aligned(cuda):
    rng = np.random.default_rng(5)
    n, d = 3000, 259
    db, q = _unit_rows(rng, n, d), _unit_rows(rng, 20, d)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    shifted = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    shifted.copy_(dbt)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    vals, idx = mips_ops.mips_topk(qt, shifted, 8)
    want_v, want_i = mips_ops.mips_topk(qt, dbt, 8)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)
    _assert_matches_plain(vals, idx, qt, dbt, 8)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    v = torch.zeros((8, 16), device=cuda)
    with pytest.raises(TypeError):
        lsh_ops.lsh_hash(v.double(), torch.zeros((16, 4), device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError):
        lsh_ops.lsh_hash(v.T, torch.zeros((8, 4), device=cuda))
    with pytest.raises(ValueError):
        mips_ops.mips_topk(v, torch.zeros((100, 16), device=cuda), 65)
    with pytest.raises(ValueError):
        mips_ops.mips_topk(v, torch.zeros((16, 100), device=cuda).T, 4)
    codes = torch.zeros((8, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ham_ops.hamming_topk(codes.float(), codes.float(), 2)
    with pytest.raises(ValueError):
        ham_ops.hamming_topk(codes.T, codes.T, 2)
    with pytest.raises(ValueError):
        ham_ops.hamming_topk(codes, codes, 9)
    with pytest.raises(ValueError):
        mips_ops.mips_rescore(v, v, codes, 4)      # 3 candidates < k


@pytest.mark.parametrize("b,n,w,c", [(1, 1, 1, 1), (5, 300, 11, 32),
                                     (64, 5000, 11, 32), (17, 1000, 2, 1000),
                                     (3, 70000, 11, 4096), (2, 700, 67, 50),
                                     (64, 4096, 11, 4096)])
def test_hamming_kernel_matches_plain_bitwise(cuda, b, n, w, c):
    rng = np.random.default_rng(b + n + w + c)
    base = rng.integers(0, 2**32, size=(max(1, n // 8), w),
                        dtype=np.uint32)
    dbc = base[rng.integers(0, base.shape[0], size=n)]   # many ties
    qc = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    qc[0] = dbc[n - 1]
    qt = torch.from_numpy(qc.view(np.int32)).to(cuda)
    dt = torch.from_numpy(dbc.view(np.int32)).to(cuda)
    before = ham_ops.launch_count()
    dist, idx = ham_ops.hamming_topk(qt, dt, c)
    assert ham_ops.launch_count() == before + 1
    want_d, want_i = hamming_topk_ref(qt, dt, c)
    assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    assert dist[0, 0].item() == 0
    for j in (0, b - 1):   # batch invariance
        d1, i1 = ham_ops.hamming_topk(qt[j:j + 1].contiguous(), dt, c)
        assert torch.equal(d1, dist[j:j + 1]) and torch.equal(i1,
                                                               idx[j:j + 1])


def _ham_codes(b, n, w, seed):
    """Codes with many tied rows (n / 8 distinct) and query 0 equal to the
    last row, as uint32 numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=(max(1, n // 8), w),
                        dtype=np.uint32)
    dbc = base[rng.integers(0, base.shape[0], size=n)]
    qc = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    qc[0] = dbc[n - 1]
    return qc, dbc


def _ham_to(cuda, *arrays):
    return [torch.from_numpy(a.view(np.int32)).to(cuda) for a in arrays]


def _ham_call(qt, dt, c, route):
    """One call on the card: one launch counted, on ``route``."""
    before = ham_ops.launch_count()
    routes = ham_ops.route_launch_counts()
    dist, idx = ham_ops.hamming_topk_cuda(qt, dt, c)
    assert ham_ops.launch_count() == before + 1
    after = ham_ops.route_launch_counts()
    assert {r: after[r] - routes[r] for r in ham_ops.ROUTES} == \
        {r: int(r == route) for r in ham_ops.ROUTES}
    return dist, idx


# (b, n, w, c, key_bits): C at the list route's edges and one past it
# (the counting route); b across the query tiles (8, 16, 64, and tiles
# of 64 on the grid's second axis); n below C x ranges and not a
# multiple of the row tile; w from 1 to MAX_W; 32- and 64-bit keys
# (key_bits 64 forces the wide keys through ``list_key_bits``, None
# leaves the route's own choice)
HAM_LIST_CASES = [
    (64, 5000, 11, 1, None), (64, 5000, 11, 31, None),
    (64, 5000, 11, 32, None), (64, 5000, 11, 33, None),
    (64, 5000, 11, ham_ops.LIST_MAX_C, None),
    (64, 5000, 11, ham_ops.LIST_MAX_C + 1, None),
    (1, 70000, 11, 32, None), (8, 70000, 11, 32, None),
    (9, 20000, 11, 64, None), (65, 20000, 11, 32, None),
    (130, 9000, 11, ham_ops.LIST_MAX_C, None),
    (64, 700, 67, ham_ops.LIST_MAX_C, None), (5, 1000, 11, 100, None),
    (5, 300, 1, 32, None), (17, 1000, 2, 100, None),
    (3, 3000, 67, 50, None), (2, 700, ham_ops.MAX_W, 128, None),
    (1, 1, 1, 1, None),
    (64, 5000, 11, 32, 64), (9, 20000, 11, 128, 64),
    (1, 70000, 11, 1, 64), (3, 3000, 67, 50, 64),
    (130, 9000, 2, 33, 64)]


@pytest.mark.parametrize("b,n,w,c,key_bits", HAM_LIST_CASES)
def test_hamming_list_route_at_its_edges(cuda, monkeypatch, b, n, w, c,
                                         key_bits):
    if key_bits is not None:
        monkeypatch.setattr(ham_ops, "list_key_bits",
                            lambda w, rows: key_bits)
    qc, dbc = _ham_codes(b, n, w, b + n + w + c)
    g = ham_ops.hamming_route(b, n, w, c, sm_count(cuda))
    assert key_bits is None or g.key_bits == key_bits
    # copies of query 0's row across the first tile and range edges:
    # they tie at distance 0 with its other copies and must come first,
    # lowest row first
    dbc[[r for r in (g.tile_rows - 1, g.tile_rows, g.rows_per_range - 1,
                     g.rows_per_range, 2 * g.rows_per_range - 1)
         if r < n]] = qc[0]
    dups = np.flatnonzero((dbc == qc[0]).all(axis=1)).tolist()
    qt, dt = _ham_to(cuda, qc, dbc)
    dist, idx = _ham_call(qt, dt, c, g.route)
    want_d, want_i = hamming_topk_ref(qt, dt, c)
    assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    m = min(c, len(dups))
    assert idx[0, :m].tolist() == dups[:m]
    assert not dist[0, :m].any()
    for j in sorted({0, b // 2, b - 1}):   # each query alone, bitwise
        d1, i1 = _ham_call(qt[j:j + 1].contiguous(), dt, c, g.route)
        assert torch.equal(d1, dist[j:j + 1]) and torch.equal(i1,
                                                               idx[j:j + 1])


@pytest.mark.parametrize("b,n,w,c", [(64, 5000, 11, 32), (9, 3000, 11, 128),
                                     (1, 70000, 11, 1), (3, 700, 80, 77),
                                     (4, 3000, 11, ham_ops.LIST_MAX_C + 1)])
def test_hamming_plane_of_equal_rows(cuda, b, n, w, c):
    """Every row equal: every distance ties, so the C lowest rows win."""
    rng = np.random.default_rng(n + c)
    row = rng.integers(0, 2**32, size=(1, w), dtype=np.uint32)
    qc = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    qt, dt = _ham_to(cuda, qc, np.repeat(row, n, axis=0))
    route = "list" if c <= ham_ops.LIST_MAX_C else "count"
    dist, idx = _ham_call(qt, dt, c, route)
    want_d, want_i = hamming_topk_ref(qt, dt, c)
    assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    assert idx.tolist() == [list(range(c))] * b


@pytest.mark.parametrize("w,c", [(11, 32), (11, 129), (2, 64), (67, 8)])
def test_hamming_takes_a_plane_view_one_row_in(cuda, w, c):
    """A plane that starts one row into its storage (12 bytes past a
    16-byte boundary for w = 11 and 67, 8 for w = 2)."""
    n = 3000
    qc, dbc = _ham_codes(7, n + 1, w, 11 + w)
    qt, whole = _ham_to(cuda, qc, dbc)
    view = whole[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    route = "list" if c <= ham_ops.LIST_MAX_C else "count"
    dist, idx = _ham_call(qt, view, c, route)
    want_d, want_i = hamming_topk_ref(qt, view.contiguous(), c)
    assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    d2, i2 = _ham_call(qt, view.clone(), c, route)
    assert torch.equal(dist, d2) and torch.equal(idx, i2)


@pytest.mark.parametrize("b,n,d,k", [(4, 300, 64, 8), (9, 700, 259, 8),
                                     (64, 3000, 259, 8), (3, 130, 32, 60)])
def test_rescore_at_full_coverage_is_the_exact_scan(cuda, b, n, d, k):
    q, db = _flagged_data(b, n, d, seed=b + n + 1)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    bias = (mips_ops.MASK_BIAS, 0.0, 0.0)
    q_aug = mips_ops.augment_queries(qt, bias).contiguous()
    want_v, want_i = mips_ops.flagged_mips_topk(qt, dbt, k, bias)
    # every row a candidate, each query's list in its own order
    gen = torch.Generator(device=cuda).manual_seed(n)
    cand = torch.stack([torch.randperm(n, device=cuda, generator=gen)
                        for _ in range(b)]).to(torch.int32)
    before = mips_ops.rescore_launch_count()
    vals, idx = mips_ops.mips_rescore(q_aug, dbt, cand, k)
    assert mips_ops.rescore_launch_count() == before + 1
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)
    # a partial list: its scores are the exact kernel's for those rows
    part = cand[:, : max(k, n // 3)].contiguous()
    pv, pi = mips_ops.mips_rescore(q_aug, dbt, part, k)
    plain_v, plain_i = mips_ops.mips_rescore(q_aug.cpu(), dbt.cpu(),
                                             part.cpu(), k)
    np.testing.assert_allclose(pv.cpu().numpy(), plain_v.numpy(), rtol=0,
                               atol=SCORE_TOL)
    for j in range(b):
        rows = pi[j].long()
        ev, _ = mips_ops.mips_topk(q_aug[j:j + 1].contiguous(),
                                   dbt[rows].contiguous(), k)
        assert torch.equal(ev[0], pv[j])


def _rescore_call(q, db, cand, k):
    """One ``mips_rescore`` call on the card: exactly one kernel launch."""
    before = mips_ops.rescore_launch_count()
    vals, idx = mips_ops.mips_rescore(q, db, cand, k)
    assert mips_ops.rescore_launch_count() == before + 1
    return vals, idx


def _assert_rescore_matches(vals, idx, q, db, cand, k):
    """Against the plain version: scores within SCORE_TOL, ids equal away
    from near-ties; and every returned score is bitwise the exact scan's
    (``mips_topk``) for its row, the rows in the scan's order."""
    c = cand.shape[1]
    pv, pi = mips_ops.mips_rescore(q.cpu(), db.cpu(), cand.cpu(),
                                   min(k + 1, c))
    got_v, got_i = vals.cpu(), idx.cpu()
    assert float((got_v - pv[:, :k]).abs().max()) <= SCORE_TOL
    near = torch.zeros_like(pv, dtype=torch.bool)
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= SCORE_TOL
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert not ((got_i != pi[:, :k]) & ~near[:, :k]).any()
    for j in range(q.shape[0]):
        rows = torch.sort(idx[j].long()).values
        ev, ei = mips_ops.mips_topk(q[j:j + 1].contiguous(),
                                    db[rows].contiguous(), k)
        assert torch.equal(ev[0], vals[j])
        assert torch.equal(rows[ei[0].long()], idx[j].long())


def _rescore_inputs(b, n, d, c, seed):
    """Unit rows and queries; each query's c distinct candidates in
    random order (every row at c = n); rows 100..104 (d > 1) copies of
    query 0 among its candidates."""
    rng = np.random.default_rng(seed)
    db, q = _unit_rows(rng, n, d), _unit_rows(rng, b, d)
    cand = np.stack([rng.permutation(n)[:c] for _ in range(b)])
    planted = []
    if d > 1 and c >= 5:
        planted = list(range(100, 105))
        db[planted] = q[0]
        others = [r for r in cand[0] if r not in planted]
        cand[0] = rng.permutation(planted + others[:c - 5])
    return q, db, cand.astype(np.int32), planted


# (b, n, d, c, k): C from k to full coverage across the grid's shapes
# (one warp, several warps of one block, clusters of 3 and 8 blocks), k
# 1 to 64, b 1 to 65, d 1 to 1024
RESCORE_CASES = [
    (64, 5000, 259, 32, 8),              # the serving shape
    (64, 5000, 259, 8, 8),               # C = k
    (5, 3000, 259, 31, 8),
    (65, 3000, 259, 33, 8),
    (5, 3000, 64, 100, 32),
    (1, 3000, 259, 129, 33),
    (5, 3000, 259, 288, 8),              # a cluster of 3 blocks
    (64, 20000, 259, 512, 64),
    (5, 20000, 259, 4096, 8),            # clusters of 8 blocks
    (65, 9000, 64, 4096, 1),
    (1, 9000, 259, 4096, 64),
    (5, 3000, 1024, 129, 64),
    (64, 3000, 1024, 32, 32),
    (64, 3000, 1, 100, 8),               # d = 1: every score +-q, ties
    (5, 3000, 259, 3000, 64),            # full coverage
    (64, 700, 259, 700, 8),
    (1, 3000, 259, 1, 1),
    (65, 3000, 64, 33, 33),
    (5, 3000, 259, 64, 64)]


@pytest.mark.parametrize("b,n,d,c,k", RESCORE_CASES)
def test_rescore_matches_plain_and_the_exact_scan(cuda, b, n, d, c, k):
    q, db, cand, planted = _rescore_inputs(b, n, d, c, b + n + d + c + k)
    qt, dbt, ct = (torch.from_numpy(a).to(cuda) for a in (q, db, cand))
    vals, idx = _rescore_call(qt, dbt, ct, k)
    _assert_rescore_matches(vals, idx, qt, dbt, ct, k)
    # the equal rows tie exactly and come first, in row order, whatever
    # their places in the list
    m = min(k, len(planted))
    assert idx[0, :m].tolist() == planted[:m]
    assert bool((vals[0, :m] == vals[0, 0]).all())
    if c == n:   # full coverage: bitwise the exact scan
        ev, ei = mips_ops.mips_topk(qt, dbt, k)
        assert torch.equal(vals, ev) and torch.equal(idx, ei)
    for j in sorted({0, b - 1}):   # each query alone, bitwise
        v1, i1 = _rescore_call(qt[j:j + 1].contiguous(), dbt,
                               ct[j:j + 1].contiguous(), k)
        assert torch.equal(v1, vals[j:j + 1]) and torch.equal(i1,
                                                               idx[j:j + 1])


@pytest.mark.parametrize("c", [32, 4096])
def test_rescore_b1_is_query_0_of_b64(cuda, c):
    q, db, cand, _ = _rescore_inputs(64, 20000, 259, c, c)
    qt, dbt, ct = (torch.from_numpy(a).to(cuda) for a in (q, db, cand))
    vals, idx = _rescore_call(qt, dbt, ct, 8)
    v1, i1 = _rescore_call(qt[:1].contiguous(), dbt, ct[:1].contiguous(), 8)
    assert torch.equal(v1, vals[:1]) and torch.equal(i1, idx[:1])
    assert idx[0, :5].tolist() == list(range(100, 105))


@pytest.mark.parametrize("c", [32, 129, 4096])
def test_rescore_takes_a_db_view_one_row_in(cuda, c):
    """A DB that starts one row (1036 bytes) into its storage: 4-byte
    aligned, not 16."""
    q, db, cand, _ = _rescore_inputs(7, 5000, 259, c, 3 + c)
    qt, dbt, ct = (torch.from_numpy(a).to(cuda) for a in (q, db, cand))
    view = torch.empty((5001, 259), device=cuda)[1:]
    view.copy_(dbt)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    vals, idx = _rescore_call(qt, view, ct, 8)
    _assert_rescore_matches(vals, idx, qt, dbt, ct, 8)
    v2, i2 = _rescore_call(qt, dbt, ct, 8)
    assert torch.equal(vals, v2) and torch.equal(idx, i2)


@pytest.mark.parametrize("c,valid", [(64, 40), (4200, 40), (37, 5)])
def test_rescore_never_scores_candidates_outside_the_rows(cuda, c, valid):
    """Candidates below 0 or at n and beyond, among `valid` real ones:
    never returned; the rest is the rescore of the real ones alone, and
    with fewer than k real ones the last slots stay (-inf, INT_MAX)."""
    b, n, d, k = 5, 3000, 259, 8
    q, db, real, _ = _rescore_inputs(b, n, d, valid, c + valid)
    rng = np.random.default_rng(c)
    bad = rng.choice(np.array([-1, -2**31, n, n + 7, 2**31 - 1], np.int32),
                     size=(b, c - valid))
    cand = np.concatenate([real, bad], axis=1)
    for row in cand:
        rng.shuffle(row)
    qt, dbt, ct, rt = (torch.from_numpy(a).to(cuda)
                       for a in (q, db, cand.astype(np.int32), real))
    vals, idx = _rescore_call(qt, dbt, ct, k)
    assert bool(((idx >= 0) & (idx < n)).sum(dim=1).eq(min(k, valid)).all())
    m = min(k, valid)
    want_v, want_i = _rescore_call(qt, dbt, rt, m)
    assert torch.equal(vals[:, :m], want_v) and torch.equal(idx[:, :m],
                                                            want_i)
    assert bool((vals[:, m:] == -float("inf")).all())
    assert bool((idx[:, m:] == 2**31 - 1).all())


def test_rescore_refused_grid_raises(cuda, monkeypatch):
    """A grid the launcher was not built for is refused and raises: no
    other route runs and nothing is counted."""
    q, db, cand, _ = _rescore_inputs(4, 3000, 259, 600, 9)
    qt, dbt, ct = (torch.from_numpy(a).to(cuda) for a in (q, db, cand))
    monkeypatch.setattr(mips_ops, "rescore_grid",
                        lambda b, c, sms: common.RescoreGrid(1, 4, 64, 10))
    before = mips_ops.rescore_launch_count()
    with pytest.raises(RuntimeError, match="CUDA error"):
        mips_ops.mips_rescore(qt, dbt, ct, 8)
    assert mips_ops.rescore_launch_count() == before


def test_quantized_full_coverage_on_card(cuda):
    q, db = _flagged_data(16, 2000, 256, seed=7)
    spec = quant_ops.QuantSpec(256, 64, 3, 0)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    planes = torch.from_numpy(quant_ops.hyperplanes(spec)).to(cuda)
    codes = quant_ops.encode_rows(dbt[:, :256], dbt[:, 256:], planes, spec)
    for bias in ((mips_ops.MASK_BIAS, 0.0, 0.0),
                 (mips_ops.MASK_BIAS, mips_ops.MASK_BIAS, 0.0)):
        full = quant_ops.quantized_flagged_topk(qt, dbt, codes, 8, 2000,
                                                bias, planes, spec)
        exact = mips_ops.flagged_mips_topk(qt, dbt, 8, bias)
        assert torch.equal(full[0], exact[0])
        assert torch.equal(full[1], exact[1])


def test_quickstart_on_card_matches_cpu(cuda):
    _quickstart_card_vs_cpu(cuda, quantized_scan=False)


def test_quantized_quickstart_on_card_matches_cpu(cuda):
    _quickstart_card_vs_cpu(cuda, quantized_scan=True)


@pytest.mark.parametrize("quantized_scan", [False, True])
def test_sharded_quickstart_on_card_matches_cpu(cuda, quantized_scan):
    _quickstart_card_vs_cpu(cuda, quantized_scan, index_shards=4)


def _quickstart_card_vs_cpu(cuda, quantized_scan, index_shards=1):
    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                       max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024, quantized_scan=quantized_scan,
                       index_shards=index_shards)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)
    gpu = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    cpu = EraRAG(cfg, HashingEmbedder(dim=128), device="cpu")
    for docs in [init] + rounds:
        assert gpu.insert_docs(docs).tokens_total == \
            cpu.insert_docs(docs).tokens_total
    assert list(gpu.graph.nodes) == list(cpu.graph.nodes)
    questions = [qa.question for qa in corpus.qa[:30]]
    for mode in ("collapsed", "detailed", "summarized", "multihop"):
        for a, b in zip(gpu.query_batch(questions, mode=mode),
                        cpu.query_batch(questions, mode=mode)):
            assert [(h.node_id, h.seq) for h in a.hits] == \
                [(h.node_id, h.seq) for h in b.hits]
            assert a.context == b.context
            np.testing.assert_allclose([h.score for h in a.hits],
                                       [h.score for h in b.hits],
                                       rtol=0, atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# the sharded store: every kernel on a slot view, the merge, the store
# ---------------------------------------------------------------------------

# (slots, capacity, row width): slot 2 of a stacked buffer starts
# 2 * cap * width * 4 bytes in, 16-byte aligned for the store's
# power-of-two capacities and 4- or 8-byte aligned for the odd ones
SLOT_CASES = [(4, 4096, 259), (4, 77, 259), (3, 1031, 64), (8, 640, 131)]


def _slot_view(stack, slot):
    view = stack[slot]
    assert view.is_contiguous() and view.storage_offset() > 0
    assert view.data_ptr() == stack.data_ptr() + \
        slot * view.numel() * stack.element_size()
    return view


@pytest.mark.parametrize("s,cap,w", SLOT_CASES)
def test_mips_topk_on_a_slot_view(cuda, s, cap, w):
    rng = np.random.default_rng(cap + w)
    stack = torch.from_numpy(
        rng.standard_normal((s, cap, w)).astype(np.float32)).to(cuda)
    stack[2, 5] = stack[2, 9]                  # a tie inside the slot
    q = torch.from_numpy(_unit_rows(rng, 16, w)).to(cuda)
    view = _slot_view(stack, 2)
    before = mips_ops.launch_count()
    vals, idx = mips_ops.mips_topk(q, view, 8)
    assert mips_ops.launch_count() == before + 1
    want_v, want_i = mips_ops.mips_topk(q, view.clone(), 8)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


@pytest.mark.parametrize("s,cap,w", SLOT_CASES)
def test_lsh_hash_on_a_slot_view(cuda, s, cap, w):
    rng = np.random.default_rng(cap + w + 1)
    stack = torch.from_numpy(
        rng.standard_normal((s, cap, w)).astype(np.float32)).to(cuda)
    h = torch.from_numpy(
        rng.standard_normal((w, 64)).astype(np.float32)).to(cuda)
    view = _slot_view(stack, 2)
    before = lsh_ops.launch_count()
    got = lsh_ops.lsh_hash(view, h)
    assert lsh_ops.launch_count() == before + 1
    assert torch.equal(got, lsh_ops.lsh_hash(view.clone(), h))


@pytest.mark.parametrize("s,cap,w", [(4, 4096, 11), (4, 77, 11),
                                     (3, 1031, 2), (8, 640, 67)])
@pytest.mark.parametrize("c", [32, 200])
def test_hamming_topk_on_a_slot_view(cuda, s, cap, w, c):
    qc, dbc = _ham_codes(9, s * cap, w, cap + w + c)
    qt, flat = _ham_to(cuda, qc, dbc)
    view = _slot_view(flat.view(s, cap, w), 2)
    c = min(c, cap)
    route = "list" if c <= ham_ops.LIST_MAX_C else "count"
    dist, idx = _ham_call(qt, view, c, route)
    d2, i2 = _ham_call(qt, view.clone(), c, route)
    assert torch.equal(dist, d2) and torch.equal(idx, i2)


@pytest.mark.parametrize("s,cap,w", SLOT_CASES)
@pytest.mark.parametrize("c", [32, 300])
def test_mips_rescore_on_a_slot_view(cuda, s, cap, w, c):
    rng = np.random.default_rng(cap + w + c)
    stack = torch.from_numpy(_unit_rows(rng, s * cap, w)).to(cuda)
    view = _slot_view(stack.view(s, cap, w), 2)
    q = torch.from_numpy(_unit_rows(rng, 16, w)).to(cuda)
    c = min(c, cap)
    cand = torch.from_numpy(np.stack(
        [rng.permutation(cap)[:c] for _ in range(16)]).astype(
            np.int32)).to(cuda)
    vals, idx = _rescore_call(q, view, cand, 8)
    v2, i2 = _rescore_call(q, view.clone(), cand, 8)
    assert torch.equal(vals, v2) and torch.equal(idx, i2)


@pytest.mark.parametrize("s,b,kk,k", [(4, 64, 8, 8), (8, 64, 8, 8),
                                      (4, 3, 64, 64), (2, 1, 5, 7)])
def test_merge_on_card_matches_cpu(cuda, s, b, kk, k):
    rng = np.random.default_rng(s * b + kk)
    vals = rng.choice(np.float32([0.5, 0.25, 0.0, -0.0, -3e30]),
                      size=(s, b, kk)).astype(np.float32)
    seqs = rng.permutation(s * b * kk).reshape(s, b, kk).astype(np.int32)
    vals[-1, :, kk // 2:] = mips_ops.VAL_PAD
    seqs[-1, :, kk // 2:] = mips_ops.SEQ_PAD
    k = min(k, s * kk)
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seqs)
    gv, gs = mips_ops.merge_sharded_topk(tv.to(cuda), ts.to(cuda), k)
    cv, cs = mips_ops.merge_sharded_topk(tv, ts, k)
    assert torch.equal(gs.cpu(), cs)
    assert torch.equal(gv.cpu().view(torch.int32), cv.view(torch.int32))


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_store_on_card_is_the_flat_store(cuda, quantized):
    """Growth, removal and re-insertion at 1, 3 and 8 shards: every hit
    equal to the flat store's on the card, score bits included; the
    sharded loop launches its kernels once a non-empty shard."""
    from repro_torch.core.store import ShardedVectorStore, VectorStore
    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4,
                       s_max=12, max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024, index_shards=3,
                       quantized_scan=quantized, coarse_mult=10 ** 6)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 3)
    rag = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    flat = VectorStore(rag.graph, device=cuda)
    q = np.asarray(rag.embedder.encode(
        [qa.question for qa in corpus.qa[:16]]), np.float32)

    def same():
        for filt in (None, "leaf", "summary"):
            a = rag.store.search_batch(q, 8, filt)
            b = flat.search_batch(q, 8, filt)
            assert [[(h.node_id, h.layer, h.seq,
                      np.float32(h.score).view(np.uint32)) for h in x]
                    for x in a] == \
                [[(h.node_id, h.layer, h.seq,
                   np.float32(h.score).view(np.uint32)) for h in x]
                 for x in b]

    for docs in [init] + rounds:
        rag.insert_docs(docs)
        same()
    victims = sorted({d for d, _ in rounds[-1]})
    rag.remove_docs(victims)
    same()
    rag.insert_docs(rounds[-1])
    same()
    for n in (8, 1, 3):
        rag.reshard(n)
        same()
    assert isinstance(rag.store, ShardedVectorStore)
    mips_ops.reset_launch_count()
    ham_ops.reset_launch_count()
    rag.store.search_batch(q, 8)
    non_empty = sum(sh.count > 0 for sh in rag.store._shards)
    if quantized:
        assert ham_ops.launch_count() == non_empty
        assert mips_ops.rescore_launch_count() == non_empty
    else:
        assert mips_ops.launch_count() == non_empty
    assert mips_ops.merge_launch_count() == 1


# ---------------------------------------------------------------------------
# flash attention: forward and backward kernels against the plain version
# ---------------------------------------------------------------------------
# |out error| <= out_abs + out_rel * |plain out|.  The kernels and the
# plain version (fp32 cuBLAS products) sum in other orders, ~1e-7 of the
# summed terms apart (out_abs); bf16 outputs round those fp32 values, so
# one may land one bf16 step apart (out_rel = 2^-7), and the kernels'
# backward reads the bf16 output for D = rowsum(dO * O) where the plain
# autograd keeps it in fp32.
FA_TOL = {torch.float32: {"out_abs": 2e-5, "out_rel": 0.0, "lse": 2e-5,
                          "grad": 1e-5},
          torch.bfloat16: {"out_abs": 2e-5, "out_rel": 2.0 ** -7,
                           "lse": 2e-5, "grad": 1e-2}}


def _attn_inputs(b, hq, hkv, lq, lk, d, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(dtype).to(device)
                   for shape in ((b, hq, lq, d), (b, hkv, lk, d),
                                 (b, hkv, lk, d), (b, hq, lq, d)))
    return q, k, v, do


def _rel_fro(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) /
                 max(float(torch.linalg.norm(want)), 1e-30))


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal,dtype", [
    (1, 1, 1, 1, 1, 16, True, torch.float32),
    (2, 4, 4, 37, 37, 16, True, torch.float32),       # group 1, odd l
    (1, 8, 2, 65, 130, 32, True, torch.float32),      # lq < lk causal
    (2, 8, 1, 100, 77, 64, False, torch.float32),     # group 8, lq > lk
    (1, 4, 1, 129, 129, 128, True, torch.float32),    # group 4
    (1, 8, 2, 63, 200, 128, False, torch.float32),
    (2, 8, 2, 256, 256, 128, True, torch.bfloat16),
    (1, 4, 4, 70, 91, 64, True, torch.bfloat16),
    # bf16, the tensor-core route: every d, odd lengths, lq < lk causal,
    # group 8 with lq > lk not causal, single rows
    (1, 1, 1, 1, 1, 16, True, torch.bfloat16),
    (2, 4, 4, 37, 37, 16, True, torch.bfloat16),
    (1, 8, 2, 65, 130, 32, True, torch.bfloat16),
    (2, 8, 1, 100, 77, 64, False, torch.bfloat16),
    (1, 4, 1, 129, 129, 128, True, torch.bfloat16),
    (1, 8, 2, 63, 200, 128, False, torch.bfloat16),
    (1, 8, 1, 1, 33, 128, True, torch.bfloat16),
])
def test_flash_attention_kernels_match_plain(cuda, b, hq, hkv, lq, lk, d,
                                             causal, dtype):
    q, k, v, do = _attn_inputs(b, hq, hkv, lq, lk, d, dtype, cuda,
                               seed=lq + lk + d)
    tol = FA_TOL[dtype]
    before = fa_ops.launch_count()
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, causal)
    assert fa_ops.launch_count() == before + 1
    want = attention_ref(q, k, v, causal=causal).float()
    assert o.dtype == dtype and o.shape == q.shape
    diff = (o.float() - want).abs()
    assert bool((diff <= tol["out_abs"] + tol["out_rel"] * want.abs()).all())
    want_lse = attention_lse_ref(q, k, causal=causal)
    assert float((lse - want_lse).abs().max()) <= tol["lse"]

    before = fa_ops.bwd_launch_count()
    grads = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert fa_ops.bwd_launch_count() == before + 1
    for got, ref_g in zip(grads, attention_grads_ref(q, k, v, do,
                                                     causal=causal)):
        assert got.dtype == ref_g.dtype and got.shape == ref_g.shape
        assert _rel_fro(got, ref_g) <= tol["grad"]


def test_flash_attention_autograd_on_card(cuda):
    q, k, v, do = _attn_inputs(2, 8, 2, 96, 96, 64, torch.float32, cuda, 5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    want = attention_grads_ref(q, k, v, do, causal=True)
    for leaf, ref_g in zip(leaves, want):
        assert _rel_fro(leaf.grad, ref_g) <= FA_TOL[torch.float32]["grad"]


def test_flash_attention_backward_is_deterministic(cuda):
    q, k, v, do = _attn_inputs(1, 8, 2, 300, 300, 128, torch.bfloat16,
                               cuda, 7)
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, True)
    first = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    second = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(o, fa_ops.flash_attention_fwd_cuda(q, k, v, True)[0])


def test_flash_attention_bf16_backward_is_deterministic_when_ragged(cuda):
    q, k, v, do = _attn_inputs(2, 8, 1, 77, 131, 64, torch.bfloat16, cuda,
                               9)
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, False)
    first = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, False)
    second = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tensor_core_bf16"), (torch.float32, "fma_fp32")])
def test_flash_attention_route_follows_the_dtype(cuda, dtype, route):
    q, k, v, do = _attn_inputs(1, 4, 2, 64, 64, 128, dtype, cuda, 3)
    fa_ops.reset_launch_count()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.flash_attention(*leaves, causal=True).backward(do)
    counts = fa_ops.route_launch_counts()
    for pass_ in ("fwd", "bwd"):
        assert counts[pass_] == {r: int(r == route)
                                 for r in fa_ops.ROUTES.values()}


def test_flash_attention_bf16_inputs_must_be_16_byte_aligned(cuda):
    q, k, v, do = _attn_inputs(1, 4, 2, 40, 40, 64, torch.bfloat16, cuda, 4)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)            # 2 bytes past alignment
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.flash_attention_fwd_cuda(shifted, k, v, True)
    want = fa_ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(fa_ops.flash_attention(shifted, k, v, causal=True),
                       want)


def test_flash_attention_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _attn_inputs(1, 2, 1, 8, 8, 48, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="d in"):
        fa_ops.flash_attention(q, k, v)
    q, k, v, _ = _attn_inputs(1, 2, 1, 9, 8, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="lq <= lk"):
        fa_ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_fwd_cuda(q.half(), k.half(), v.half(), False)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention_fwd_cuda(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v, False)


def test_flash_attention_custom_op_launches_the_kernel_once(cuda):
    """The registered custom ops (``repro_torch::flash_attention_fwd`` /
    ``_bwd``) launch the wrapper's kernels: one launch of each a call,
    counted once, the same bits as the direct launch."""
    q, k, v, do = _attn_inputs(1, 8, 2, 128, 128, 64, torch.bfloat16, cuda,
                               11)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.reset_launch_count()
    out = fa_ops.flash_attention(*leaves, causal=True)
    assert (fa_ops.launch_count(), fa_ops.bwd_launch_count()) == (1, 0)
    out.backward(do)
    assert (fa_ops.launch_count(), fa_ops.bwd_launch_count()) == (1, 1)
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, True)
    assert torch.equal(out, o)
    for leaf, want in zip(leaves, fa_ops.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, True)):
        assert torch.equal(leaf.grad, want)
    got = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, None)
    assert fa_ops.launch_count() == 3
    assert torch.equal(got[0], o) and torch.equal(got[1], lse)


def test_flash_attention_fake_route_gives_the_kernel_shapes(cuda):
    """On fake card tensors (the dry run's) the ops' shape contracts
    give the kernels' output shapes and dtypes, and nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v, do = _attn_inputs(2, 8, 2, 64, 96, 128, torch.bfloat16, cuda,
                               12)
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, True)
    grads = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    fa_ops.reset_launch_count()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v, do))
        fo, flse = torch.ops.repro_torch.flash_attention_fwd(fq, fk, fv,
                                                            True, None)
        fgrads = torch.ops.repro_torch.flash_attention_bwd(
            fq, fk, fv, fo, flse, fdo, True, None)
    for fake, real in zip((fo, flse, *fgrads), (o, lse, *grads)):
        assert (fake.shape, fake.dtype, fake.device) == \
            (real.shape, real.dtype, real.device)
    assert (fa_ops.launch_count(), fa_ops.bwd_launch_count()) == (0, 0)


def test_lm_loss_and_grads_on_card_match_cpu(cuda):
    from repro_torch.configs.llama3_8b import llama3_8b
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from repro_torch.models.transformer import init_params, loss_fn

    cfg = llama3_8b().reduced()
    tree = params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 40, seed=1)(0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = params_from_numpy(tree, cfg, device=dev)
        loss, _ = loss_fn(model, batch, cfg, compute_dtype=torch.float32)
        loss.backward()
        out[dev.type] = loss.item(), params_to_numpy(model, grads=True)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    gg, gc = out["cuda"][1], out["cpu"][1]
    pairs = [(gg["embed"], gc["embed"]), (gg["lm_head"], gc["lm_head"])]
    for sub in ("attn", "ffn"):
        pairs += [(gg["layers"][0][sub][n], gc["layers"][0][sub][n])
                  for n in gc["layers"][0][sub]]
    for a, b in pairs:
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the retrieval front without an LM: baselines, query cache, ingest
# ---------------------------------------------------------------------------

FRONT_CFG = dict(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                 max_layers=3, chunk_tokens=32, top_k=8, token_budget=1024)


@pytest.mark.parametrize("name", ["VanillaRAG", "RaptorLike",
                                  "GraphRAGLike"])
def test_dense_baseline_on_card_matches_cpu(cuda, name):
    """A build plus three rounds on the card and on the CPU: equal
    update reports, hit ids, contexts; scores within SCORE_TOL; one
    ``mips_topk`` launch a question (b = 1)."""
    from repro_torch.core import baselines
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 3)
    cfg = EraRAGConfig(**FRONT_CFG)
    gpu = getattr(baselines, name)(cfg, HashingEmbedder(dim=128),
                                   device=cuda)
    cpu = getattr(baselines, name)(cfg, HashingEmbedder(dim=128),
                                   device="cpu")
    for docs in [init] + rounds:
        a, b = gpu.insert_docs(docs), cpu.insert_docs(docs)
        assert (a.tokens_in, a.tokens_out, a.n_new_chunks,
                a.n_resummarized) == (b.tokens_in, b.tokens_out,
                                      b.n_new_chunks, b.n_resummarized)
    assert gpu._embs.device.type == "cuda"
    assert torch.equal(gpu._embs.cpu(), cpu._embs)
    questions = [qa.question for qa in corpus.qa[:40]]
    mips_ops.reset_launch_count()
    for q in questions:
        a, b = gpu.query(q), cpu.query(q)
        assert [h.node_id for h in a.hits] == [h.node_id for h in b.hits]
        assert (a.context, a.n_tokens) == (b.context, b.n_tokens)
        np.testing.assert_allclose([h.score for h in a.hits],
                                   [h.score for h in b.hits],
                                   rtol=0, atol=SCORE_TOL)
    assert mips_ops.launch_count() == len(questions)


def test_query_cache_over_the_quantized_store_on_card(cuda):
    """The cache in front of the two-stage scan: a cold batch equals a
    cache-off card store bit for bit, a warm batch launches nothing,
    a half-new batch sweeps only its misses, an insert invalidates."""
    cfg = EraRAGConfig(**FRONT_CFG, quantized_scan=True)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 2)
    cached = EraRAG(dataclasses.replace(cfg, query_cache=True),
                    HashingEmbedder(dim=128), device=cuda)
    plain = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    for rag in (cached, plain):
        for docs in [init] + rounds[:1]:
            rag.insert_docs(docs)
    qs = [qa.question for qa in corpus.qa[:24]]

    def bits(rets):
        return [([(h.node_id, h.seq, np.float32(h.score).view(np.uint32))
                  for h in r.hits], r.context) for r in rets]

    def launches():
        return (lsh_ops.launch_count(), ham_ops.launch_count(),
                mips_ops.rescore_launch_count(), mips_ops.launch_count())

    for mode in ("collapsed", "detailed"):
        assert bits(cached.query_batch(qs, mode=mode)) == \
            bits(plain.query_batch(qs, mode=mode))
        before = launches()
        assert bits(cached.query_batch(qs, mode=mode)) == \
            bits(plain.query_batch(qs, mode=mode))
        # the plain store's sweep launched; the cached one nothing
        after = launches()
        plain_only = [a - b for a, b in zip(after, before)]
        assert plain_only[1] > 0 and plain_only[2] > 0
    rounds_before = cached.stats["retrieval_rounds"]
    hams = ham_ops.launch_count()
    half = qs[:12] + [q + " again" for q in qs[12:]]
    assert bits(cached.query_batch(half)) == bits(plain.query_batch(half))
    assert cached.stats["retrieval_rounds"] == rounds_before + 1
    # one sweep each side: the cached side's b = 12, the plain's b = 24
    assert ham_ops.launch_count() - hams == 2
    for rag in (cached, plain):
        rag.insert_docs(rounds[1])
    assert bits(cached.query_batch(qs)) == bits(plain.query_batch(qs))
    assert cached.query_cache.stats.invalidations == 1


@pytest.mark.parametrize("k", [12, 64])
def test_ingest_sub_batch_codes_are_the_one_shot_codes(cuda, k):
    """``lsh_hash`` is row-deterministic on every grid: hashing a burst
    in the ingest service's sub-batches of 1..64 rows gives each row
    the codes the one-shot hash gives it, bit for bit."""
    from repro_torch.core.lsh import HyperplaneLSH
    rng = np.random.default_rng(k)
    rows = rng.standard_normal((517, 256)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    lsh = HyperplaneLSH(256, k, seed=0, device=cuda)
    one_shot = lsh.hash_packed(rows)
    for batch in (1, 5, 33, 64):
        before = lsh_ops.launch_count()
        parts = [lsh.hash_packed(rows[i:i + batch])
                 for i in range(0, len(rows), batch)]
        assert lsh_ops.launch_count() - before == len(parts)
        np.testing.assert_array_equal(np.concatenate(parts), one_shot)


def test_ingest_service_on_card_is_the_sync_insert(cuda):
    """A burst plus a removal through ``IngestService`` on the card:
    node ids, store rows (bytes) and hits equal a synchronous twin's;
    one ``lsh_hash`` launch an embed tick."""
    from repro_torch.ingest import IngestService
    cfg = EraRAGConfig(**FRONT_CFG)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 2)
    live = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    twin = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    for rag in (live, twin):
        rag.insert_docs(init)
        rag.store.refresh()
    svc = IngestService(live, docs_per_tick=4, embed_batch=16)
    svc.submit_many(rounds[0])
    svc.remove([rounds[0][0][0]])
    svc.submit_many(rounds[1])
    qs = [qa.question for qa in corpus.qa[:16]]
    while not svc.idle:
        before = lsh_ops.launch_count()
        stage = svc.tick()
        if stage == "embed":
            assert lsh_ops.launch_count() - before <= 1
        live.query_batch(qs)
    # the twin replays each committed op as the service lands it: one
    # graph update, then one store refresh (the store's row order
    # follows its refresh history)
    for kind, payload in svc.committed_ops:
        (twin.insert_docs if kind == "insert" else twin.remove_docs)(
            payload)
        twin.store.refresh()
    assert list(live.graph.nodes) == list(twin.graph.nodes)
    a, b = live.store.state_dict()["shard"], twin.store.state_dict()["shard"]
    assert np.asarray(a["buf"]).tobytes() == np.asarray(b["buf"]).tobytes()
    assert a["row_ids"] == b["row_ids"]
    for x, y in zip(live.query_batch(qs), twin.query_batch(qs)):
        assert [(h.node_id, h.score) for h in x.hits] == \
            [(h.node_id, h.score) for h in y.hits]


# ---------------------------------------------------------------------------
# LM serving (plain torch on the card: the engine's attention runs the
# cache compositions, no kernel of csrc/)
# ---------------------------------------------------------------------------
SERVE_PROMPTS = ["alpha beta", "tell me about alpha beta",
                 "gamma delta question about the river",
                 "a considerably longer question that lands in a larger "
                 "padded bucket than the short prompts do",
                 "epsilon zeta words"]
SERVE_LOGIT_TOL = 1e-4      # fp32 tiny engine, card against CPU


class _StepLogits:
    """Each request's logits by step, read by wrapping the engine's
    ``_pick``."""

    def __init__(self, engine):
        self.rows = {}
        pick = engine._pick

        def observed(logits, rows, keys):
            for row, (rid, step) in zip(rows, keys):
                self.rows[rid, step] = logits[row].detach().to(
                    "cpu", torch.float32)
            return pick(logits, rows, keys)

        engine._pick = observed


def _margin_rule(a, b, outs_a, outs_b):
    """Tokens equal, or where a request's tokens part the smaller top-1
    over top-2 margin lies within the logit difference at that step.
    Returns the largest logit difference over the steps compared."""
    worst = 0.0
    for rid, (x, y) in enumerate(zip(outs_a, outs_b)):
        for step in range(max(len(x.split()), len(y.split())) + 1):
            if (rid, step) not in a.rows or (rid, step) not in b.rows:
                break
            la, lb = a.rows[rid, step], b.rows[rid, step]
            diff = float((la - lb).abs().max())
            worst = max(worst, diff)
            if int(la.argmax()) != int(lb.argmax()):
                margin = min(float(t[0] - t[1]) for t in
                             (torch.topk(la, 2).values,
                              torch.topk(lb, 2).values))
                assert margin <= diff, (rid, step, margin, diff)
                break
    return worst


def test_engine_on_card_matches_cpu(cuda):
    """The tiny recipe (weights drawn once on the CPU) gives the CPU's
    tokens and stats on the card, logits within SERVE_LOGIT_TOL."""
    from repro_torch.serving.testing import make_test_engine
    engines = [make_test_engine(max_batch=5, device=d)
               for d in ("cpu", cuda)]
    logs = [_StepLogits(e) for e in engines]
    outs = [e.generate_batch(SERVE_PROMPTS) for e in engines]
    assert _margin_rule(*logs, *outs) <= SERVE_LOGIT_TOL
    assert engines[0].stats == engines[1].stats
    assert engines[1].caches["k"].is_cuda


def test_engine_launches_write_only_their_rows_on_card(cuda):
    """Every prefill, extend and decode launch on the card leaves each
    cache row outside its group bitwise unchanged."""
    from repro_torch.serving.testing import make_test_engine
    eng = make_test_engine(max_batch=4, prefix_cache_entries=2,
                           max_new_tokens=5, device=cuda)
    seen = []

    def guard(fn, at):
        def run(*args):
            before = {n: c.clone() for n, c in eng.caches.items()}
            out = fn(*args)
            rows = set(args[at])
            for n, c in eng.caches.items():
                for r in range(c.shape[1]):
                    if r not in rows:
                        assert torch.equal(c[:, r], before[n][:, r])
            seen.append(at)
            return out
        return run

    eng._prefill_bucket = guard(eng._prefill_bucket, 2)
    eng._prefill_extend = guard(eng._prefill_extend, 3)
    eng._decode_step = guard(eng._decode_step, 2)
    prefix = "Context:\nThe capital of France is Paris .\n\n"
    prompts = [prefix + f"Question: q{i}\nAnswer:" for i in range(5)]
    eng.generate_batch(SERVE_PROMPTS[:2] + prompts,
                       prefixes=[None, None] + [prefix] * 5)
    assert eng.stats["prefix_hits"] > 0 and len(set(seen)) == 2


def test_engine_batched_equals_sequential_on_card_bf16(cuda):
    """bf16 on the card, one ``max_batch``: a batch and the same prompts
    one at a time run the same GEMM shapes, so every step's logits are
    bitwise equal."""
    from repro_torch.common.config import LMConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig
    cfg = LMConfig(name="t", family="lm-dense", n_layers=2, d_model=128,
                   n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=1024,
                   max_seq_len=128)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                        dtype=torch.bfloat16)
    ecfg = EngineConfig(max_batch=5, max_seq_len=64, max_new_tokens=6,
                        compute_dtype=torch.bfloat16)
    bat, seq = Engine(cfg, model, ecfg), Engine(cfg, model, ecfg)
    logs = [_StepLogits(e) for e in (bat, seq)]
    outs = [bat.generate_batch(SERVE_PROMPTS),
            [seq.generate(p) for p in SERVE_PROMPTS]]
    assert _margin_rule(*logs, *outs) == 0.0
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the index lifecycle: policy migrations and epoch snapshots on the card
# ---------------------------------------------------------------------------

LIFE_CFG = dict(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                max_layers=3, chunk_tokens=32, top_k=8, token_budget=1024,
                index_shards=2)
LIFE_QUANT = dict(quantized=True, coarse_mult=4, scan_bits=64, scan_seed=0)


def _life_rag(device, quantized):
    from repro_torch.core.erarag import EraRAG
    cfg = EraRAGConfig(**LIFE_CFG, quantized_scan=quantized)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 3)
    rag = EraRAG(cfg, HashingEmbedder(dim=128), device=device)
    for docs in [init] + rounds:
        rag.insert_docs(docs)
    rag.remove_docs(sorted({d for d, _ in rounds[-1]}))
    rag.store.refresh()
    questions = [qa.question for qa in corpus.qa[:16]]
    return rag, np.asarray(rag.embedder.encode(questions), np.float32)


def _hit_bits(store, q):
    return [[(h.node_id, h.layer, h.seq,
              int(np.float32(h.score).view(np.uint32))) for h in hits]
            for filt in (None, "leaf", "summary")
            for hits in store.search_batch(q, 8, filt)]


@pytest.mark.parametrize("quantized", [False, True])
def test_policy_migration_on_card_equals_cpu(cuda, quantized):
    """A skew-triggered 2 -> 4 migration and a tombstone-triggered
    same-width replay, turn by turn on the card and on the CPU: the
    same plans, progress, epochs and counters; hits equal, scores
    within the kernels' tolerance."""
    from repro_torch.lifecycle import LifecyclePolicy
    rags = {dev: _life_rag(dev, quantized) for dev in (cuda, "cpu")}
    (gpu, q), (cpu, _) = rags[cuda], rags["cpu"]
    for policy in (LifecyclePolicy(skew_threshold=1e-6, min_rows=1,
                                   max_shards=4),
                   LifecyclePolicy(tombstone_threshold=1e-6, min_rows=1)):
        if policy.tombstone_threshold:
            for rag in (gpu, cpu):
                rag.store._compact_threshold = 1.0
                rag.remove_docs([n.doc_id for n in
                                 rag.graph.nodes.values()
                                 if n.layer == 0][:3])
        for rag in (gpu, cpu):
            rag.store.attach_lifecycle(policy)
        epoch = gpu.store.epoch
        while True:
            gpu.store.refresh()
            cpu.store.refresh()
            a, b = gpu.store.migration, cpu.store.migration
            assert (a is None) == (b is None)
            if a is not None:
                assert a.describe() == b.describe()
            assert gpu.store.epoch == cpu.store.epoch
            if gpu.store.epoch > epoch:
                break
        for rag in (gpu, cpu):
            rag.store.attach_lifecycle(None)
        assert gpu.store.n_shards == cpu.store.n_shards == 4
        stats = [dataclasses.asdict(r.store.stats) for r in (gpu, cpu)]
        for st in stats:     # the scan counters move with the searches
            st.pop("kernel_launches"), st.pop("quantized_scans")
        assert stats[0] == stats[1]
        for filt in (None, "leaf", "summary"):
            for x, y in zip(gpu.store.search_batch(q, 8, filt),
                            cpu.store.search_batch(q, 8, filt)):
                assert [(h.node_id, h.seq) for h in x] == \
                    [(h.node_id, h.seq) for h in y]
                np.testing.assert_allclose([h.score for h in x],
                                           [h.score for h in y],
                                           rtol=0, atol=SCORE_TOL)
    assert sum(sh.n_dead for sh in gpu.store._shards) == 0


@pytest.mark.parametrize("quantized", [False, True])
def test_lifecycle_snapshot_crosses_card_and_cpu(cuda, quantized,
                                                 tmp_path):
    """A half-built migration snapshot taken on the card restores on the
    CPU, is snapshotted there and restored back on the card: its arrays
    bitwise the card's, and the card's resumed migration lands on the
    unbroken migration's hits, score bits included."""
    from repro_torch.lifecycle import LifecycleManager, LifecyclePolicy
    rag, q = _life_rag(cuda, quantized)
    store = rag.store
    store.attach_lifecycle(LifecyclePolicy(skew_threshold=1e-6,
                                           min_rows=1, max_shards=4))
    store.refresh()
    store.refresh()                       # 1 of 4 target shards built
    assert len(store.migration.built) == 1
    qkw = LIFE_QUANT if quantized else {}
    card = LifecycleManager(store, tmp_path / "card")
    card.snapshot(block=True)
    on_cpu = card.restore(rag.graph, device="cpu", **qkw)
    assert on_cpu.device.type == "cpu"
    host = LifecycleManager(on_cpu, tmp_path / "cpu")
    host.snapshot(block=True)
    back = host.restore(rag.graph, device=cuda, **qkw)
    assert back.device == store.device and back.quantized == quantized
    from repro_torch.checkpoint import load_checkpoint
    _, one, ex1 = load_checkpoint(tmp_path / "card")
    _, two, ex2 = load_checkpoint(tmp_path / "cpu")
    assert list(one) == list(two) and ex1 == ex2
    for key in one:
        assert np.array_equal(one[key], two[key]), key
    lsh_ops.reset_launch_count()
    while back.migration is not None or store.migration is not None:
        back.refresh()
        store.refresh()
    assert back.epoch == store.epoch == 1 and back.n_shards == 4
    if quantized:          # the staged shards' code planes re-hashed
        assert lsh_ops.launch_count() > 0
    assert _hit_bits(back, q) == _hit_bits(store, q)


# ---------------------------------------------------------------------------
# the MoE FFN and Adafactor on the card
# ---------------------------------------------------------------------------
def _moe(device, dtype=torch.float32):
    from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
    from repro_torch.models.layers import moe_init
    cfg = dataclasses.replace(deepseek_moe_16b().reduced(), d_model=128)
    mod = moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                   dtype)
    return cfg, mod.to(device).requires_grad_(False)


@pytest.mark.parametrize("b,l,skew", [(8, 1, 0.0), (4, 64, 0.0),
                                      (4, 64, 3.0)])
def test_moe_fwd_on_card_matches_cpu(cuda, b, l, skew):
    """fp32: the same experts, capacity slots and liveness on both
    devices, outputs and aux within 1e-5; the skewed launch drops."""
    from repro_torch.models.layers import moe_fwd, moe_route
    cfg, cpu_mod = _moe("cpu")
    _, card_mod = _moe(cuda)
    rng = np.random.default_rng(b + l)
    x = rng.standard_normal((b, l, cfg.d_model)) + \
        skew * rng.standard_normal(cfg.d_model)
    x = torch.from_numpy((x / np.sqrt((x * x).mean(-1, keepdims=True)))
                         .astype(np.float32))
    routes = [moe_route(m.router, x.reshape(-1, cfg.d_model).to(dev),
                        cfg.moe) for m, dev in ((cpu_mod, "cpu"),
                                                (card_mod, cuda))]
    for name in ("gate_idx", "sel_idx", "live"):
        assert torch.equal(getattr(routes[0], name),
                           getattr(routes[1], name).cpu()), name
    if skew:
        assert int(routes[1].live.sum()) < routes[1].gate_idx.numel()
    want, want_aux = moe_fwd(cpu_mod.params(torch.float32), x, cfg.moe)
    got, aux = moe_fwd(card_mod.params(torch.float32), x.to(cuda), cfg.moe)
    assert float((got.cpu() - want).abs().max()) <= SCORE_TOL
    assert abs(float(aux) - float(want_aux)) <= SCORE_TOL


def test_moe_fwd_bf16_on_card_repeats_bitwise(cuda):
    from repro_torch.models.layers import moe_fwd
    cfg, mod = _moe(cuda, torch.bfloat16)
    x = torch.randn((8, 128, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    p = mod.params(torch.bfloat16)
    a, aux_a = moe_fwd(p, x, cfg.moe)
    b, aux_b = moe_fwd(p, x, cfg.moe)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_adafactor_on_card_matches_cpu(cuda):
    """Five updates over the reduced deepseek-moe-16b's parameter tree
    (expert stacks, stacked norms, the fp32 router) in fp32: weights and
    statistics within 1e-6 of the CPU's."""
    from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer as O
    cfg = deepseek_moe_16b().reduced()
    models = [init_params(cfg, torch.Generator().manual_seed(0))
              for _ in range(2)]
    models[1].to(cuda)
    trees = [O.adafactor_params(m) for m in models]
    states = [O.adafactor_init(t) for t in trees]
    rng = np.random.default_rng(0)
    for step in range(5):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32) * np.float32(1e-2)) for p in models[0].parameters()]
        for i, (m, dev) in enumerate(zip(models, ("cpu", cuda))):
            with torch.no_grad():
                for p, g in zip(m.parameters(), grads):
                    p.grad = g.to(dev)
            _, states[i], _ = O.opt_update(
                m, [p.grad for p in m.parameters()], states[i],
                lr=1e-2 * (step + 1), kind="adafactor")
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert float((b.detach().cpu() - a.detach()).abs().max()) <= 1e-6
    for a, b in zip(O.tree_leaves([states[0].vr, states[0].vc,
                                   states[0].v]),
                    O.tree_leaves([states[1].vr, states[1].vc,
                                   states[1].v])):
        assert float((b.cpu() - a).abs().max()) <= 1e-6 * max(
            1.0, float(a.abs().max()))


# ---------------------------------------------------------------------------
# the RecSys and GNN families, phi3-medium
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("deepfm", "dcn-v2", "dien", "mind")
RECSYS_TOL = 1e-5   # card vs CPU, the largest |out| at least 100x it
GNN_TOL = 2e-2      # card vs CPU of the largest |logit|: bf16 streams
# MIND's N(0, 0.01^2) table puts its reduced scores near 1e-5 and its
# in-batch loss at ln(b) whatever the logits: scaled to unit variance,
# both are O(1) and the comparisons hold them
MIND_TABLE_SCALE = 100.0


def _arch_pair(name, cuda, **replace):
    """(reduced config, weights on the card, the same on the CPU)."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models.api import get_api
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy

    cfg = dataclasses.replace(get_arch(name).reduced(), **replace)
    model, _ = get_api(cfg).init(torch.Generator().manual_seed(0))
    tree = params_to_numpy(model)
    if name == "mind":
        tree["table"] = tree["table"] * np.float32(MIND_TABLE_SCALE)
    return cfg, params_from_numpy(tree, cfg, device=cuda), \
        params_from_numpy(tree, cfg, device="cpu")


def _recsys_close(got, want):
    """``got`` (on the card) within RECSYS_TOL of ``want``, whose
    largest magnitude must be at least 100x that."""
    want = want.detach()
    scale = float(want.abs().max())
    assert scale >= 100 * RECSYS_TOL, scale
    err = float((got.detach().cpu() - want).abs().max())
    assert err <= RECSYS_TOL, (err, scale)


@pytest.mark.parametrize("name", RECSYS_ARCHS)
def test_recsys_on_card_matches_cpu(cuda, name):
    from repro_torch.models.api import get_api

    cfg, card, cpu = _arch_pair(name, cuda)
    api = get_api(cfg)
    for shape in cfg.shapes:
        step = api.step_fn(shape)
        batch = api.demo_batch(shape, 1, device="cpu")
        got = step(card, {k: v.to(cuda) for k, v in batch.items()})
        want = step(cpu, batch)
        if shape.kind == "training":
            _recsys_close(got[0], want[0].detach())
            got[0].backward()
            want[0].backward()
            for (n, a), b in zip(card.named_parameters(),
                                 cpu.parameters()):
                assert _rel_fro(a.grad.cpu(), b.grad) <= 1e-4, n
                a.grad = b.grad = None
        elif isinstance(want, tuple):
            assert torch.equal(got[1].cpu(), want[1])
            _recsys_close(got[0], want[0])
        else:
            _recsys_close(got, want)


def test_recsys_mind_top_k_ties_on_card(cuda):
    """1M candidates from the reduced 128-row vocab: the top 100 are
    exact ties, and the card keeps the CPU's lowest positions."""
    from repro_torch.models import recsys

    cfg, card, cpu = _arch_pair("mind", cuda)
    offsets = np.zeros(1, np.int64)
    g = torch.Generator().manual_seed(3)
    batch = {"hist": torch.randint(0, 128, (1, cfg.seq_len), generator=g),
             "hist_len": torch.tensor([cfg.seq_len]),
             "candidates": torch.randint(0, 128, (1_000_000,),
                                         generator=g)}
    with torch.no_grad():
        vals, ids = recsys.mind_score_candidates(
            card, {k: v.to(cuda) for k, v in batch.items()}, cfg, offsets)
        cv, ci = recsys.mind_score_candidates(cpu, batch, cfg, offsets)
    assert torch.equal(ids.cpu(), ci)
    assert bool((vals[0, 1:] == vals[0, :-1]).all())       # all tied
    assert bool((ids[0, 1:] > ids[0, :-1]).all())
    x = torch.randint(-3, 4, (4, 100_003), generator=g).float()
    kv, ki = recsys.topk_lowest_index(x.to(cuda), 64)
    assert torch.equal(ki.cpu(), recsys.topk_lowest_index(x, 64)[1])


def _gnn_batch(cfg, n, e, d_feat, seed):
    g = torch.Generator().manual_seed(seed)
    return {"node_feat": torch.randn((n, d_feat), generator=g),
            "edge_index": torch.randint(0, n, (2, e), generator=g,
                                        dtype=torch.int32),
            "labels": torch.randint(0, cfg.n_classes, (n,), generator=g,
                                    dtype=torch.int32),
            "label_mask": torch.rand((n,), generator=g) < 0.7}


def test_gnn_forward_on_card_repeats_bitwise_and_matches_cpu(cuda):
    from repro_torch.models import gnn

    cfg, card, cpu = _arch_pair("gatedgcn", cuda, n_layers=8)
    batch = _gnn_batch(cfg, 3000, 20000, 128, 0)
    on = {k: v.to(cuda) for k, v in batch.items()}
    with torch.no_grad():
        a = gnn.forward(card, on["node_feat"], on["edge_index"], cfg)
        b = gnn.forward(card, on["node_feat"], on["edge_index"], cfg)
        want = gnn.forward(cpu, batch["node_feat"], batch["edge_index"],
                           cfg)
    assert torch.equal(a, b)
    scale = float(want.abs().max())
    assert float((a.cpu() - want).abs().max()) <= GNN_TOL * scale


def test_gnn_checkpoint_groups_bitwise_on_card(cuda):
    from repro_torch.models import gnn

    cfg, card, _ = _arch_pair("gatedgcn", cuda, n_layers=8)
    batch = {k: v.to(cuda) for k, v in
             _gnn_batch(cfg, 2000, 9000, 128, 1).items()}
    out = []
    for remat in (4, 0, 4):
        loss, _ = gnn.loss_fn(card, batch, cfg, remat_group=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in card.parameters()]))
        card.zero_grad(set_to_none=True)
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gnn_segment_sum_on_card_repeats_bitwise(cuda, dtype):
    """Heavy collisions (a hot segment) and empty segments: the
    fixed-order sum and the gather's backward repeat bitwise, and the
    sums agree with the CPU's (fp32 sums in one order, rounded once)."""
    from repro_torch.models import gnn

    g = torch.Generator().manual_seed(2)
    n, e, d = 5000, 200_000, 70
    idx = torch.randint(0, n // 2, (e,), generator=g)
    idx[: e // 4] = 7
    x = torch.randn((e, d), generator=g).to(dtype)
    seg_c, seg_g = gnn.segments(idx, n), gnn.segments(idx.to(cuda), n)
    xg = x.to(cuda).requires_grad_(True)
    outs = [gnn.segment_sum(xg, seg_g) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    want = gnn.segment_sum(x, seg_c).float()
    scale = float(want.abs().max())
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert float((outs[0].cpu().float() - want).abs().max()) <= tol * scale
    h = torch.randn((n, d), generator=g).to(dtype).to(cuda)
    grads = []
    for _ in range(2):
        hh = h.clone().requires_grad_(True)
        gnn.gather(hh, seg_g).backward(x.to(cuda))
        grads.append(hh.grad)
    assert torch.equal(grads[0], grads[1])


def test_phi3_attention_shape_on_card(cuda):
    """phi3-medium's heads (hq = 40 over hkv = 10, d = 128) through the
    kernels, bf16, against the plain version."""
    q, k, v, do = _attn_inputs(1, 40, 10, 320, 320, 128, torch.bfloat16,
                               cuda, 40)
    tol = FA_TOL[torch.bfloat16]
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, True)
    want = attention_ref(q, k, v, causal=True).float()
    assert bool(((o.float() - want).abs() <=
                 tol["out_abs"] + tol["out_rel"] * want.abs()).all())
    grads = fa_ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    for got, ref_g in zip(grads, attention_grads_ref(q, k, v, do,
                                                     causal=True)):
        assert _rel_fro(got, ref_g) <= tol["grad"]


def test_phi3_reduced_loss_and_serving_on_card_match_cpu(cuda):
    """Reduced phi3-medium-14b through ``get_api``: the training loss
    and the prefill and decode logits, card against CPU in fp32."""
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api

    cfg, card, cpu = _arch_pair("phi3-medium-14b", cuda)
    api = get_api(cfg)
    shape = cfg.shape("train_4k")
    batch = api.demo_batch(shape, 0, device="cpu")
    out = {}
    for dev, model in ((cuda, card), (torch.device("cpu"), cpu)):
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = T.loss_fn(model, b, cfg, compute_dtype=torch.float32)
        logits, cache = T.prefill(model, b["tokens"], cfg, max_len=40,
                                  compute_dtype=torch.float32)
        dec, _ = T.decode_step(model, b["labels"][:, -1:], cache, 32, cfg,
                               compute_dtype=torch.float32)
        out[dev.type] = [t.detach().float().cpu() for t in
                         (loss, logits, dec)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


# ---------------------------------------------------------------------------
# the sharded store's collective query: two ranks on the card
# ---------------------------------------------------------------------------

def _collective_on_card(group):
    """One rank of a two-rank group: the same ``EraRAG`` on the group and
    without one (each rank's store holding two of the four slots), exact
    and quantized; the hits of the collective, of the loop under the
    group and of the group-less store, and the kernels each collective
    call launched on this rank."""
    from repro_torch.core.erarag import EraRAG
    from repro_torch.kernels.common import resolve_device
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    questions = [qa.question for qa in corpus.qa[:16]]
    out = {"backend": group.backend, "device": str(group.device)}
    for quantized in (False, True):
        cfg = EraRAGConfig(**{**LIFE_CFG, "index_shards": 4},
                           quantized_scan=quantized)
        on_group = EraRAG(cfg, HashingEmbedder(dim=128), group=group)
        plain = EraRAG(cfg, HashingEmbedder(dim=128),
                       device=resolve_device(str(group.device)))
        for rag in (on_group, plain):
            rag.insert_docs(corpus.docs)
        q = np.asarray(plain.embedder.encode(questions), np.float32)
        on_group.store.refresh()
        counts = (mips_ops.launch_count, ham_ops.launch_count,
                  mips_ops.rescore_launch_count,
                  mips_ops.collective_launch_count)
        before = [c() for c in counts]
        coll = _hit_bits(on_group.store, q)
        launched = [c() - b for c, b in zip(counts, before)]
        active = on_group.store.collective_active
        on_group.store.collective = False
        loop = _hit_bits(on_group.store, q)
        out[quantized] = {"active": active,
                          "local_slots": on_group.store._group.buf.shape[0],
                          "coll": coll, "loop": loop,
                          "plain": _hit_bits(plain.store, q),
                          "launched": launched}
    return out


def test_collective_two_ranks_on_one_card(cuda):
    """Two ranks on the card (gloo when they share it): exact and
    quantized, the collective's hits are bitwise the loop's and the
    group-less store's on every rank, and each collective call scans
    this rank's two slots with the hand-written kernels."""
    from repro_torch.launch.mesh import run_ranks
    common.build_kernels(["lsh_hash", "mips_topk", "hamming_topk"])
    out = run_ranks(_collective_on_card, 2, device="cuda", timeout_s=600)
    for rank in out:
        assert rank["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                                   else "gloo")
        for quantized in (False, True):
            rec = rank[quantized]
            assert rec["active"] and rec["local_slots"] == 2
            assert rec["coll"] == rec["loop"] == rec["plain"]
            assert rec["coll"] == out[0][quantized]["coll"]
            calls = 3          # one collective call a layer filter
            assert rec["launched"] == (
                [0, 2 * calls, 2 * calls, calls] if quantized
                else [2 * calls, 0, 0, calls])
