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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mips_topk.kernel import mips_topk_pallas
from repro.kernels.mips_topk.ops import MASK_BIAS as JAX_MASK_BIAS
from repro.kernels.mips_topk.ops import augment_queries as jax_augment
from repro.kernels.mips_topk.ops import flagged_mips_topk as jax_flagged

from repro_torch.kernels.mips_topk import ops
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

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
        rows, ranges = ops.scan_ranges(b, n, sms)
        assert rows % 128 == 0 and ranges * rows >= n
        assert (ranges - 1) * rows < n
