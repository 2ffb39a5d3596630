"""hamming_topk parity: the port's plain version (what a CPU tensor runs)
against the JAX package's ``hamming_topk_ref`` and its Pallas kernel in
interpret mode, bitwise (distances and indices are integers), on
numpy-seeded words with bit 31 set and duplicated codes.  The CUDA
kernel itself is tested in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hamming_topk.kernel import hamming_topk_pallas
from repro.kernels.hamming_topk.ref import hamming_dist_ref as jax_dist
from repro.kernels.hamming_topk.ref import hamming_topk_ref as jax_topk

from repro_torch.kernels.hamming_topk import ops
from repro_torch.kernels.hamming_topk.ref import hamming_dist_ref, \
    popcount32


def _codes(b, n, w, seed):
    """Random uint32 words (about half with bit 31 set), with duplicated
    rows and a query equal to a row, so distances tie."""
    rng = np.random.default_rng(seed + 31 * n + w)
    qc = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    base = rng.integers(0, 2**32, size=(max(2, n // 4), w),
                        dtype=np.uint32)
    dbc = base[rng.integers(0, base.shape[0], size=n)]
    dbc[n // 2] = 0xFFFFFFFF
    qc[0] = dbc[n - 1]
    assert (dbc >> np.uint32(31)).any() and (qc >> np.uint32(31)).any()
    return qc, dbc


def _port(qc, dbc, k):
    d, i = ops.hamming_topk(torch.from_numpy(qc.view(np.int32)),
                            torch.from_numpy(dbc.view(np.int32)), k)
    assert d.dtype == torch.int32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def test_popcount_of_signed_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555,
                      0x0F0F0F0F, 0xDEADBEEF], dtype=np.uint32)
    want = [bin(int(x)).count("1") for x in words]
    got = popcount32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("w", [1, 2, 11])
def test_distances_match_reference(w):
    qc, dbc = _codes(5, 90, w, seed=0)
    got = hamming_dist_ref(torch.from_numpy(qc.view(np.int32)),
                           torch.from_numpy(dbc.view(np.int32)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_dist(jnp.asarray(qc),
                                         jnp.asarray(dbc))))


@pytest.mark.parametrize("w", [1, 2, 11])
@pytest.mark.parametrize("which_k", ["1", "32", "n"])
def test_plain_matches_reference_bitwise(w, which_k):
    n = 300
    k = {"1": 1, "32": 32, "n": n}[which_k]
    qc, dbc = _codes(6, n, w, seed=1)
    got = _port(qc, dbc, k)
    want = jax_topk(jnp.asarray(qc), jnp.asarray(dbc), k)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    # ordered by (distance asc, row asc)
    d, i = got
    assert (np.diff(d, axis=1) >= 0).all()
    assert ((np.diff(d, axis=1) > 0) | (np.diff(i, axis=1) > 0)).all()


@pytest.mark.parametrize("b,n,w,k", [(5, 300, 11, 8), (5, 300, 11, 32),
                                     (3, 64, 2, 64), (2, 130, 1, 1)])
def test_plain_matches_pallas_interpret_bitwise(b, n, w, k):
    qc, dbc = _codes(b, n, w, seed=2)
    got = _port(qc, dbc, k)
    # small blocks: several n-tiles, so ties cross tile boundaries
    want = hamming_topk_pallas(jnp.asarray(qc), jnp.asarray(dbc), k,
                               block_q=8, block_n=64, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_duplicates_resolve_to_the_lowest_index():
    code = np.array([[0x80000001, 7]], dtype=np.uint32)
    dbc = np.array([[1, 7], [0x80000001, 7], [3, 3], [0x80000001, 7],
                    [0x80000001, 7]], dtype=np.uint32)
    d, i = _port(code, dbc, 5)
    assert d.tolist() == [[0, 0, 0, 1, 3]]
    assert i.tolist() == [[1, 3, 4, 0, 2]]


def test_shape_and_k_checks():
    qc = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 4), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 3), dtype=torch.int32), 11)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 3), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc[0], torch.zeros((10, 3), dtype=torch.int32), 1)
    wide = torch.zeros((2, ops.MAX_W + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"w <= {ops.MAX_W}"):
        ops.hamming_topk_cuda(wide, wide, 1)
    with pytest.raises(TypeError):
        ops.hamming_topk_cuda(qc.to(torch.int64),
                              torch.zeros((10, 3), dtype=torch.int64), 1)
