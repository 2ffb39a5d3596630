"""lsh_hash parity: the port's plain version (what a CPU tensor runs)
against the JAX package's Pallas kernel in interpret mode and its jnp
reference, bitwise, on numpy-seeded inputs; ``HyperplaneLSH`` against
the reference's.  The CUDA kernel itself is tested in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lsh import HyperplaneLSH as JaxLSH
from repro.kernels.lsh_hash.ops import codes_to_int as jax_codes_to_int
from repro.kernels.lsh_hash.ops import lsh_hash as jax_lsh_hash
from repro.kernels.lsh_hash.ops import unpack_bits as jax_unpack_bits

from repro_torch.core.lsh import HyperplaneLSH
from repro_torch.kernels.lsh_hash import ops
from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref

SHAPES = [(1, 256, 12), (300, 256, 12), (77, 259, 33), (64, 128, 64),
          (50, 256, 128)]


def _inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed + 7 * n + d + k)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[0] = 0.0   # the embedder's empty-text row: every bit set
    h = rng.standard_normal((d, k)).astype(np.float32)
    return v, h


def _port_codes(v, h):
    codes = ops.lsh_hash(torch.from_numpy(v), torch.from_numpy(h))
    assert codes.dtype == torch.int32
    return codes.numpy().view(np.uint32)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_plain_matches_pallas_interpret_bitwise(n, d, k):
    v, h = _inputs(n, d, k)
    want = np.asarray(jax_lsh_hash(jnp.asarray(v), jnp.asarray(h),
                                   use_pallas=True, interpret=True))
    got = _port_codes(v, h)
    assert got.shape == want.shape == (n, -(-k // 32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_lsh_hash(jnp.asarray(v), jnp.asarray(h),
                                     use_pallas=False)))
    # zero projection sets the bit: the zero row is all ones up to k
    assert jax_codes_to_int(got[:1], k)[0] == (1 << k) - 1


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_unpack_and_int_keys_match(n, d, k):
    v, h = _inputs(n, d, k, seed=1)
    codes = _port_codes(v, h)
    np.testing.assert_array_equal(
        ops.unpack_bits(torch.from_numpy(codes.view(np.int32)), k).numpy(),
        np.asarray(jax_unpack_bits(jnp.asarray(codes), k)))
    got = ops.codes_to_int(codes.view(np.int32), k)
    want = jax_codes_to_int(codes, k)
    assert got.dtype == want.dtype
    assert list(got) == list(want)


@pytest.mark.parametrize("k", [1, 12, 32, 33, 64])
def test_tail_bits_masked(k):
    """Bits at positions >= k are 0 on the plain route (canonical), and
    the plain version masks them itself: the op adds nothing."""
    v, h = _inputs(40, 16, k, seed=2)
    codes = _port_codes(v, h)
    if k % 32:
        assert not (codes[:, -1] >> np.uint32(k % 32)).any()
    raw = lsh_hash_ref(torch.from_numpy(v), torch.from_numpy(h))
    np.testing.assert_array_equal(codes, raw.numpy().view(np.uint32))


@pytest.mark.parametrize("dim,k,seed", [(256, 12, 0), (128, 10, 0),
                                        (64, 40, 5)])
def test_hyperplane_lsh_matches_reference(dim, k, seed):
    a = JaxLSH(dim, k, seed)
    b = HyperplaneLSH(dim, k, seed, device="cpu")
    assert b.hyperplanes.dtype == np.float32
    np.testing.assert_array_equal(a.hyperplanes, b.hyperplanes)
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((200, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs[3] = 0.0
    np.testing.assert_array_equal(a.hash_packed(vecs), b.hash_packed(vecs))
    assert list(a.hash_ints(vecs)) == list(b.hash_ints(vecs))
    c = HyperplaneLSH.from_state(a.state_dict(), device="cpu")
    assert list(c.hash_ints(vecs)) == list(a.hash_ints(vecs))
    assert c.state_dict()["seed"] == seed


def test_kernel_refuses_wide_k():
    v = torch.zeros((4, 8))
    h = torch.zeros((8, ops.MAX_K + 1))
    with pytest.raises(ValueError, match=f"k <= {ops.MAX_K}"):
        ops.lsh_hash_cuda(v, h)
    assert ops.MAX_K == 512   # 8 groups of 64 hyperplanes
