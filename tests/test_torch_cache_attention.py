"""The serving path's attention over a KV cache: the port's four plain
compositions against the JAX package's, on the CPU.

``chunked_attention``, ``causal_blocked_attention``, ``extend_attention``
and ``dense_decode_attention`` are XLA in the JAX package (no Pallas
kernel is reached with a cache), and plain torch in the port on both
devices.  Inputs come from ``numpy.random.default_rng(seed)``; fp32
results are held within 1e-6, bf16 operands within 2e-2 (the two
packages round the same fp32 sums in other orders before the bf16
output rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JO
from repro_torch.kernels.flash_attention import ops as O
from torch_threads import one_blas_thread  # noqa: F401

# the reference's compositions under ``jax.jit``, as the JAX engine's
# launches run them: one compile a shape instead of one a primitive
_JIT = {name: jax.jit(getattr(JO, name), static_argnames=static)
        for name, static in (
            ("chunked_attention", ("causal", "block_k")),
            ("causal_blocked_attention", ("q_chunk", "block_k")),
            ("extend_attention", ("block_k",)),
            ("dense_decode_attention", ()))}
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hkv, lq, lk, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in (q, k, v)],
            [torch.from_numpy(a).to(tdt) for a in (q, k, v)])


def _close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,block_k", [
    (5, 24, 32),       # lk below block_k: one block
    (32, 32, 16),      # lk a multiple of block_k
    (7, 37, 16),       # lk not a multiple: the tail padded
])
def test_chunked_attention_matches_reference(dtype, causal, lq, lk,
                                             block_k):
    (jq, jk, jv), (q, k, v) = _inputs(lq * lk, 2, 4, 2, lq, lk, 16, dtype)
    want = _JIT["chunked_attention"](jq, jk, jv, causal=causal,
                                block_k=block_k)
    got = O.chunked_attention(q, k, v, causal=causal, block_k=block_k)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_kv_len_matches_reference(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(3, 3, 4, 1, 1, 40, 8, dtype)
    kv_len = np.array([1, 17, 40], np.int32)
    want = _JIT["chunked_attention"](jq, jk, jv, block_k=16,
                                kv_len=jnp.asarray(kv_len))
    got = O.chunked_attention(q, k, v, block_k=16,
                              kv_len=torch.from_numpy(kv_len))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,q_chunk,block_k", [
    (32, 8, 16),       # four chunks, the first below block_k
    (30, 8, 16),       # lq % q_chunk != 0: the chunked fallback
])
def test_causal_blocked_attention_matches_reference(dtype, l, q_chunk,
                                                    block_k):
    (jq, jk, jv), (q, k, v) = _inputs(l, 2, 8, 2, l, l, 16, dtype)
    want = _JIT["causal_blocked_attention"](jq, jk, jv, q_chunk=q_chunk,
                                       block_k=block_k)
    got = O.causal_blocked_attention(q, k, v, q_chunk=q_chunk,
                                     block_k=block_k)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lk,block_k", [(24, 32), (48, 16), (45, 16)])
def test_extend_attention_matches_reference(dtype, lk, block_k):
    """Per-row offsets including 0; the last row's suffix is all
    padding (a row of length 0 the engine discards), and its queries
    still see their keys."""
    (jq, jk, jv), (q, k, v) = _inputs(lk, 4, 4, 2, 8, lk, 16, dtype)
    offsets = np.array([0, 5, lk - 8, 3], np.int32)
    want = _JIT["extend_attention"](jq, jk, jv, offsets=jnp.asarray(offsets),
                               block_k=block_k)
    got = O.extend_attention(q, k, v, offsets=torch.from_numpy(offsets),
                             block_k=block_k)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [None, [1, 9, 33, 20]])
def test_dense_decode_attention_matches_reference(dtype, kv_len):
    (jq, jk, jv), (q, k, v) = _inputs(7, 4, 8, 2, 1, 33, 16, dtype)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = _JIT["dense_decode_attention"](jq, jk, jv, kv_len=jl)
    got = O.dense_decode_attention(q, k, v, kv_len=tl)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


def test_compositions_reject_bad_shapes():
    _, (q, k, v) = _inputs(0, 1, 3, 2, 1, 8, 8, "float32")
    with pytest.raises(ValueError, match="multiple"):
        O.dense_decode_attention(q, k, v)
    _, (q, k, v) = _inputs(0, 1, 4, 2, 2, 8, 8, "float32")
    with pytest.raises(ValueError, match="one query"):
        O.dense_decode_attention(q, k, v)
    with pytest.raises(ValueError, match="self-attention"):
        O.causal_blocked_attention(q, k, v)


@pytest.mark.parametrize("which", ["decode", "extend", "chunked"])
def test_finite_stale_values_past_the_frontier_change_nothing(which):
    """A cache past each row's frontier holds whatever an earlier
    occupant left; finite values there give bitwise the result of a
    zero-filled cache (their probabilities are exactly 0)."""
    _, (q, k, v) = _inputs(11, 3, 4, 2, 6 if which == "extend" else 1,
                           40, 16, "float32")
    frontier = [7, 21, 34]
    clean_k, clean_v = k.clone(), v.clone()
    for b, n in enumerate(frontier):
        clean_k[b, :, n:] = 0.0
        clean_v[b, :, n:] = 0.0
    stale_k = clean_k.clone()
    stale_v = clean_v.clone()
    rng = np.random.default_rng(5)
    for b, n in enumerate(frontier):
        noise = rng.standard_normal(stale_k[b, :, n:].shape) * 1e3
        stale_k[b, :, n:] = torch.from_numpy(noise.astype(np.float32))
        stale_v[b, :, n:] = torch.from_numpy(-noise.astype(np.float32))

    def run(kk, vv):
        if which == "decode":
            return O.dense_decode_attention(
                q, kk, vv, kv_len=torch.tensor(frontier))
        if which == "chunked":
            return O.chunked_attention(q, kk, vv, block_k=16,
                                       kv_len=torch.tensor(frontier))
        # the suffix of 6 ends at the frontier
        return O.extend_attention(
            q, kk, vv, offsets=torch.tensor(frontier) - 6, block_k=16)

    clean, stale = run(clean_k, clean_v), run(stale_k, stale_v)
    assert torch.equal(clean, stale)
    assert torch.isfinite(stale).all()
