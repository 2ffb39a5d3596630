"""Attention parity: the port's ``flash_attention`` on the CPU (its plain
version, ``attention_ref``, with autograd) against the JAX package's
``attention_ref``, its Pallas kernel ``flash_attention_pallas`` in
interpret mode, and ``chunked_attention`` (the route the JAX training
step takes off the TPU).  Inputs are seeded numpy arrays handed to both.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``), against the same plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import chunked_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_grads_ref, \
    attention_lse_ref, attention_ref, call_count

F32_TOL = 1e-5      # fp32 on both sides; sums in other orders
# bf16 inputs: the port and the Pallas kernel both widen to fp32 inside
# and round only the output to bf16, so an element whose fp32 values
# straddle a rounding boundary lands one bf16 step apart (2^-7 = 7.8e-3
# for |out| in [1, 2)); 2e-2 allows that step at |out| < 4.
BF16_TOL = 2e-2
GRAD_TOL = 1e-5     # relative Frobenius error per gradient tensor


def _inputs(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    out = ops.flash_attention(*(torch.from_numpy(a).to(dtype)
                                for a in (q, k, v)), causal=causal)
    return out.float().numpy()


CASES = [  # b, hq, hkv, lq, lk, d, causal
    (1, 2, 2, 16, 16, 16, True),        # group 1
    (2, 4, 1, 37, 37, 32, True),        # group 4, odd length
    (1, 8, 2, 24, 61, 16, True),        # lq < lk, causal offset 37
    (2, 4, 2, 29, 45, 64, False),       # odd, not causal
    (1, 8, 1, 1, 33, 16, True),         # a decode-like row, group 8
]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", CASES)
def test_forward_matches_jax_routes_fp32(b, hq, hkv, lq, lk, d, causal):
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=lq * lk + d)
    got = _port(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for name, want in (
            ("attention_ref", jax_ref(jq, jk, jv, causal=causal)),
            ("pallas", flash_attention_pallas(jq, jk, jv, causal=causal,
                                              interpret=True)),
            ("chunked", chunked_attention(jq, jk, jv, causal=causal,
                                          block_k=16))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_forward_lq_above_lk_not_causal():
    """Not causal, lq > lk is well defined; the Pallas kernel is held
    at lq <= lk only (its query padding), the other routes here."""
    q, k, v = _inputs(2, 4, 2, 45, 19, 32, seed=3)
    got = _port(q, k, v, causal=False)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jax_ref(jq, jk, jv), chunked_attention(jq, jk, jv)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", CASES[:4])
def test_forward_bf16_matches_pallas(b, hq, hkv, lq, lk, d, causal):
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=7 + lq)
    # the same bf16 values on both sides
    qb, kb, vb = (np.array(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32)) for a in (q, k, v))
    got = _port(qb, kb, vb, causal, dtype=torch.bfloat16)
    want = flash_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (qb, kb, vb)),
        causal=causal, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_TOL)


def test_causal_lq_above_lk_raises():
    """Reference gap: at causal lq > lk the first rows have every key
    masked and the JAX package's routes disagree there; the port
    refuses the shape on every route."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 24, 20, 16,
                                                    seed=0))
    with pytest.raises(ValueError, match="lq <= lk"):
        ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention(q, k, v, causal=False)      # well defined


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", CASES)
def test_gradients_match_jax_grad(b, hq, hkv, lq, lk, d, causal):
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=11 + lq + lk)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jax_ref(a, b_, c, causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ops.flash_attention(*leaves, causal=causal).backward(
        torch.from_numpy(do))
    plain = attention_grads_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(do), causal=causal)
    for name, leaf, p, w in zip("qkv", leaves, plain, want):
        w = np.asarray(w, np.float64)
        for got in (leaf.grad, p):
            err = np.linalg.norm(got.numpy().astype(np.float64) - w) / \
                np.linalg.norm(w)
            assert err <= GRAD_TOL, (name, err)


def test_lse_is_the_masked_row_logsumexp():
    q, k, _ = _inputs(1, 4, 2, 21, 30, 16, seed=2)
    lse = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=True).numpy()
    kk = np.repeat(k, 2, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) * 16 ** -0.5, kk)
    visible = np.arange(30)[None, :] <= np.arange(21)[:, None] + 9
    s = np.where(visible, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse, want, rtol=0, atol=F32_TOL)


def test_cpu_route_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 16, 1))
    before, launches = call_count(), ops.launch_count()
    out = ops.flash_attention(q, k, v, causal=True)
    assert call_count() == before + 1 and ops.launch_count() == launches
    assert torch.equal(out, attention_ref(q, k, v, causal=True))
