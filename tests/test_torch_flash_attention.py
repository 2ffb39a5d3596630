"""Attention parity: the port's ``flash_attention`` on the CPU (its plain
version, ``attention_ref``, with autograd) against the JAX package's
``attention_ref``, its Pallas kernel ``flash_attention_pallas`` in
interpret mode, and ``chunked_attention`` (the route the JAX training
step takes off the TPU).  Inputs are seeded numpy arrays handed to both.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``), against the same plain version.
"""
import functools

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
    attention_lse_ref, attention_ref, call_count, split_bf16
from torch_threads import one_blas_thread  # noqa: F401

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


# the reference's fp32 routes under ``jax.jit``: one compile a shape
# instead of one a primitive (the bf16 checks below keep the eager
# ``attention_ref``, whose rounding at every op they are held to)
_jax_ref = jax.jit(jax_ref, static_argnames=("causal",))
_chunked = jax.jit(chunked_attention, static_argnames=("causal", "block_k"))


@functools.partial(jax.jit, static_argnums=4)
def _jax_ref_vjp(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal),
                     q, k, v)
    return vjp(do)


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
            ("attention_ref", _jax_ref(jq, jk, jv, causal=causal)),
            ("pallas", flash_attention_pallas(jq, jk, jv, causal=causal,
                                              interpret=True)),
            ("chunked", _chunked(jq, jk, jv, causal=causal,
                                 block_k=16))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_forward_lq_above_lk_not_causal():
    """Not causal, lq > lk is well defined; the Pallas kernel is held
    at lq <= lk only (its query padding), the other routes here."""
    q, k, v = _inputs(2, 4, 2, 45, 19, 32, seed=3)
    got = _port(q, k, v, causal=False)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (_jax_ref(jq, jk, jv), _chunked(jq, jk, jv)):
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
    want = _jax_ref_vjp(*(jnp.asarray(a) for a in (q, k, v, do)), causal)
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


# The card's bf16 output bound (FA_TOL in tests/test_torch_cuda.py and
# chip_smoke.py): |kernel - plain| <= OUT_ABS + OUT_REL * |plain|.
OUT_ABS, OUT_REL = 2e-5, 2.0 ** -7


def _pv_as_the_kernels(q, k, v, causal, split):
    """bf16 attention as the tensor-core forward computes it: exact
    bf16 products of q k^T summed in fp32, P = exp(S - rowmax) in fp32,
    then P V as bf16 products, P split into hi + lo (or rounded once),
    divided by the row sum and rounded to bf16."""
    group = q.shape[1] // k.shape[1]
    d = q.shape[-1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * d ** -0.5
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        visible = torch.arange(lk)[None, :] <= \
            torch.arange(lq)[:, None] + (lk - lq)
        s = torch.where(visible, s, torch.full_like(s, -1.0e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi, lo = split_bf16(p)
    pv = hi.float() @ vf
    if split:
        pv = pv + lo.float() @ vf
    return (pv / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal,seed,cancel", [
    (1, 4, 2, 64, 64, 32, False, 0, True),      # outputs cancel toward 0
    (2, 4, 2, 37, 53, 16, True, 1, True),       # cancel, lq < lk causal
    (1, 2, 1, 1, 40, 32, True, 3, True),        # cancel, a single row
    (1, 8, 2, 48, 48, 64, True, 2, False),      # peaked softmax (q x 2)
])
def test_bf16_split_of_p_meets_the_card_bound(b, hq, hkv, lq, lk, d, causal,
                                              seed, cancel):
    """The precision design of the tensor-core kernels: P enters P V as
    bf16 hi + lo and meets the bf16 output bound against the JAX
    ``attention_ref``; P rounded once to bf16 does not."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)) * (1.0 if cancel else 2.0)
    k = rng.standard_normal((b, hkv, lk, d))
    if cancel:      # v = +-u (times 1 + 1 %): outputs near 0
        sign = np.where(np.arange(lk) % 2 == 0, 1.0, -1.0)
        v = rng.standard_normal((b, hkv, 1, d)) * sign[None, None, :, None] \
            * (1 + 0.01 * rng.standard_normal((b, hkv, lk, 1)))
    else:
        v = rng.standard_normal((b, hkv, lk, d))
    q, k, v = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
               for a in (q, k, v))
    want = np.asarray(jax_ref(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=causal).astype(jnp.float32))
    bound = OUT_ABS + OUT_REL * np.abs(want)
    split = _pv_as_the_kernels(q, k, v, causal, split=True).float().numpy()
    once = _pv_as_the_kernels(q, k, v, causal, split=False).float().numpy()
    assert (np.abs(split - want) <= bound).all()
    assert (np.abs(once - want) > bound).any()


def test_split_bf16_residual():
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, 4096).astype(np.float32))
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert float((hi.double() - x.double()).abs().max()) > 2.0 ** -12


def test_cpu_route_launches_no_kernel_route():
    """The route table names one kernel route per dtype; the CPU route
    runs the plain version and counts on neither."""
    assert ops.ROUTES == {torch.bfloat16: "tensor_core_bf16",
                          torch.float32: "fma_fp32"}
    ops.reset_launch_count()
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(1, 2, 1, 8, 8, 16, 2))
    ops.flash_attention(q, k, v, causal=True).sum().backward()
    assert ops.route_launch_counts() == {
        p: {r: 0 for r in ops.ROUTES.values()} for p in ("fwd", "bwd")}
