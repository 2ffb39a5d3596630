"""Public attention op: the CUDA kernels for CUDA tensors, the plain
version (with autograd) for CPU tensors.

``flash_attention(q, k, v, *, causal, scale)`` is differentiable.  On
the card its forward and backward are kernels of
``csrc/flash_attention.cu``, wrapped in one ``torch.autograd.Function``;
a CPU tensor goes to ``attention_ref`` and autograd differentiates that.
There is no fallback between the two.

On the card the route follows the dtype:

- **bf16 -> the tensor-core kernels**: bf16 products with fp32
  accumulation, the forward on ``wgmma`` + TMA at d = 64 and 128 (on
  ``mma.sync`` at d = 16 and 32), the backward on ``mma.sync``.  P and
  dS enter their products as bf16 hi + lo halves (``ref.split_bf16``),
  so the result keeps the fp32-inside contract;
- **fp32 -> the FMA kernels** (every product an fp32 ``fmaf`` chain;
  no TF32 anywhere).

Either way the backward is D = rowsum(dO * O), then dK/dV per kv tile,
then dQ per q tile, with no float atomics: two runs are bitwise equal.

Causal attention with lq > lk is refused on both routes: rows before
the key window then have every key masked, and the JAX package's three
routes disagree on them (its Pallas kernel, ``attention_ref`` and
``chunked_attention`` give three different values where the kernel's
docstring promises 0; see PERF.md, "reference gaps").  The model only
asks for lq == lk.

Launch counters on the obs registry: ``kernels.flash_attention_fwd.
launches`` (one per forward launch) and ``kernels.flash_attention_bwd.
launches`` (one per backward call, which launches its kernels in order
on the current stream); beside each, one counter per route,
``kernels.flash_attention_{fwd,bwd}.<route>.launches`` with the routes
of ``ROUTES``.

The attention of the serving path, over a KV cache, is four plain
compositions on either device, as in the JAX package, where they are
XLA and reach no Pallas kernel: ``chunked_attention`` and
``causal_blocked_attention`` (prefill), ``extend_attention`` (a suffix
over per-row cache prefixes) and ``dense_decode_attention`` (one
token).  They follow the reference term for term: blocks of
``block_k`` keys with the tail padded, masked scores set to -1e30, fp32
softmax state, ``l == 0 -> 1``.  Where the reference multiplies
operands in their own dtype with fp32 accumulation
(``preferred_element_type=jnp.float32``), the operands are rounded to
that dtype and widened to fp32 here (``_widened``): a product of two
bf16 values is exact in fp32, and TF32 is off.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import check_launch, load_kernel, \
    stream_ptr
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import NEG
from repro_torch.obs.metrics import global_registry

HEAD_DIMS = (16, 32, 64, 128)     # d the CUDA kernels take
# the dtypes the CUDA kernels take, and the kernels each goes to
ROUTES = {torch.bfloat16: "tensor_core_bf16", torch.float32: "fma_fp32"}
DTYPES = tuple(ROUTES)

_FWD_LAUNCHES = global_registry().counter(
    "kernels.flash_attention_fwd.launches")
_BWD_LAUNCHES = global_registry().counter(
    "kernels.flash_attention_bwd.launches")
_ROUTE_LAUNCHES = {
    (pass_, route): global_registry().counter(
        f"kernels.flash_attention_{pass_}.{route}.launches")
    for pass_ in ("fwd", "bwd") for route in ROUTES.values()}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd_launch": (
        [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P], _I),
    "flash_attention_bwd_launch": (
        [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _I, _P], _I),
}


def reset_launch_count() -> None:
    _FWD_LAUNCHES.reset()
    _BWD_LAUNCHES.reset()
    for c in _ROUTE_LAUNCHES.values():
        c.reset()


def launch_count() -> int:
    """Forward kernel launches since the last reset."""
    return _FWD_LAUNCHES.count


def bwd_launch_count() -> int:
    """Backward calls (each launches the three backward kernels) since
    the last reset."""
    return _BWD_LAUNCHES.count


def route_launch_counts() -> dict:
    """``{"fwd": {route: n}, "bwd": {route: n}}`` since the last reset:
    which kernels (``ROUTES``) the launches went to."""
    return {pass_: {route: _ROUTE_LAUNCHES[pass_, route].count
                    for route in ROUTES.values()}
            for pass_ in ("fwd", "bwd")}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"expected q (b, hq, lq, d) and k, v "
                         f"(b, hkv, lk, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            f"causal attention needs lq <= lk, got lq={q.shape[2]}, "
            f"lk={k.shape[2]}: rows before the key window have every key "
            f"masked, where the JAX package's routes disagree (reference "
            f"gap 2 in PERF.md)")
    if not q.device == k.device == v.device:
        raise ValueError(f"inputs on {q.device}, {k.device} and "
                         f"{v.device}")


def _check_kernel_inputs(*ts: torch.Tensor) -> None:
    d = ts[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take d in {HEAD_DIMS}, "
                         f"got {d}")
    if ts[0].dtype not in DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"flash_attention kernels take one dtype of "
                        f"{DTYPES}, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention kernels take contiguous inputs")
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                             for t in ts):
        raise ValueError("the bf16 flash_attention kernels copy 16-byte "
                         "chunks: inputs must start 16-byte aligned")


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale if scale is not None else d ** -0.5)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool,
                             scale: Optional[float] = None):
    """Launch the forward kernel: (o like q, lse (b, hq, lq) fp32)."""
    _check_kernel_inputs(q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    lib = load_kernel("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, lq, lk, d, _scale(d, scale),
        int(causal), int(q.dtype == torch.bfloat16), stream_ptr(q.device))
    check_launch(lib, "flash_attention", err)
    _FWD_LAUNCHES.inc()
    _ROUTE_LAUNCHES["fwd", ROUTES[q.dtype]].inc()
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool,
                             scale: Optional[float] = None):
    """Launch the backward kernels: (dq, dk, dv) like (q, k, v)."""
    _check_kernel_inputs(q, k, v, o, do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("flash_attention backward takes a contiguous "
                        "fp32 lse")
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    lib = load_kernel("flash_attention", _SIGNATURES)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, lq, lk, d,
        _scale(d, scale), int(causal), int(q.dtype == torch.bfloat16),
        stream_ptr(q.device))
    check_launch(lib, "flash_attention", err)
    _BWD_LAUNCHES.inc()
    _ROUTE_LAUNCHES["bwd", ROUTES[q.dtype]].inc()
    return dq, dk, dv


def _traced(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (or a DTensor over fake shards):
    a dry run's stand-in for a tensor on the card, whatever device it
    names, which takes the card's route to the ops' shape contracts."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy where it is not; a
    traced tensor has no address to align)."""
    t = t.contiguous()
    if _traced(t):
        return t
    return t.clone() if t.data_ptr() % 16 else t


# ---------------------------------------------------------------------------
# the kernels as custom ops: a shape contract (``register_fake``), a flop
# formula, and a DTensor sharding rule, so the dry run (launch/dryrun.py)
# traces the card's route on fake tensors without the extension
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd_cuda(q, k, v, causal, scale)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, scale):
    b, hq, lq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, hq, lq),
                                             dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            causal: bool, scale: Optional[float]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, scale)


@_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, do, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs a head scores: every pair, or with ``causal``
    the keys at or before each query's position ``lk - lq + i``."""
    if not causal:
        return lq * lk
    off = lk - lq
    return sum(min(lk, max(0, off + i + 1)) for i in range(lq))


def _flops_fwd(q_shape, k_shape, v_shape, causal, scale, out_shape=None):
    """QK^T and PV over the pairs the kernel scores: 4 b hq d pairs."""
    b, hq, lq, d = q_shape
    return 4 * b * hq * d * attention_pairs(lq, k_shape[2], causal)


def _flops_bwd(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, scale, out_shape=None):
    """S recomputed, then dV, dP, dQ and dK: five products a pair."""
    b, hq, lq, d = q_shape
    return 10 * b * hq * d * attention_pairs(lq, k_shape[2], causal)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.flash_attention_fwd,
                          get_raw=False)(_flops_fwd)
    register_flop_formula(torch.ops.repro_torch.flash_attention_bwd,
                          get_raw=False)(_flops_bwd)


_register_flop_formulas()


def register_dtensor_sharding() -> None:
    """DTensor sharding rules of the two ops: every operand sharded on
    batch (dim 0), or on heads (dim 1) where each rank's q heads are
    whole groups of its kv heads (both head counts divide, or the k/v
    repeated to the q heads split as unevenly as q's:
    ``sharding_ctx.gqa_heads``), or all replicated.  Called by the dry
    run."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.dtensor_rules import register_op_rule

    def singles(n_tensors: int):
        return lambda: [[p] * n_tensors + [None, None]
                        for p in (Replicate(), Shard(0), Shard(1))]
    register_op_rule(torch.ops.repro_torch.flash_attention_fwd.default,
                     singles(2 + 3), n_out=2, uneven=True)
    register_op_rule(torch.ops.repro_torch.flash_attention_bwd.default,
                     singles(3 + 6), n_out=3, uneven=True)


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op (CUDA or traced tensors).
    Traced tensors go through the custom ops, whose dispatch picks the
    shape contracts; real ones call the ops' CUDA implementation
    directly, the same kernels without the op dispatch's host time
    (0.05-0.09 ms a call on an H100, PERF.md)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = (_kernel_layout(t) for t in (q, k, v))
        fwd = torch.ops.repro_torch.flash_attention_fwd if _traced(q) \
            else flash_attention_fwd_cuda
        o, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = torch.ops.repro_torch.flash_attention_bwd if _traced(q) \
            else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, _kernel_layout(do), ctx.causal,
                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, hq, lq, d); k, v: (b, hkv, lk, d) -> (b, hq, lq, d) in q's
    dtype, differentiable in q, k and v."""
    _check(q, k, v, causal)
    if q.device.type == "cuda" or _traced(q):
        return FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention: no route for device {q.device}")


# ---------------------------------------------------------------------------
# attention over a KV cache: the serving path's plain compositions
# ---------------------------------------------------------------------------
def _widened(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened to fp32: an operand of a
    product the reference runs in ``dtype`` with fp32 accumulation."""
    return t.to(dtype).to(torch.float32)


def _online_softmax(q, k, v, scale, block_k, mask_fn):
    """The scan over key blocks of ``chunked_attention`` and
    ``extend_attention``: ``mask_fn(kpos)`` gives the visible keys of a
    block, a bool (b or 1, lq, bk) for key positions ``kpos`` (bk,)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    bk = min(block_k, lk)
    pad = (-lk) % bk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    cdt = q.dtype
    qg = _widened(q * torch.tensor(scale, dtype=cdt, device=q.device), cdt
                  ).reshape(b, hkv, group * lq, d)
    m = torch.full((b, hkv, group, lq), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, lq, d), dtype=torch.float32,
                      device=q.device)
    for i in range((lk + pad) // bk):
        kt = _widened(k[:, :, i * bk:(i + 1) * bk], cdt)
        vt = _widened(v[:, :, i * bk:(i + 1) * bk], cdt)
        s = (qg @ kt.transpose(-1, -2)).view(b, hkv, group, lq, bk)
        kpos = i * bk + torch.arange(bk, device=q.device)
        s.masked_fill_(~mask_fn(kpos)[:, None, None], NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = _widened(p, cdt).view(b, hkv, group * lq, bk) @ vt
        acc = acc * alpha[..., None] + pv.view(b, hkv, group, lq, d)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(b, hq, lq, d).to(q.dtype)


def _check_gqa(q: torch.Tensor, k: torch.Tensor) -> None:
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = False,
                      scale: Optional[float] = None, block_k: int = 1024,
                      kv_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Online-softmax attention over blocks of ``block_k`` keys.

    q: (b, hq, lq, d); k, v: (b, hkv, lk, d).  GQA by head groups (no
    repeat).  Causal puts the queries at the end of the key window
    (offset lk - lq); ``kv_len`` (b,) masks a partly filled cache."""
    _check_gqa(q, k)
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    qpos = torch.arange(lq, device=q.device) + (lk - lq)

    def mask_fn(kpos):
        mask = (kpos < lk)[None, None, :]
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] <
                           kv_len.to(q.device)[:, None, None])
        return mask

    return _online_softmax(q, k, v, scale if scale is not None else
                           d ** -0.5, block_k, mask_fn)


def causal_blocked_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             scale: Optional[float] = None,
                             q_chunk: int = 4096,
                             block_k: int = 1024) -> torch.Tensor:
    """Causal self-attention with triangular block skipping: q in
    chunks of ``q_chunk`` rows, chunk i attending keys
    ``[: (i + 1) * q_chunk]`` only.  Falls back to ``chunked_attention``
    when lq is not a multiple of the chunk."""
    lq, lk = q.shape[2], k.shape[2]
    if lq != lk:
        raise ValueError(f"the block-causal path expects self-attention, "
                         f"got lq={lq}, lk={lk}")
    qc = min(q_chunk, lq)
    if lq % qc:
        return chunked_attention(q, k, v, causal=True, scale=scale,
                                 block_k=block_k)
    outs = []
    for i in range(lq // qc):
        end = (i + 1) * qc
        outs.append(chunked_attention(
            q[:, :, i * qc:end], k[:, :, :end], v[:, :, :end],
            causal=True, scale=scale, block_k=min(block_k, end)))
    return torch.cat(outs, dim=2)


def extend_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     offsets: torch.Tensor, scale: Optional[float] = None,
                     block_k: int = 1024) -> torch.Tensor:
    """Suffix queries over a per-row-offset cache (the KV prefix-reuse
    path).  q: (b, hq, lq, d), row b's query i at global position
    ``offsets[b] + i``; k, v: (b, hkv, lk, d), the whole cache.  Key j
    is visible to query i iff ``j <= offsets[b] + i``, so cache rows
    past a row's frontier are never observed."""
    _check_gqa(q, k)
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    qpos = offsets.to(device=q.device, dtype=torch.int64)[:, None] + \
        torch.arange(lq, device=q.device)[None, :]               # (b, lq)

    def mask_fn(kpos):
        return (kpos < lk)[None, None, :] & \
            (kpos[None, None, :] <= qpos[:, :, None])

    return _online_softmax(q, k, v, scale if scale is not None else
                           d ** -0.5, block_k, mask_fn)


def dense_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           scale: Optional[float] = None,
                           kv_len: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token decode attention as two grouped products (no scan),
    in fp32.  q: (b, hq, 1, d); k, v: (b, hkv, lk, d); ``kv_len`` (b,)
    masks each row's cache past its length."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if lq != 1:
        raise ValueError(f"decode attention takes one query, got {lq}")
    _check_gqa(q, k)
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(b, hkv, g, d)
    s = qg @ k.to(torch.float32).transpose(-1, -2)             # (b, h, g, lk)
    if kv_len is not None:
        valid = torch.arange(lk, device=q.device)[None, :] < \
            kv_len.to(q.device)[:, None]                          # (b, lk)
        s = s.masked_fill(~valid[:, None, None], NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p / l) @ v.to(torch.float32)
    return out.reshape(b, hq, 1, d).to(q.dtype)
