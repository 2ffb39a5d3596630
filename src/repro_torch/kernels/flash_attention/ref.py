"""Plain PyTorch version of (GQA, optionally causal) attention.

The contract of the JAX package's ``attention_ref``: math in fp32, kv
heads repeated for GQA, masked scores set to -1e30 (not -inf), the
causal mask with the queries at the end of the key window (offset
lk - lq), and the output in q's dtype.  It serves CPU tensors (the
gradient is autograd through it) and the on-card comparisons of the
CUDA kernels in ``csrc/flash_attention.cu``.

Each call adds one to ``kernels.flash_attention_ref.calls``, so a run
can show that the card's training path never came here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.obs.metrics import global_registry

NEG = -1.0e30

_CALLS = global_registry().counter("kernels.flash_attention_ref.calls")


def call_count() -> int:
    """``attention_ref`` calls since the last reset."""
    return _CALLS.count


def reset_call_count() -> None:
    _CALLS.reset()


def _scores(q, k, causal, scale):
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)
    if causal:
        # the queries sit at the end of the kv window
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG))
    return s, group


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, hq, lq, d); k, v: (b, hkv, lk, d) with hq % hkv == 0 ->
    (b, hq, lq, d) in q's dtype; math in fp32."""
    _CALLS.inc()
    s, group = _scores(q, k, causal, scale)
    vf = v.to(torch.float32)
    if group > 1:
        vf = vf.repeat_interleave(group, dim=1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ vf).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The row logsumexp (b, hq, lq) fp32 of the scaled, masked scores:
    what the forward kernel saves for its backward."""
    s, _ = _scores(q, k, causal, scale)
    return torch.logsumexp(s, dim=-1)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x ~ hi + lo`` with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``,
    both bf16 (round to nearest even).  The tensor-core kernels split
    their fp32 operands P and dS so before a bf16 product: ``hi + lo``
    is within about 2^-17 |x| of x, where ``hi`` alone is within 2^-9."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def attention_grads_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dq, dk, dv) of ``attention_ref`` for the
    output gradient ``do``, by autograd through it."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), do)
