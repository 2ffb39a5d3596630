"""Shared neural layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The layer functions take their weights as a dict of tensors named as in
the JAX package (``p["wq"]``, ``p["w_gate"]``, ...) with the (in, out)
layout, so ``x @ p["wq"]`` reads like the reference.  The ``nn.Module``s
(``Attention``, ``SwiGLU``, ``DecoderLayer``) hold those parameters,
under the same names, and hand them out cast to the compute dtype
(``params(dtype)``); the cast is part of the autograd graph, so the
gradients reach the fp32 master weights.

Only the training branch of ``attention_fwd`` is ported (no KV cache):
it runs ``flash_attention``, the CUDA kernels on the card.  The MoE FFN
is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import LMConfig, not_ported
from repro_torch.kernels.flash_attention.ops import flash_attention

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(in_dim, out_dim) normal draw times ``scale`` (default the
    reference's sqrt(2 / (in + out))), on the generator's device."""
    scale = scale if scale is not None else (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings (computed on the fly)
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (l,) int -> (l, half) cos/sin."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, h, l, d); cos/sin: (l, half).  The halves rotate (not
    interleaved pairs); x times the fp32 cos/sin promotes to fp32, and
    the result returns to x's dtype."""
    half = x.shape[-1] // 2
    c, s = cos[None, None], sin[None, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------
class _Weights(nn.Module):
    """A flat set of named parameters, handed out cast to a dtype."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def params(self, dtype: torch.dtype) -> Params:
        return {n: p.to(dtype) for n, p in self.named_parameters()}


class Attention(_Weights):
    """wq (d, hq*hd), wk, wv (d, hkv*hd), wo (hq*hd, d); with
    ``qkv_bias`` also bq, bk, bv."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None):
        d, h = cfg.d_model, cfg.d_head
        shapes = {"wq": (d, cfg.n_heads * h), "wk": (d, cfg.n_kv_heads * h),
                  "wv": (d, cfg.n_kv_heads * h), "wo": (cfg.n_heads * h, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(cfg.n_heads * h,), bk=(cfg.n_kv_heads * h,),
                          bv=(cfg.n_kv_heads * h,))
        super().__init__(shapes, dtype, device)


class SwiGLU(_Weights):
    """w_gate, w_up (d, d_ff), w_down (d_ff, d)."""

    def __init__(self, d: int, d_ff: int, dtype=torch.float32, device=None):
        super().__init__({"w_gate": (d, d_ff), "w_up": (d, d_ff),
                          "w_down": (d_ff, d)}, dtype, device)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: attn, ffn, and the norms ln1, ln2
    (ones).  ``attn`` and ``ffn`` default to uninitialised weights."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None, *,
                 attn: Optional[Attention] = None,
                 ffn: Optional[SwiGLU] = None):
        super().__init__()
        if cfg.is_moe:
            raise not_ported("MoE layers (moe_fwd)", "11. MoE")
        self.attn = attn if attn is not None else \
            Attention(cfg, dtype, device)
        self.ffn = ffn if ffn is not None else \
            SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))

    def params(self, dtype: torch.dtype) -> Dict:
        """Every weight cast to ``dtype`` (the reference's mixed
        precision: compute in the residual dtype, fp32 master weights)."""
        return {"attn": self.attn.params(dtype),
                "ffn": self.ffn.params(dtype),
                "ln1": self.ln1.to(dtype), "ln2": self.ln2.to(dtype)}


# ---------------------------------------------------------------------------
# attention block (GQA, RoPE, optional bias)
# ---------------------------------------------------------------------------
@torch.no_grad()
def attention_init(generator: torch.Generator, cfg: LMConfig,
                   dtype=torch.float32) -> Attention:
    d, h = cfg.d_model, cfg.d_head
    attn = Attention(cfg, dtype, generator.device)
    attn.wq.copy_(dense_init(generator, d, cfg.n_heads * h, dtype=dtype))
    attn.wk.copy_(dense_init(generator, d, cfg.n_kv_heads * h, dtype=dtype))
    attn.wv.copy_(dense_init(generator, d, cfg.n_kv_heads * h, dtype=dtype))
    attn.wo.copy_(dense_init(generator, cfg.n_heads * h, d, dtype=dtype))
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            getattr(attn, name).zero_()
    return attn


def attention_fwd(p: Params, x: torch.Tensor, cfg: LMConfig,
                  positions: torch.Tensor, *, causal: bool = True,
                  kv_cache=None, cache_len=None):
    """x: (b, l, d) -> (out (b, l, d), None).  Only the training branch
    (no KV cache) is ported."""
    if kv_cache is not None or cache_len is not None:
        raise not_ported("attention over a KV cache", "3. LM serving")
    b, l, d = x.shape
    h, hd = cfg.n_heads, cfg.d_head
    hkv = cfg.n_kv_heads

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, l, h, hd).transpose(1, 2)
    k = k.reshape(b, l, hkv, hd).transpose(1, 2)
    v = v.reshape(b, l, hkv, hd).transpose(1, 2)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    out = flash_attention(q, k, v, causal=causal)
    out = out.transpose(1, 2).reshape(b, l, h * hd)
    return out @ p["wo"], None


# ---------------------------------------------------------------------------
# dense SwiGLU FFN
# ---------------------------------------------------------------------------
@torch.no_grad()
def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> SwiGLU:
    ffn = SwiGLU(d, d_ff, dtype, generator.device)
    ffn.w_gate.copy_(dense_init(generator, d, d_ff, dtype=dtype))
    ffn.w_up.copy_(dense_init(generator, d, d_ff, dtype=dtype))
    ffn.w_down.copy_(dense_init(generator, d_ff, d, dtype=dtype))
    return ffn


def swiglu_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]
