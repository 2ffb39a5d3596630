"""Shared neural layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The layer functions take their weights as a dict of tensors named as in
the JAX package (``p["wq"]``, ``p["w_gate"]``, ...) with the (in, out)
layout, so ``x @ p["wq"]`` reads like the reference.  The ``nn.Module``s
(``Attention``, ``SwiGLU``, ``DecoderLayer``) hold those parameters,
under the same names, and hand them out cast to the compute dtype
(``params(dtype)``); the cast is part of the autograd graph, so the
gradients reach the fp32 master weights.

``attention_fwd`` has the reference's three branches.  Without a KV
cache (training) it runs ``flash_attention``, the CUDA kernels on the
card.  With one (serving) it writes the new K/V into the cache in
place and attends with the plain compositions of
``kernels/flash_attention/ops.py``, as the JAX package's cache branches
run XLA and no Pallas kernel.  The MoE FFN is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import LMConfig, not_ported
from repro_torch.kernels.flash_attention.ops import \
    causal_blocked_attention, chunked_attention, dense_decode_attention, \
    extend_attention, flash_attention

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
    """positions: (l,) or (b, l) int -> (..., l, half) cos/sin."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, h, l, d); cos/sin: (l, half) or (b, l, half).  The halves
    rotate (not interleaved pairs); x times the fp32 cos/sin promotes to
    fp32, and the result returns to x's dtype."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        c, s = cos[None, None], sin[None, None]
    else:
        c, s = cos[:, None], sin[:, None]
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


def _write_kv(cache: torch.Tensor, new: torch.Tensor, starts,
              write) -> None:
    """Write ``new`` (b, hkv, l, hd) into ``cache`` (B, hkv, max_len, hd)
    in place: batch row ``src[j]`` into cache row ``dst[j]`` (every row
    into its own when ``write`` is None) at ``starts``, an int or a (b,)
    tensor of per-row positions on the cache's device.  A start is
    clamped so the l positions fit, as ``lax.dynamic_update_slice``
    clamps it."""
    l, max_len = new.shape[2], cache.shape[2]
    new = new.to(cache.dtype)
    if isinstance(starts, int):
        at = max(0, min(starts, max_len - l))
        if write is None:
            cache[:, :, at:at + l] = new
        else:
            src, dst = write
            cache[dst, :, at:at + l] = new[src]
        return
    src, dst = write if write is not None else \
        (torch.arange(new.shape[0], device=cache.device),) * 2
    pos = starts[src].clamp(0, max_len - l)[:, None] + \
        torch.arange(l, device=cache.device)[None, :]             # (n, l)
    cache[dst[:, None], :, pos] = new[src].transpose(1, 2)


def attention_fwd(p: Params, x: torch.Tensor, cfg: LMConfig,
                  positions: torch.Tensor, *, causal: bool = True,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_len=None, block_k: int = 1024, write=None):
    """x: (b, l, d) -> (out (b, l, d), cache).

    Without ``kv_cache`` (training): attention over the current sequence
    by ``flash_attention``; the cache returned is None.

    With ``kv_cache`` (``{"k", "v"}``, each (b, hkv, max_len, hd)) the
    current K/V are written into it in place and it is returned:
    - ``cache_len`` a (b,) tensor: per-row offsets (the prefix-reuse
      extend path).  Row b's K/V land at ``[cache_len[b], + l)`` and its
      queries attend the cache causally over global positions
      (``extend_attention``; ``dense_decode_attention`` for one token).
    - ``cache_len`` an int (or None for 0): one offset for every row.
      Prefill (l > 1) attends the current sequence only (the cache
      starts empty); decode reads the cache's first ``cache_len + 1``
      positions, a view, since eager torch, unlike the traced
      reference, can size it by a host integer (the masked tail the
      reference also reads scores 0).

    ``write`` = (src, dst) index tensors writes batch row ``src[j]``
    into cache row ``dst[j]`` and no other row; None writes every row
    into its own.  Rows not written still compute (and the caller
    discards) their outputs, so every shape is that of the whole batch.
    """
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

    if kv_cache is None:
        if cache_len is not None:
            raise ValueError("cache_len without a kv_cache")
        out = flash_attention(q, k, v, causal=causal)
    elif torch.is_tensor(cache_len) and cache_len.dim() >= 1:
        ck, cv = kv_cache["k"], kv_cache["v"]
        starts = cache_len.to(device=ck.device, dtype=torch.int64)
        _write_kv(ck, k, starts, write)
        _write_kv(cv, v, starts, write)
        if l > 1:
            out = extend_attention(q, ck, cv, offsets=starts,
                                   block_k=block_k)
        else:
            out = dense_decode_attention(q, ck, cv, kv_len=starts + l)
    else:
        ck, cv = kv_cache["k"], kv_cache["v"]
        start = 0 if cache_len is None else int(cache_len)
        _write_kv(ck, k, start, write)
        _write_kv(cv, v, start, write)
        if l > 1:
            if causal and l >= 2048:
                out = causal_blocked_attention(q, k, v,
                                               q_chunk=max(2048, l // 8))
            else:
                out = chunked_attention(q, k, v, causal=causal,
                                        block_k=block_k)
        elif cache_len is None:
            out = dense_decode_attention(q, ck, cv)
        else:
            n = start + l
            out = dense_decode_attention(
                q, ck[:, :, :n], cv[:, :, :n],
                kv_len=torch.full((b,), n, dtype=torch.int64,
                                  device=x.device))
    out = out.transpose(1, 2).reshape(b, l, h * hd)
    return out @ p["wo"], kv_cache


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
