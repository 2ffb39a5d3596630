"""Shared neural layers: RMSNorm, RoPE, GQA attention, SwiGLU, MoE.

The layer functions take their weights as a dict of tensors named as in
the JAX package (``p["wq"]``, ``p["w_gate"]``, ...) with the (in, out)
layout, so ``x @ p["wq"]`` reads like the reference.  The ``nn.Module``s
(``Attention``, ``SwiGLU``, ``MoE``, ``DecoderLayer``) hold those
parameters, under the same names, and hand them out cast to the compute
dtype (``params(dtype)``); the cast is part of the autograd graph, so
the gradients reach the fp32 master weights.

``attention_fwd`` has the reference's three branches.  Without a KV
cache (training) it runs ``flash_attention``, the CUDA kernels on the
card.  With one (serving) it writes the new K/V into the cache in
place and attends with the plain compositions of
``kernels/flash_attention/ops.py``, as the JAX package's cache branches
run XLA and no Pallas kernel.  Rows that a launch does not write
still attend over their own new K/V, as the reference's rows do in the
new cache it builds (and then drops): their cache positions are saved,
written, read and restored.

The MoE FFN (``moe_route``, ``moe_fwd``) is the reference's XLA code
as torch ops: token-choice top-k routing in fp32, each expert's top
``capacity`` tokens, the experts' products as batched matmuls, and a
combine that sums each token's expert outputs in expert order in the
compute dtype, with no atomics, so a run repeats bitwise.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import LMConfig, MoEConfig
from repro_torch.kernels.flash_attention.ops import \
    causal_blocked_attention, chunked_attention, dense_decode_attention, \
    extend_attention, flash_attention
from repro_torch.models.sharding_ctx import attend_heads, fsdp_gathered, \
    gqa_heads, merge_heads, partitioned, shard, split_heads, write_slice

Params = Dict[str, torch.Tensor]
KV_AXES = ("batch", "kv_heads", "kv_seq", None)     # K/V and their caches


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
        return {n: fsdp_gathered(p.to(dtype))
                for n, p in self.named_parameters()}


class ParamTree(nn.Module):
    """A parameter tree of the JAX package (a dict of arrays, dicts and
    lists) as a module, read as the reference reads its tree:
    ``tree["mlp"][0]["w"]``.  A dict is a ``ParamTree`` (children in
    sorted key order, ``jax.tree_util``'s), a list an ``nn.ModuleList``,
    a leaf an ``nn.Parameter`` (a 0-d one for a scalar)."""

    def __init__(self, tree: Dict):
        super().__init__()
        for key in sorted(tree):
            child = self._child(tree[key])
            if isinstance(child, nn.Parameter):
                self.register_parameter(key, child)
            else:
                self.add_module(key, child)

    @staticmethod
    def _child(v):
        if isinstance(v, dict):
            return ParamTree(v)
        if isinstance(v, (list, tuple)):
            return nn.ModuleList(ParamTree._child(x) for x in v)
        return nn.Parameter(v)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self, leaf) -> Dict:
        """The reference's tree with each parameter ``leaf(p)``."""
        def walk(m):
            if isinstance(m, ParamTree):
                return {k: walk(v) for k, v in
                        sorted({**m._parameters, **m._modules}.items())}
            if isinstance(m, nn.ModuleList):
                return [walk(x) for x in m]
            return leaf(m)
        return walk(self)


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


class MoE(nn.Module):
    """router (d, e), fp32 whatever ``dtype`` (as the reference draws
    it), w_gate, w_up (e, d, f), w_down (e, f, d), and with
    ``n_shared`` a ``SwiGLU`` named ``shared`` of width n_shared * f."""

    def __init__(self, d: int, moe: MoEConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        e, f = moe.n_experts, moe.d_ff_expert
        self.router = nn.Parameter(torch.empty((d, e), dtype=torch.float32,
                                               device=device))
        for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                            ("w_down", (e, f, d))):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))
        self.shared = SwiGLU(d, moe.n_shared * f, dtype, device) \
            if moe.n_shared else None

    def params(self, dtype: torch.dtype) -> Dict:
        p = {n: getattr(self, n).to(dtype)
             for n in ("router", "w_gate", "w_up", "w_down")}
        if self.shared is not None:
            p["shared"] = self.shared.params(dtype)
        return p


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: attn, ffn (a ``SwiGLU``, or an
    ``MoE`` when ``moe``), and the norms ln1, ln2 (ones).  ``attn`` and
    ``ffn`` default to uninitialised weights."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None, *,
                 attn: Optional[Attention] = None,
                 ffn: Optional[Union[SwiGLU, MoE]] = None,
                 moe: bool = False):
        super().__init__()
        self.attn = attn if attn is not None else \
            Attention(cfg, dtype, device)
        if ffn is None:
            ffn = MoE(cfg.d_model, cfg.moe, dtype, device) if moe else \
                SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)
        self.ffn = ffn
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))

    @property
    def is_moe(self) -> bool:
        return isinstance(self.ffn, MoE)

    def params(self, dtype: torch.dtype) -> Dict:
        """Every weight cast to ``dtype`` (the reference's mixed
        precision: compute in the residual dtype, fp32 master weights;
        the router too, which the MoE widens back to fp32)."""
        return {"attn": self.attn.params(dtype),
                "ffn": self.ffn.params(dtype),
                "ln1": fsdp_gathered(self.ln1.to(dtype)),
                "ln2": fsdp_gathered(self.ln2.to(dtype))}


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
            write_slice(cache, new, 2, at)
        else:
            src, dst = write
            cache[dst, :, at:at + l] = new[src]
        return
    src, dst = write if write is not None else \
        (torch.arange(new.shape[0], device=cache.device),) * 2
    pos = starts[src].clamp(0, max_len - l)[:, None] + \
        torch.arange(l, device=cache.device)[None, :]             # (n, l)
    cache[dst[:, None], :, pos] = new[src].transpose(1, 2)


def _attend_written(kv_cache: Dict[str, torch.Tensor], k: torch.Tensor,
                    v: torch.Tensor, starts, write, attend):
    """Write every row's K/V into the cache at ``starts`` (an int or a
    (b,) tensor), return ``attend(ck, cv)``, and then give the rows
    outside ``write`` back what those positions held.  Such a row thus
    reads its own new K/V, as it does in the new cache the reference
    builds, and keeps its cache row, as the reference keeps the old one.
    ``write`` is None (every row written) or slot-indexed (src is dst)."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    if write is None:
        _write_kv(ck, k, starts, None)
        _write_kv(cv, v, starts, None)
        return attend(ck, cv)
    src, dst = write
    if src is not dst:
        raise ValueError("a launch that reads the cache writes its own rows")
    b, l, max_len = k.shape[0], k.shape[2], ck.shape[2]
    written = torch.zeros((b, 1, 1, 1), dtype=torch.bool, device=ck.device)
    written[dst] = True
    if isinstance(starts, int):
        at = max(0, min(starts, max_len - l))
        where = (slice(None), slice(None), slice(at, at + l))
        new = (k, v)
    else:
        pos = starts.clamp(0, max_len - l)[:, None] + \
            torch.arange(l, device=ck.device)[None, :]            # (b, l)
        where = (torch.arange(b, device=ck.device)[:, None], slice(None),
                 pos)
        new = (k.transpose(1, 2), v.transpose(1, 2))
    saved = []
    for c, n in zip((ck, cv), new):
        saved.append(c[where].clone())
        c[where] = n.to(c.dtype)
    out = attend(ck, cv)
    for c, old in zip((ck, cv), saved):
        c[where] = torch.where(written, c[where], old)
    return out


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
    discards) their outputs, so every shape is that of the whole batch;
    where they read the cache, they read their own new K/V
    (``_attend_written``), so their outputs are the reference's too.
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
    q, k, v = split_heads(q, h), split_heads(k, hkv), split_heads(v, hkv)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is None:
        if cache_len is not None:
            raise ValueError("cache_len without a kv_cache")
        k, v = shard(k, KV_AXES), shard(v, KV_AXES)
        out = flash_attention(*gqa_heads(q, k, v), causal=causal)
    elif torch.is_tensor(cache_len) and cache_len.dim() >= 1:
        starts = cache_len.to(device=kv_cache["k"].device,
                              dtype=torch.int64)
        if l > 1:
            def attend(ck, cv):
                return attend_heads(extend_attention, q,
                                    shard(ck, KV_AXES), shard(cv, KV_AXES),
                                    offsets=starts, block_k=block_k)
        else:
            def attend(ck, cv):
                return attend_heads(dense_decode_attention, q,
                                    shard(ck, KV_AXES), shard(cv, KV_AXES),
                                    kv_len=starts + l)
        out = _attend_written(kv_cache, k, v, starts, write, attend)
    elif l > 1:
        ck, cv = kv_cache["k"], kv_cache["v"]
        start = 0 if cache_len is None else int(cache_len)
        _write_kv(ck, k, start, write)
        _write_kv(cv, v, start, write)
        if causal and l >= 2048:
            out = attend_heads(causal_blocked_attention, q, k, v,
                               q_chunk=max(2048, l // 8))
        else:
            out = attend_heads(chunked_attention, q, k, v, causal=causal,
                               block_k=block_k)
    elif cache_len is None:
        out = _attend_written(
            kv_cache, k, v, 0, write,
            lambda ck, cv: attend_heads(dense_decode_attention, q,
                                        shard(ck, KV_AXES),
                                        shard(cv, KV_AXES)))
    else:
        n = int(cache_len) + l

        def attend(ck, cv):
            ck, cv = shard(ck, KV_AXES), shard(cv, KV_AXES)
            return attend_heads(
                dense_decode_attention, q, ck[:, :, :n], cv[:, :, :n],
                kv_len=torch.full((b,), n, dtype=torch.int64,
                                  device=x.device))
        out = _attend_written(kv_cache, k, v, int(cache_len), write, attend)
    return merge_heads(out) @ p["wo"], kv_cache


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


# ---------------------------------------------------------------------------
# MoE FFN: token-choice top-k routing, capacity-bounded gather dispatch
# ---------------------------------------------------------------------------
@torch.no_grad()
def moe_init(generator: torch.Generator, d: int, moe: MoEConfig,
             dtype=torch.float32) -> MoE:
    """The reference's draws: the router by ``dense_init`` in fp32, each
    expert stack normal times sqrt(2 / (fan_in + fan_out)) of its last
    two axes, the shared experts by ``swiglu_init``."""
    e, f = moe.n_experts, moe.d_ff_expert
    mod = MoE(d, moe, dtype, generator.device)
    mod.router.copy_(dense_init(generator, d, e, dtype=torch.float32))
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        w = getattr(mod, name)
        for i in range(e):          # one expert at a time: no fp32 stack
            w[i].copy_(torch.randn(shape[1:], generator=generator,
                                   dtype=torch.float32,
                                   device=generator.device)
                       .mul_((2.0 / (shape[-2] + shape[-1])) ** 0.5))
    if moe.n_shared:
        mod.shared = swiglu_init(generator, d, moe.n_shared * f, dtype)
    return mod


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, equal values in ascending index order (a stable
    sort; ``torch.topk`` does not promise the order of ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One MoE launch's dispatch: each token's experts (``gate_idx``
    (t, k), top-k order) and gates (``gates`` (t, e), fp32, 0 where not
    chosen); each expert's ``capacity`` tokens (``sel_idx`` (e, c), by
    gate, ties to the lower token) with their gates (``sel_val``) and
    whether the slot holds a routed token (``live``); the aux loss."""

    gate_idx: torch.Tensor
    gates: torch.Tensor
    sel_val: torch.Tensor
    sel_idx: torch.Tensor
    live: torch.Tensor
    aux: torch.Tensor


def moe_capacity(t: int, moe: MoEConfig) -> int:
    """Slots an expert takes from a launch of ``t`` tokens (every token,
    padding and idle rows included), by the reference's expression."""
    capacity = int(np.ceil(t * moe.top_k / moe.n_experts *
                           moe.capacity_factor))
    return max(1, min(capacity, t))


def moe_route(router: torch.Tensor, xf: torch.Tensor,
              moe: MoEConfig) -> Routing:
    """Token-choice top-k routing of ``xf`` (t, d).  The router arrives
    in the compute dtype (the layer casts every weight) and multiplies
    ``xf`` widened to fp32, as ``xf.astype(f32) @ router`` promotes in
    the reference; softmax, top-k and the gates are fp32."""
    t = xf.shape[0]
    e, k_top = moe.n_experts, moe.top_k
    logits = xf.to(torch.float32) @ router.to(torch.float32)     # (t, e)
    logits = shard(logits, ("tokens", None))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k_top)                    # (t, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = torch.zeros_like(probs).scatter(1, gate_idx, gate_vals)
    # the experts whole on each rank, and the gates' gradient too: split
    # over them, DTensor's backward of the scatter gives a masked
    # partial sum it then fails to reduce (at top-1)
    gates = shard(gates, ("tokens", None))
    # load-balance aux loss (Switch): e * sum_e (frac_tokens * frac_prob)
    frac_tokens = torch.zeros(e, dtype=torch.float32, device=xf.device) \
        .scatter_add(0, gate_idx.reshape(-1),
                      torch.ones(gate_idx.numel(), dtype=torch.float32,
                                 device=xf.device)) / t
    frac_probs = probs.mean(dim=0)
    aux = moe.router_aux_coef * e * torch.sum(frac_tokens * frac_probs)
    sel_val, sel_idx = top_k(gates.T, moe_capacity(t, moe))     # (e, c)
    return Routing(gate_idx, gates, sel_val, sel_idx, sel_val > 0.0, aux)


# ---------------------------------------------------------------------------
# the dispatch and combine of the partitioned program, as custom ops: a shape
# contract (``register_fake``), a flop formula and a DTensor sharding
# rule, so the dry run (launch/dryrun.py) keeps the experts split and no
# rank holds every token's contributions
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::moe_gather", mutates_args=())
def _moe_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (t, d), idx (e, c) -> x[idx] (e, c, d): each expert's tokens."""
    return x[idx.reshape(-1)].reshape(tuple(idx.shape) + (x.shape[1],))


@_moe_gather.register_fake
def _moe_gather_fake(x, idx):
    return x.new_empty(tuple(idx.shape) + (x.shape[1],))


@torch.library.custom_op("repro_torch::moe_scatter", mutates_args=())
def _moe_scatter(y: torch.Tensor, idx: torch.Tensor, t: int
                 ) -> torch.Tensor:
    """y (e, c, d) -> (t, d): row ``idx[e, j]`` the sum of its
    ``y[e, j]``, added in (expert, slot) order."""
    d = y.shape[-1]
    return torch.zeros((t, d), dtype=y.dtype, device=y.device).index_add_(
        0, idx.reshape(-1), y.reshape(-1, d))


@_moe_scatter.register_fake
def _moe_scatter_fake(y, idx, t):
    return y.new_empty((t, y.shape[-1]))


class _Dispatch(torch.autograd.Function):
    """``x[idx]``, its backward the scatter-add."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.t = x.shape[0]
        return torch.ops.repro_torch.moe_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return torch.ops.repro_torch.moe_scatter(g, idx, ctx.t), None


class _Combine(torch.autograd.Function):
    """The scatter-add of each expert's outputs to their tokens, its
    backward the gather."""

    @staticmethod
    def forward(ctx, y, idx, t):
        ctx.save_for_backward(idx)
        return torch.ops.repro_torch.moe_scatter(y, idx, t)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return torch.ops.repro_torch.moe_gather(g, idx), None, None


def register_dtensor_sharding() -> None:
    """DTensor sharding rules of the dispatch and combine ops (called by
    the dry run): the experts split, each rank gathering its experts'
    tokens from every token and scattering their outputs into a partial
    sum over tokens; or the features split; or all replicated.  The
    scatter counts one element-wise add an element it adds."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.comm_analysis import \
        register_elementwise_formula
    from repro_torch.distributed.dtensor_rules import register_op_rule
    R = Replicate()
    register_op_rule(torch.ops.repro_torch.moe_gather.default,
                     lambda: [[R, R, R], [Shard(0), R, Shard(0)],
                              [Shard(2), Shard(1), R]], n_out=1)
    register_op_rule(torch.ops.repro_torch.moe_scatter.default,
                     lambda: [[R, R, R, None],
                              [Partial(), Shard(0), Shard(0), None],
                              [Shard(1), Shard(2), R, None]], n_out=1)
    register_elementwise_formula(torch.ops.repro_torch.moe_scatter,
                                 lambda y, idx, t: y.numel())


def _traced_combine(ye: torch.Tensor, r: Routing, t: int,
                    idx: torch.Tensor) -> torch.Tensor:
    """The reference's combine as it partitions: each expert's outputs
    times their gates (``sel_val``, 0 where the slot is not live),
    scatter-added to their tokens ``idx`` (``r.sel_idx`` as the experts
    are laid out) by ``_Combine``."""
    w = (r.sel_val * r.live).to(ye.dtype)
    return _Combine.apply(ye * w[..., None], idx, t)


def moe_fwd(p: Params, x: torch.Tensor, moe: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, d) -> (out, aux loss), the reference's dispatch: each
    expert runs its top-``capacity`` tokens among all b * l (overflow
    drops), and a token's output is the sum of its live experts'
    outputs times their gates, plus the shared experts.

    The reference scatter-adds the (e, c) outputs into a (t, d) zero
    tensor in the compute dtype, in expert-major order.  Here each
    token gathers its k contributions, ordered by expert, and they are
    added one after another in the compute dtype: the same sums, in the
    same order, with no atomic add (two runs are bitwise equal).

    Under a sharding context (the dry run) the dispatch and combine
    are ops (``_Dispatch``, ``_traced_combine``) that DTensor partitions
    by experts: the per-token gather would need every expert's outputs on
    each rank, and the whole (t, k, d) contribution tensor."""
    b, l, d = x.shape
    t = b * l
    xf = shard(x.reshape(t, d), ("tokens", None))
    r = moe_route(p["router"], xf, moe)
    e, c = r.sel_idx.shape

    if partitioned():
        # each rank's experts' selections, then their tokens gathered
        idx = shard(r.sel_idx, ("experts", None))
        xe = _Dispatch.apply(xf, idx)
    else:
        xe = xf[r.sel_idx.reshape(-1)].reshape(e, c, d)
    xe = shard(xe, ("experts", None, None))
    g = F.silu(torch.bmm(xe, p["w_gate"]))
    u = torch.bmm(xe, p["w_up"])
    ye = shard(torch.bmm(g * u, p["w_down"]),
               ("experts", None, None))                          # (e, c, d)
    if partitioned():
        return _moe_out(p, _traced_combine(ye, r, t, idx), x, xf), r.aux

    # slot[e, token]: the token's slot in expert e's selection, or -1
    ar = torch.arange(c, device=x.device).expand(e, c)
    slot = torch.full((e, t), -1, dtype=torch.int64, device=x.device) \
        .scatter(1, r.sel_idx, torch.where(r.live, ar, -1))
    experts, _ = torch.sort(r.gate_idx, dim=1)                   # (t, k)
    tokens = torch.arange(t, device=x.device)[:, None]
    s = slot[experts, tokens]                                    # (t, k)
    w = torch.gather(r.gates, 1, experts).to(ye.dtype)
    contrib = ye[experts, s.clamp_min(0)] * w[..., None]        # (t, k, d)
    contrib = torch.where((s >= 0)[..., None], contrib,
                          torch.zeros((), dtype=ye.dtype, device=x.device))
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return _moe_out(p, out, x, xf), r.aux


def _moe_out(p: Params, out: torch.Tensor, x: torch.Tensor,
             xf: torch.Tensor) -> torch.Tensor:
    """The routed experts' (t, d) sum in ``x``'s dtype, plus the shared
    experts, as (b, l, d) under the reference's constraint."""
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + swiglu_fwd(p["shared"], xf)
    return shard(out.reshape(x.shape), ("batch", "seq", "embed"))
