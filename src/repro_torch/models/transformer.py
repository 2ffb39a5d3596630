"""Decoder-only LM (dense or MoE): init and the training loss.

``LM`` holds the weights: ``embed`` (vocab, d), ``layers`` (one
``DecoderLayer`` each), ``final_norm`` and, unless the embeddings are
tied, ``lm_head`` (d, vocab).  An MoE config's layers come in blocks
of ``block_size`` (``moe_every``): the last layer of a block has an
``MoE`` FFN, the others a ``SwiGLU`` (llama4's [dense, moe]), as the
reference's scan steps over blocks; layer ``i * bs + j`` is sub-layer
``j`` of the reference's block ``i``.  The MoE layers' aux losses sum
into ``loss_fn``'s loss.  Master weights are fp32; each layer casts
them to the residual-stream dtype (bf16 by default) inside its forward,
as the JAX package does at ``transformer.py:112-114``.  Each layer runs
under ``torch.utils.checkpoint`` (non-reentrant), standing in for the
``jax.checkpoint`` on the reference's scanned layer body: its
activations are recomputed in the backward, attention's forward kernel
included.

Serving runs the same layers over a KV cache (``make_kv_cache``: one
zeroed tensor each for K and V, (n_layers, b, hkv, max_len, hd), the
reference's layout) with no checkpoint: ``prefill``, ``prefill_padded``
(the engine's bucketed admission), ``prefill_extend`` (a suffix over
reused prefixes) and ``decode_step``.  Where the JAX functions return a
new cache, these write the one they are given in place and return it;
``slots`` and ``rows`` restrict the writes to the rows a serving engine
keeps, so no call copies a cache.  The reference's cache is a tuple of
``block_size`` such pairs, each (n_blocks, ...); its pair ``j`` at block
``i`` is layer ``i * bs + j`` here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import LMConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import DecoderLayer, attention_fwd, \
    attention_init, dense_init, moe_fwd, moe_init, rmsnorm, swiglu_fwd, \
    swiglu_init
from repro_torch.models import sharding_ctx
from repro_torch.models.sharding_ctx import shard

ACT_AXES = ("batch", "seq", "embed")          # the residual stream


def block_size(cfg: LMConfig) -> int:
    """Layers per block: ``moe_every`` for interleaved-MoE configs."""
    return cfg.moe_every if cfg.is_moe else 1


def n_blocks(cfg: LMConfig) -> int:
    if cfg.n_layers % block_size(cfg):
        raise ValueError(f"{cfg.n_layers} layers in blocks of "
                         f"{block_size(cfg)}")
    return cfg.n_layers // block_size(cfg)


def is_moe_layer(cfg: LMConfig, i: int) -> bool:
    """Whether layer ``i`` has an MoE FFN: the last of each block."""
    return cfg.is_moe and i % block_size(cfg) == block_size(cfg) - 1


class LM(nn.Module):
    """The weights of a decoder-only LM (uninitialised; see
    ``init_params`` and ``convert.params_from_numpy``)."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None,
                 layers=None):
        super().__init__()
        n_blocks(cfg)
        self.cfg = cfg
        d, vocab = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((vocab, d), dtype=dtype,
                                              device=device))
        self.layers = nn.ModuleList(
            layers if layers is not None else
            [DecoderLayer(cfg, dtype, device, moe=is_moe_layer(cfg, i))
             for i in range(cfg.n_layers)])
        self.final_norm = nn.Parameter(torch.ones(d, dtype=dtype,
                                                  device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, vocab), dtype=dtype,
                                                    device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> LM:
    """A seeded LM with the reference's init scales, on the generator's
    device (default: a new generator on ``cuda``, seed 0).  torch's draws
    are not ``jax.random``'s; to hold the port against the JAX package,
    carry its weights over with ``convert.params_from_numpy``."""
    if generator is None:
        generator = torch.Generator(device=resolve_device()).manual_seed(0)
    device = generator.device
    embed = dense_init(generator, cfg.vocab_size, cfg.d_model, scale=0.02,
                       dtype=dtype)
    layers = []
    for i in range(cfg.n_layers):
        attn = attention_init(generator, cfg, dtype)
        ffn = moe_init(generator, cfg.d_model, cfg.moe, dtype) \
            if is_moe_layer(cfg, i) else \
            swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
        layers.append(DecoderLayer(cfg, dtype, device, attn=attn, ffn=ffn))
    model = LM(cfg, dtype, device, layers=layers)
    model.embed.copy_(embed)
    del embed
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, scale=0.02,
                                       dtype=dtype))
    return model


def param_axes(cfg: LMConfig) -> Dict:
    """The reference's logical axes of its parameter tree, as plain
    data: the ``layers`` leaves, stacked over blocks, lead with
    ``"layers"``."""
    def attn():
        ax = {"wq": ("embed", "qkv_fused"), "wk": ("embed", "qkv_fused"),
              "wv": ("embed", "qkv_fused"), "wo": ("qkv_fused", "embed")}
        if cfg.qkv_bias:
            ax.update(bq=("qkv_fused",), bk=("qkv_fused",),
                      bv=("qkv_fused",))
        return ax

    def swiglu():
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}

    def moe():
        ax = {"router": ("embed", "experts"),
              "w_gate": ("experts", "expert_embed", "expert_mlp"),
              "w_up": ("experts", "expert_embed", "expert_mlp"),
              "w_down": ("experts", "expert_mlp", "expert_embed")}
        if cfg.moe.n_shared:
            ax["shared"] = swiglu()
        return ax

    def stacked(tree):
        return {k: stacked(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else ("layers",) + tree

    bs = block_size(cfg)
    sub = [{"attn": attn(), "ln1": ("embed",), "ln2": ("embed",),
            "ffn": moe() if cfg.is_moe and j == bs - 1 else swiglu()}
           for j in range(bs)]
    axes = {"embed": ("vocab", "embed"),
            "layers": tuple(stacked(a) for a in sub),
            "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer_fwd(layer: DecoderLayer, x: torch.Tensor, cfg: LMConfig,
               positions: torch.Tensor, kv_cache=None, cache_len=None,
               write=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x after the layer, its aux loss: 0 for a dense FFN)."""
    # mixed precision: compute in the residual-stream dtype, master
    # weights stay fp32 in the optimizer (a no-op cast for a model held
    # in the compute dtype, as the serving engine holds it)
    lp = layer.params(x.dtype)
    h, _ = attention_fwd(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                         cfg, positions, causal=True, kv_cache=kv_cache,
                         cache_len=cache_len, write=write)
    x = shard(x + h, ACT_AXES)
    y = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if layer.is_moe:
        ff, aux = moe_fwd(lp["ffn"], y, cfg.moe)
    else:
        ff = swiglu_fwd(lp["ffn"], y)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(x + ff, ACT_AXES), aux


def _backbone(model: LM, x: torch.Tensor, cfg: LMConfig,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, None]:
    """Every layer in order, each under one checkpoint.  Returns
    (hidden, aux_sum, None): the sum of each block's aux, each block's
    summed over its layers, as the reference adds them."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    bs = block_size(cfg)
    for i in range(0, cfg.n_layers, bs):
        block = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in model.layers[i:i + bs]:
            x, a = checkpoint(_layer_fwd, layer, x, cfg, positions,
                              use_reentrant=False)
            block = block + a
        aux = aux + block
    return x, aux, None


def _logits(model: LM, x: torch.Tensor, cfg: LMConfig,
            head_axes=None) -> torch.Tensor:
    """``x`` times the head, vocab-sharded; ``head_axes`` constrains the
    head (d, vocab) first."""
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    head = head.to(x.dtype)
    if head_axes is not None:
        head = shard(head, head_axes)
    return shard(x @ head, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _as_tokens(a, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=device, dtype=torch.int64)


def loss_fn(model: LM, batch: Dict, cfg: LMConfig, *,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL of ``batch`` (``tokens`` and ``labels``, (b, l)
    int arrays or tensors): (loss, {"nll", "aux"})."""
    tokens = _as_tokens(batch["tokens"], model.device)
    labels = _as_tokens(batch["labels"], model.device)
    b, l = tokens.shape
    x = shard(model.embed[tokens].to(compute_dtype), ACT_AXES)
    positions = torch.arange(l, device=model.device)
    x, aux, _ = _backbone(model, x, cfg, positions)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    # the head gathered over its embed dim before the product, so that
    # its gradient reduces there (FSDP's weight gather): left free,
    # DTensor on a 3-D mesh gathers the batch instead and reduces whole
    # logits
    logits = _logits(model, x, cfg, (None, "vocab")).to(torch.float32)

    logz = sharding_ctx.logsumexp(logits, dim=-1)
    gold = sharding_ctx.gather_last(logits, labels)
    nll = (logz - gold).mean()
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
KVCache = Dict[str, torch.Tensor]


def make_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """``{"k", "v"}``, each (n_layers, batch, hkv, max_len, hd), zeroed
    on ``device`` (default ``cuda``).  Zeros, not uninitialised memory:
    positions past a row's frontier are read under a mask, and only a
    finite value there contributes exactly 0."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    axes = kv_cache_axes(cfg)["k"]
    return {"k": sharding_ctx.zeros(shape, axes, dtype, device),
            "v": sharding_ctx.zeros(shape, axes, dtype, device)}


def kv_cache_axes(cfg: LMConfig) -> Dict:
    """The reference's logical axes of a cache's K and V (its cache is
    a tuple of ``block_size`` such pairs over blocks; here one pair
    over every layer)."""
    ax = ("layers", "batch", "kv_heads", "kv_seq", None)
    return {"k": ax, "v": ax}


def _cached_backbone(model: LM, x: torch.Tensor, cfg: LMConfig,
                     positions: torch.Tensor, caches: KVCache, cache_len,
                     write=None) -> torch.Tensor:
    """Every layer in order over its slice of ``caches`` (written in
    place), then the final norm."""
    for i, layer in enumerate(model.layers):
        x, _ = _layer_fwd(layer, x, cfg, positions,
                          {"k": caches["k"][i], "v": caches["v"][i]},
                          cache_len, write)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def _last_real(x: torch.Tensor, lengths) -> torch.Tensor:
    """(b, l, d) -> (b, 1, d): each row at its last real position."""
    b, l, _ = x.shape
    last = (_as_tokens(lengths, x.device) - 1).clamp(0, l - 1)
    return x[torch.arange(b, device=x.device), last][:, None]


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def _own_rows(rows, b: int, device):
    """``attention_fwd``'s ``write`` for a launch that writes batch row
    r into cache row r for r in ``rows``: None when that is every row."""
    if rows is None or len(set(rows)) == b:
        return None
    idx = _index(rows, device)
    return idx, idx


def prefill(model: LM, tokens, cfg: LMConfig, max_len: Optional[int] = None,
            *, compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence forward of ``tokens`` (b, l): (last-position logits
    (b, vocab), a new cache of ``max_len`` positions)."""
    b, l = np.shape(tokens)
    return prefill_padded(model, tokens, np.full(b, l), cfg, max_len,
                          compute_dtype=compute_dtype)


@torch.no_grad()
def prefill_padded(model: LM, tokens, lengths, cfg: LMConfig,
                   max_len: Optional[int] = None, *,
                   compute_dtype=torch.bfloat16,
                   caches: Optional[KVCache] = None,
                   slots=None) -> Tuple[torch.Tensor, KVCache]:
    """Right-padded batched prefill (the engine's bucketed admission).

    ``tokens`` (b, l) right-padded to a shared bucket, ``lengths`` (b,)
    the true lengths.  Causal masking keeps every real position
    independent of the padding tail, so row b's logits (taken at
    ``lengths[b] - 1``) and cache positions ``[: lengths[b]]`` are those
    of its own unpadded ``prefill``.  Returns (logits (b, vocab), the
    cache).

    Without ``caches`` a new one of ``max_len`` positions holds every
    row.  With ``caches``, batch row j's K/V go into positions
    ``[0, l)`` of its row ``slots[j]`` (every row into its own when
    ``slots`` is None); rows past ``len(slots)`` are computed and not
    written, and positions past l keep what they held."""
    tokens = _as_tokens(tokens, model.device)
    b, l = tokens.shape
    write = None
    if caches is None:
        caches = make_kv_cache(cfg, b, max_len or l, compute_dtype,
                               model.device)
    elif slots is not None:
        dst = _index(slots, model.device)
        write = (torch.arange(len(dst), device=model.device), dst)
    x = shard(model.embed[tokens].to(compute_dtype), ACT_AXES)
    x = _cached_backbone(model, x, cfg, torch.arange(l, device=model.device),
                         caches, 0, write)
    return _logits(model, _last_real(x, lengths), cfg)[:, 0], caches


@torch.no_grad()
def prefill_extend(model: LM, tokens, lengths, offsets, caches: KVCache,
                   cfg: LMConfig, *, compute_dtype=torch.bfloat16,
                   rows=None) -> Tuple[torch.Tensor, KVCache]:
    """Suffix prefill over per-row cache prefixes (the KV prefix-reuse
    admission path).

    ``tokens`` (b, l) suffixes right-padded to a shared bucket,
    ``lengths`` (b,) their true lengths, ``offsets`` (b,) the prefix
    length already in each cache row.  Row b's token i runs at global
    position ``offsets[b] + i`` (RoPE, cache write, causal mask), so its
    K/V and logits are those of a cold full-prompt prefill whose first
    ``offsets[b]`` tokens made the prefix.  Only ``rows`` (default:
    all) are written into ``caches``; the others compute what the
    reference computes for them (their own K/V in view) and a row of
    length 0 garbage, which the caller discards.  Returns (logits
    (b, vocab), caches)."""
    tokens = _as_tokens(tokens, model.device)
    b, l = tokens.shape
    offsets = _as_tokens(offsets, model.device)
    write = _own_rows(rows, b, model.device)
    positions = offsets[:, None] + torch.arange(l, device=model.device)
    x = shard(model.embed[tokens].to(compute_dtype), ACT_AXES)
    x = _cached_backbone(model, x, cfg, positions, caches, offsets, write)
    return _logits(model, _last_real(x, lengths), cfg)[:, 0], caches


@torch.no_grad()
def decode_step(model: LM, tokens, caches: KVCache, cache_len: int,
                cfg: LMConfig, *, compute_dtype=torch.bfloat16,
                rows=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode of ``tokens`` (b, 1) at position ``cache_len``
    (one int for every row): (logits (b, vocab), caches).  Only ``rows``
    (default: all) are written into ``caches``; the others attend over
    their own new K/V, as in the reference, and keep their cache."""
    tokens = _as_tokens(tokens, model.device)
    b, l = tokens.shape
    cache_len = int(cache_len)
    write = _own_rows(rows, b, model.device)
    positions = cache_len + torch.arange(l, device=model.device)
    x = model.embed[tokens].to(compute_dtype)
    x = _cached_backbone(model, x, cfg, positions, caches, cache_len, write)
    return _logits(model, x, cfg)[:, -1], caches


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
