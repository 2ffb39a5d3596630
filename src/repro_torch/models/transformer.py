"""Decoder-only LM (dense): init and the training loss.

``LM`` holds the weights: ``embed`` (vocab, d), ``layers`` (one
``DecoderLayer`` each), ``final_norm`` and, unless the embeddings are
tied, ``lm_head`` (d, vocab).  Master weights are fp32; each layer casts
them to the residual-stream dtype (bf16 by default) inside its forward,
as the JAX package does at ``transformer.py:112-114``.  Each layer runs
under ``torch.utils.checkpoint`` (non-reentrant), standing in for the
``jax.checkpoint`` on the reference's scanned layer body: its
activations are recomputed in the backward, attention's forward kernel
included.

Serving (``prefill``, ``prefill_padded``, ``prefill_extend``,
``decode_step``) and MoE are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import LMConfig, not_ported
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import DecoderLayer, attention_fwd, \
    attention_init, dense_init, rmsnorm, swiglu_fwd, swiglu_init


class LM(nn.Module):
    """The weights of a dense decoder-only LM (uninitialised; see
    ``init_params`` and ``convert.params_from_numpy``)."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None,
                 layers=None):
        super().__init__()
        if cfg.is_moe:
            raise not_ported("MoE layers (moe_fwd)", "11. MoE")
        self.cfg = cfg
        d, vocab = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((vocab, d), dtype=dtype,
                                              device=device))
        self.layers = nn.ModuleList(
            layers if layers is not None else
            [DecoderLayer(cfg, dtype, device) for _ in range(cfg.n_layers)])
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
    layers = [DecoderLayer(cfg, dtype, device,
                           attn=attention_init(generator, cfg, dtype),
                           ffn=swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                           dtype))
              for _ in range(cfg.n_layers)]
    model = LM(cfg, dtype, device, layers=layers)
    model.embed.copy_(embed)
    del embed
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, scale=0.02,
                                       dtype=dtype))
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer_fwd(layer: DecoderLayer, x: torch.Tensor, cfg: LMConfig,
               positions: torch.Tensor) -> torch.Tensor:
    # mixed precision: compute in the residual-stream dtype, master
    # weights stay fp32 in the optimizer
    lp = layer.params(x.dtype)
    h, _ = attention_fwd(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                         cfg, positions, causal=True)
    x = x + h
    y = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu_fwd(lp["ffn"], y)


def _backbone(model: LM, x: torch.Tensor, cfg: LMConfig,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, None]:
    """Every layer in order, each under one checkpoint.  Returns
    (hidden, aux_sum, None); a dense LM has no aux loss."""
    for layer in model.layers:
        x = checkpoint(_layer_fwd, layer, x, cfg, positions,
                       use_reentrant=False)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), None


def _logits(model: LM, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _as_tokens(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=torch.int64)


def loss_fn(model: LM, batch: Dict, cfg: LMConfig, *,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL of ``batch`` (``tokens`` and ``labels``, (b, l)
    int arrays or tensors): (loss, {"nll", "aux"})."""
    tokens = _as_tokens(batch["tokens"], model.device)
    labels = _as_tokens(batch["labels"], model.device)
    b, l = tokens.shape
    x = model.embed[tokens].to(compute_dtype)
    positions = torch.arange(l, device=model.device)
    x, aux, _ = _backbone(model, x, cfg, positions)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = _logits(model, x, cfg).to(torch.float32)

    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: not ported
# ---------------------------------------------------------------------------
def _serving(name: str):
    def fn(*args, **kwargs):
        raise not_ported(f"transformer.{name}", "3. LM serving")
    fn.__name__ = name
    fn.__doc__ = "Not ported yet: raises (ROADMAP queue 1, LM serving)."
    return fn


prefill = _serving("prefill")
prefill_padded = _serving("prefill_padded")
prefill_extend = _serving("prefill_extend")
decode_step = _serving("decode_step")
