"""Tiny seeded serving engines for tests and checks.

One recipe, one weight cache: the differential serving suites need a
small LM behind an ``Engine``, and their batched-vs-sequential
comparisons are only meaningful when every engine built from the same
recipe holds IDENTICAL weights.  The weights are drawn once per
(config, seed) with a seeded CPU ``torch.Generator`` and copied to the
device asked for, so the same recipe gives the same weights on the
CPU and on the card.  To hold the port against the JAX package, pass
the JAX engine's parameter tree as numpy (``params=``), carried over
by ``models.convert.params_from_numpy``.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from repro_torch.common.config import LMConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import LM, init_params
from repro_torch.serving.engine import Engine, EngineConfig

_PARAMS_CACHE: dict = {}


def make_test_engine(max_batch: int = 2, max_seq_len: int = 64,
                     max_new_tokens: int = 6, seed: int = 0,
                     prefix_cache_entries: int = 0, device=None,
                     params: Optional[Dict] = None,
                     **lm_overrides) -> Engine:
    """Small seeded fp32 ``Engine`` on ``device`` (default ``cuda``);
    LMConfig fields override via kwargs.  ``params`` (a JAX parameter
    tree of numpy arrays) replaces the seeded draw."""
    device = resolve_device(device)
    lm_kw = dict(name="t", family="lm-dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                 max_seq_len=128)
    lm_kw.update(lm_overrides)
    lm = LMConfig(**lm_kw)
    if params is not None:
        model = params_from_numpy(params, lm, device=device)
    else:
        key = (tuple(sorted(lm_kw.items())), seed, str(device))
        if key not in _PARAMS_CACHE:
            cpu = (tuple(sorted(lm_kw.items())), seed, "cpu")
            if cpu not in _PARAMS_CACHE:
                _PARAMS_CACHE[cpu] = init_params(
                    lm, torch.Generator().manual_seed(seed))
            _PARAMS_CACHE[key] = copy.deepcopy(_PARAMS_CACHE[cpu]).to(device)
        model: LM = _PARAMS_CACHE[key]
    return Engine(lm, model,
                  EngineConfig(max_batch=max_batch,
                               max_seq_len=max_seq_len,
                               max_new_tokens=max_new_tokens,
                               prefix_cache_entries=prefix_cache_entries))
