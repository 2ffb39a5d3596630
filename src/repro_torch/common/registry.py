"""Architecture registry: ``--arch <id>`` resolution.

Configs register themselves at import time; ``get_arch`` lazily imports
``repro_torch.configs`` so callers never need to worry about import
order.  The names are the JAX package's.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.common.config import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str):
    """Decorator: register a zero-arg factory returning an ArchConfig."""

    def deco(fn: Callable[[], ArchConfig]):
        if name in _REGISTRY:
            raise ValueError(f"duplicate arch registration: {name}")
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if cfg.name != name:
        raise ValueError(f"config name {cfg.name!r} != key {name!r}")
    return cfg


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
