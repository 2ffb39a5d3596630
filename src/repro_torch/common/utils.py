"""Small shared utilities: named generators, tree helpers, timers.

A tree is what the port's parameters and batches are made of: tensors
(or numpy arrays), ``nn.Module``s (their parameters and buffers), and
dicts, lists and tuples of these.
"""
from __future__ import annotations

import hashlib
from typing import Any, Iterator

import numpy as np
import torch

# the reference's ``timed`` is this accumulating timer itself
from repro_torch.obs.timers import timed_block  # noqa: F401


def key_for(seed: int, *path: Any) -> torch.Generator:
    """Deterministic named generators: a CPU ``torch.Generator`` seeded
    from a blake2b digest of ``(seed, *path)``, each part as its
    ``str``.

    Workers reproduce any stream from (seed, path), in any process.
    The JAX package folds ``abs(hash(str(p)))`` into its key, and Python
    salts ``str`` hashes per process, so its keys are not reproducible
    across processes; the digest here is."""
    h = hashlib.blake2b(digest_size=8)
    for part in (seed, *path):
        b = str(part).encode()
        h.update(len(b).to_bytes(4, "little") + b)
    seed63 = int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)
    return torch.Generator().manual_seed(seed63)


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A tensor or array (numpy, or what numpy takes) as a tensor on
    ``device``, cast to ``dtype`` when given."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The array leaves of a tree: a module's parameters and buffers,
    the values of dicts (keys sorted), the items of lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from tree_leaves(t)
    elif hasattr(tree, "shape"):
        yield tree


def _itemsize(x) -> int:
    return x.element_size() if torch.is_tensor(x) else x.dtype.itemsize


def tree_size_bytes(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) * _itemsize(x)
               for x in tree_leaves(tree))


def tree_param_count(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """A copy of a tree of tensors with its floating leaves in
    ``dtype`` (a module is cast in place, as ``Module.to`` does)."""
    if isinstance(tree, torch.nn.Module):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(t, dtype) for t in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"


def ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult
