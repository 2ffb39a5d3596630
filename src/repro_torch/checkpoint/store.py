"""Fault-tolerant checkpointing: whole arrays in one npz, a JSON
manifest, an async writer, keep-last-k retention.

The JAX package's on-disk layout, so a checkpoint written by either
package loads in the other:

- ``step-%08d/`` holds ``arrays.npz`` and ``manifest.json``; each array
  is keyed by its tree path (``"['shards']/[0]/['buf']"``: dict keys
  sorted and quoted, sequence indices, ``.field`` for a NamedTuple),
  stored under the blake2b-8 of that key, and carries a blake2b-8
  digest of its bytes, checked on load;
- a write goes to ``step-%08d.tmp/`` and is renamed into place, so a
  crashed write never shadows the latest checkpoint;
- ``CheckpointManager.save_async`` copies the tree to the host at once
  and writes it in a background thread.

Leaves are tensors (on any device), numpy arrays and Python scalars;
``None`` is an empty subtree, as in a JAX pytree.  ``load_checkpoint``
with a ``template`` rebuilds the template's structure and puts each
tensor leaf back on the template leaf's device.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(path part, child)`` pairs of a container in JAX's flattening
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten_with_path(tree: Any, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in kids:
        out += _flatten_with_path(child,
                                  f"{prefix}/{part}" if prefix else part)
    return out


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, visited
    in flattening order."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_map_with_path(fn, child,
                           f"{prefix}/{part}" if prefix else part)
            for part, child in kids]
    if isinstance(tree, dict):
        return type(tree)(zip(sorted(tree), vals))
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    return [(key, _host(leaf)) for key, leaf in _flatten_with_path(tree)]


def _digest(a: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                           digest_size=8).hexdigest()


def save_checkpoint(path: Path, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    path = Path(path)
    final = path / f"step-{step:08d}"
    tmp = path / f"step-{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "arrays": {},
    }
    arrays = {}
    for key, arr in _flatten(tree):
        name = hashlib.blake2b(key.encode(), digest_size=8).hexdigest()
        arrays[name] = arr
        manifest["arrays"][key] = {
            "file": name,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "digest": _digest(arr),
        }
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _resolve_step_dir(path: Path, step: Optional[int]) -> Path:
    path = Path(path)
    if step is not None:
        return path / f"step-{step:08d}"
    cands = sorted(p for p in path.glob("step-*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {path}")
    return cands[-1]


def load_manifest(path: Path,
                  step: Optional[int] = None) -> Tuple[int, Dict]:
    """A checkpoint's ``(step, extra)`` without reading its arrays (the
    lifecycle manager sizes its template from them)."""
    final = _resolve_step_dir(path, step)
    manifest = json.loads((final / "manifest.json").read_text())
    return manifest["step"], manifest["extra"]


def load_checkpoint(path: Path, step: Optional[int] = None,
                    template: Any = None) -> Tuple[int, Any, Dict]:
    """Load the given (or latest) step and verify every digest.  With no
    ``template``, the arrays come back keyed by path; with one, in its
    structure, each leaf's shape checked where it has one and each
    tensor leaf's array put on that tensor's device."""
    final = _resolve_step_dir(path, step)
    manifest = json.loads((final / "manifest.json").read_text())
    data = np.load(final / "arrays.npz")
    by_key: Dict[str, np.ndarray] = {}
    for key, meta in manifest["arrays"].items():
        arr = data[meta["file"]]
        if _digest(arr) != meta["digest"]:
            raise IOError(f"digest mismatch for {key} in {final}")
        by_key[key] = arr
    if template is None:
        return manifest["step"], by_key, manifest["extra"]

    def restore(key: str, leaf: Any) -> Any:
        if key not in by_key:
            raise KeyError(f"checkpoint missing {key}")
        arr = by_key[key]
        want = getattr(leaf, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(want)}")
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(arr, device=leaf.device)
        return arr

    tree = _map_with_path(restore, template)
    return manifest["step"], tree, manifest["extra"]


class CheckpointManager:
    def __init__(self, path: Path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy the tree to the host now; write it in the background."""
        self.wait()
        # a copy, not a view: a CPU tensor's .numpy() and np.asarray of
        # an ndarray alias the caller's storage, which its next
        # mutation would race the background write for
        host_tree = _map_with_path(lambda _, x: np.array(_host(x)), tree)

        def work():
            try:
                save_checkpoint(self.path, step, host_tree, extra)
                self._gc()
            except BaseException as ex:  # noqa: BLE001
                self._error = ex

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        self.wait()
        out = save_checkpoint(self.path, step, tree, extra)
        self._gc()
        return out

    def steps(self) -> List[int]:
        """Completed (not torn) checkpoint steps, ascending."""
        cands = sorted(p for p in self.path.glob("step-*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        return [int(p.name.split("-")[1]) for p in cands]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        for step in self.steps()[:-self.keep]:
            shutil.rmtree(self.path / f"step-{step:08d}",
                          ignore_errors=True)
