"""Activation-sharding context.

Models call ``shard(x, ("batch", "seq", None))`` at layer boundaries,
where the JAX package's models call it.  Outside a context ``shard``
returns ``x`` itself: one thread-local read, no copy, no launch, so a
model's outputs and gradients are what they are without the calls.
The dry run (``launch/dryrun.py``) installs a ``DeviceMesh`` and the
logical rules with ``activation_sharding``; inside it ``shard``
redistributes a DTensor to the placements its logical axes resolve to,
and DTensor issues the collectives that takes, as a
``with_sharding_constraint`` makes GSPMD insert them in the reference.
A tensor that is not a DTensor passes through unchanged.

``zeros`` makes a tensor that a step creates and shards (a prefill's
new KV cache): ``torch.zeros`` outside a context, a DTensor of its
logical axes' placements inside one.  ``logsumexp`` and
``gather_last`` reduce a sharded dim shard by shard.  ``write_slice`` is the in-place slice
write of a decode step's K/V into
its cache.  On a plain tensor it is the slice assignment; on a DTensor
sharded along the written dim (the decode rules' ``kv_seq``), each rank
writes the part of the slice its shard holds, as GSPMD partitions a
``dynamic_update_slice``, where DTensor would gather the whole cache to
slice it.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.common.sharding import LogicalRules, placements

_STATE = threading.local()


def _current() -> Optional[Tuple[object, LogicalRules]]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: LogicalRules):
    prev = _current()
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard(x: torch.Tensor, logical_axes: Sequence[Optional[str]]):
    ctx = _current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(mesh, rules.spec(mesh, x.shape, logical_axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def zeros(shape, logical_axes: Sequence[Optional[str]], dtype,
          device) -> torch.Tensor:
    ctx = _current()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from repro_torch.common.sharding import local_shape
    mesh, rules = ctx
    spec = rules.spec(mesh, shape, logical_axes)
    local = torch.zeros(local_shape(mesh, shape, spec), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _split_along(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose ``dim`` is split over more than
    one rank."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None or not isinstance(x, mod.DTensor):
        return False
    dim %= x.dim()
    return any(getattr(p, "dim", None) == dim and p.is_shard() and
               x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp(x, dim)``; where a DTensor splits ``dim`` (an
    LM's vocab-sharded logits), as its max, then its sum of
    exponentials, each reduced across the shards, as GSPMD partitions
    the reduction: DTensor would gather the whole dim to every rank."""
    if not _split_along(x, dim):
        return torch.logsumexp(x, dim=dim)
    m = x.amax(dim=dim, keepdim=True).detach()
    return (x - m).exp().sum(dim=dim).log() + m.squeeze(dim)


def gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``; where a
    DTensor splits the last dim, as a masked sum over it, each rank
    matching the ids of its own shard and the shards' sums reduced:
    DTensor's gather backward would build zeros of the whole dim on
    every rank."""
    if not _split_along(x, -1):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mod = sys.modules["torch.distributed.tensor"]
    from torch.distributed.tensor import Replicate, Shard
    dim = x.dim() - 1
    off, size = _local_range(x, dim)
    ids = mod.DTensor.from_local(
        torch.arange(off, off + size, device=x.device), x.device_mesh,
        tuple(Shard(0) if isinstance(p, Shard) and p.dim == dim
              else Replicate() for p in x.placements),
        run_check=False, shape=torch.Size([x.shape[-1]]), stride=(1,))
    hit = index.to(ids.dtype)[..., None] == ids
    return torch.where(hit, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum(-1)


def _local_range(t, dim: int):
    """(offset, size) along ``dim`` of this rank's shard of DTensor
    ``t`` (its mesh dims that shard ``dim`` split it in mesh order)."""
    from torch.distributed.tensor import Shard
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    off, size = 0, t.shape[dim]
    for mesh_dim, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(mesh_dim)
            off += coord[mesh_dim] * size
    return off, size


def write_slice(dst: torch.Tensor, src: torch.Tensor, dim: int,
                start: int) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim`` (n =
    ``src.shape[dim]``), in place."""
    # a DTensor exists only once DTensor is loaded: a serving step on
    # plain tensors does not load it
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None or not isinstance(dst, mod.DTensor):
        dst[(slice(None),) * dim + (slice(start, start + src.shape[dim]),)] \
            = src
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in dst.placements)
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 (Replicate(),) * dst.device_mesh.ndim,
                                 run_check=False)
    src = src.redistribute(dst.device_mesh, want).to_local()
    off, size = _local_range(dst, dim)
    lo, hi = max(start, off), min(start + src.shape[dim], off + size)
    if lo < hi:
        dst.to_local().narrow(dim, lo - off, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))
