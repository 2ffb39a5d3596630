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
A tensor that is not a DTensor passes through unchanged.  Where the
tensor takes a gradient, the gradient is constrained too, as a
``with_sharding_constraint``'s transpose constrains the cotangent.

``split_heads``/``merge_heads`` view an attention's heads, gathering a
dim whose shards are not whole heads; ``gqa_heads`` splits the query
heads over ``model`` (unevenly where they do not divide it) with each
rank's key/value heads repeated to them, and ``attend_heads`` runs the
plain attention compositions on each rank's shards.  ``fsdp_gathered``
gathers a training step's weight over its FSDP axes before a product,
and ``laid_out_as`` lays a gradient out as its parameter.

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


def partitioned() -> bool:
    """Whether a sharding context is active: the models then take the
    routes that DTensor can partition (the MoE dispatch and combine)."""
    return _current() is not None


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
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too, as a
    sharding constraint's transpose constrains the cotangent in JAX;
    the gradient then goes back to the input's placements as DTensor's
    own redistribution sends it (a partial one as replicated).  DTensor
    alone would keep a gradient partial where it arrives so: a partial
    activation gradient then makes each later product replicate its
    weight (16x the work on a 16-wide axis)."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate
        ctx.want = want
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.want)
        return g.redistribute(g.device_mesh, ctx.back), None


def fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a training step's product uses it: inside a context,
    a DTensor that takes a gradient has its shards over the mesh axes
    the rules give ``batch`` (which a weight's ``embed`` takes, FSDP's
    split) gathered, so that its gradient reduce-scatters back to them,
    as GSPMD gathers an FSDP weight; DTensor, left to choose per op,
    gathers the activations in some backward products instead.  A
    serving step's weights stay split (a decode step's few rows reduce
    partial products instead).  Anything else passes unchanged."""
    ctx = _current()
    if ctx is None or not _is_dtensor(w) or not (
            torch.is_grad_enabled() and w.requires_grad):
        return w
    from torch.distributed.tensor import Replicate
    mesh, rules = ctx
    batch = rules.mesh_axes_for("batch") or ()
    names = mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in batch else p
                 for i, p in enumerate(w.placements))
    return w.redistribute(mesh, want)


def laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its parameter: inside a context, a DTensor
    gradient redistributed to the parameter's placements (a partial sum
    reduce-scattered), as GSPMD lays a gradient out as its parameter, so
    that the optimizer's update runs on each rank's shard; DTensor would
    leave a table's gradient whole on every rank.  Anything else passes
    unchanged."""
    if _current() is None or not _is_dtensor(g) or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(g.device_mesh, p.placements)


def zeros(shape, logical_axes: Sequence[Optional[str]], dtype,
          device) -> torch.Tensor:
    ctx = _current()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from repro_torch.common.sharding import local_shape
    mesh, rules = ctx
    # not a constraint of the reference's (it lets GSPMD place its new
    # zeros): no entry in the fallback audit
    spec = rules.spec(mesh, shape, logical_axes, audit=False)
    local = torch.zeros(local_shape(mesh, shape, spec), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (without making
    one: a step's counter would count its bytes)."""
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(size), 1)
    return tuple(reversed(out))


def _is_dtensor(x) -> bool:
    # a DTensor exists only once DTensor is loaded: a step on plain
    # tensors does not load it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _ranks_along(x: torch.Tensor, dim: int) -> int:
    """How many ranks split ``dim`` of ``x`` (1 for a plain tensor)."""
    if not _is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard
    dim %= x.dim()
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def _split_along(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose ``dim`` is split over more than
    one rank."""
    return _ranks_along(x, dim) > 1


def _whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` gathered on every rank (its other placements
    kept)."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.dim()
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(b, l, n * d) -> (b, n, l, d).  Where a DTensor's shards of the
    last dim are not whole heads (``n`` does not divide over its
    ranks), the dim is gathered first: DTensor cannot view such a
    shard as heads."""
    b, l, w = x.shape
    if n % _ranks_along(x, 2):
        x = _whole_along(x, 2)
    return x.reshape(b, l, n, w // n).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, n, l, d) -> (b, l, n * d).  Where the heads do not divide
    over the ranks of the axes the rules give them, they are gathered
    first, and so is the result's gradient: flattened shards of uneven
    heads would not line up with an even split of ``n * d``, nor an
    even split of the gradient with whole heads."""
    b, n, l, d = x.shape
    if not _is_dtensor(x) or not n % _heads_ranks():
        return x.transpose(1, 2).reshape(b, l, n * d)
    out = _whole_along(x, 1).transpose(1, 2).reshape(b, l, n * d)
    # and the gradient whole too, for the view back to heads
    return _Constrain.apply(out, out.placements) if out.requires_grad \
        and torch.is_grad_enabled() else out


def _heads_dims(mesh, rules) -> list:
    """The mesh dims of the axes ``rules`` give ``heads``."""
    heads = rules.mesh_axes_for("heads") or ()
    return [i for i, name in enumerate(mesh.mesh_dim_names)
            if name in heads]


def _heads_ranks() -> int:
    """Ranks of the mesh axes the context's rules give ``heads``."""
    ctx = _current()
    n = 1
    for i in _heads_dims(*ctx) if ctx else ():
        n *= ctx[0].size(i)
    return n


def gqa_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (b, hq, lq, d) and k, v (b, hkv, lk, d) laid out so that each
    rank runs whole query heads against the key/value heads they read.

    On the mesh axes the rules give ``heads`` that the K/V do not take
    for another dim (a decode cache's sequence), q is split by heads,
    unevenly where they do not divide (as GSPMD pads them), and k, v
    are repeated to ``hq`` heads under the same split: each rank
    repeats only the key/value heads of its own query heads.  Where no
    such axis is left, q's heads are gathered, so that a grouped view of
    them (``hkv`` groups) is whole on every rank.  Outside a context,
    or on plain tensors, the three pass unchanged."""
    ctx = _current()
    if ctx is None or not _is_dtensor(q):
        return q, k, v
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh, rules = ctx
    taken = {i for t in (q, k) for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim != 1}
    split = [i for i in _heads_dims(mesh, rules)
             if i not in taken and mesh.size(i) > 1]
    if not split:
        return _whole_along(q, 1), k, v

    def by_heads(t):
        return tuple(Shard(1) if i in split else p for i, p in
                     enumerate(_whole_along(t, 1).placements))
    q = q.redistribute(mesh, by_heads(q))
    hq, hkv = q.shape[1], k.shape[1]
    if hq == hkv:
        return q, k.redistribute(mesh, by_heads(k)), \
            v.redistribute(mesh, by_heads(v))
    off, n = _local_range(q, 1)
    heads_of = (off + torch.arange(n, device=q.device)) // (hq // hkv)

    def repeat(t):
        t = _whole_along(t, 1)
        # each rank reads its own heads: the gradient is a partial sum
        grad = tuple(Partial() if i in split else p
                     for i, p in enumerate(t.placements))
        local = t.to_local(grad_placements=grad).index_select(1, heads_of)
        shape = (t.shape[0], hq) + tuple(t.shape[2:])
        return DTensor.from_local(
            local, mesh, by_heads(t), run_check=False,
            shape=torch.Size(shape), stride=contiguous_stride(shape))
    return q, repeat(k), repeat(v)


def attend_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)``, an attention composition (q heads, then
    time, then features), with the heads laid out by ``gqa_heads``.
    Where they are split (and the keys' time is not), each rank runs
    ``fn`` on its own shards, q's rows laid out as the K/V's, and the
    output keeps that layout: DTensor cannot partition the
    compositions' grouped products over split heads (it folds heads
    into a product's batch dim and refuses to unfold the result).
    Plain tensors pass straight to ``fn``."""
    q, k, v = gqa_heads(q, k, v)
    if not _split_along(q, 1) or _split_along(k, 2):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor
    # q's rows as the K/V's (a cache keeps the reference's layout)
    q = q.redistribute(q.device_mesh, k.placements)
    v = v.redistribute(v.device_mesh, k.placements)
    off, n = _local_range(q, 0)

    def local(t):              # a per-row argument: this rank's rows
        if _is_dtensor(t):
            return t.to_local()
        if torch.is_tensor(t) and t.dim() and t.shape[0] == q.shape[0]:
            return t[off:off + n]
        return t
    out = fn(q.to_local(), k.to_local(), v.to_local(),
             **{key: local(t) for key, t in kw.items()})
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


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
    ``t``: its mesh dims that shard ``dim`` split it in mesh order,
    each as ``torch.chunk`` does (chunks of the size rounded up, the
    last ones short or empty where the dim does not divide)."""
    from torch.distributed.tensor import Shard
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    off, size = 0, t.shape[dim]
    for mesh_dim, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            per = -(-size // mesh.size(mesh_dim))
            lo = min(coord[mesh_dim] * per, size)
            off, size = off + lo, min(per, size - lo)
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
