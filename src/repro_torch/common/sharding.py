"""Logical-axis sharding rules, and the placement rules of the sharded
store.

**Logical rules** (the JAX package's ``common/sharding.py``, MaxText
style).  Models name their arrays' dims with *logical* axes ("batch",
"embed", "heads", "vocab", ...).  A ``LogicalRules`` table maps each
logical name to mesh axes, and ``spec`` resolves a (shape, logical axes)
pair to a spec: a plain tuple with one entry a dim, ``None``, an axis
name, or a tuple of names (a ``PartitionSpec``'s entries).  A dim whose
size the product of its mesh axes does not divide keeps the longest
prefix of them that divides it, or is replicated; each replication is
logged in ``fallbacks``, the audit that makes a sharding regression
visible (phi3's 40 heads over a 16-wide ``model`` axis, for one).  An
axis is consumed once per array: a later dim does not reuse it.

A mesh here is anything with named axes and their sizes: a
``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``'s
``make_production_mesh``), or a ``MeshShape``, the device-free
description ``jax.sharding.AbstractMesh`` is in the JAX package.
``placements`` is the one converter from a spec to DTensor placements
over a ``DeviceMesh``: mesh axis ``a`` shards tensor dim ``d`` where the
spec puts ``a`` on ``d`` (a dim over two axes is ``Shard(d)`` on both,
in mesh order), and replicates elsewhere.

**The sharded store's rules.**  The JAX package lays the stacked
``(S, cap, d + F)`` buffer over the ``db_shards`` axes of a device mesh.
The port's store lays it over the ranks of a process group
(``launch/mesh.py``'s ``DataGroup``) instead: the size of the shard axis
(``db_axis_size``: the group's ranks), how many slots a shard count
takes (``padded_slot_count``: slots are padded, never ranks), which
slots a rank holds (``stacked_slot_range``: contiguous, shard-major) and
which device owns each shard of a store on one device
(``shard_placements``).  ``db_axis_size``, ``shard_placements`` and
``stacked_db_shardings`` also take a mesh, as in the JAX package.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshShape:
    """A mesh's named axes and sizes, with no devices or group behind
    it (``jax.sharding.AbstractMesh``): enough to resolve specs."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh``, a
    ``MeshShape`` or a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                                  # DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, MeshShape):
        return mesh.shape
    if isinstance(mesh, Mapping):
        return dict(mesh)
    raise TypeError(f"not a mesh: {mesh!r}")


def _is_mesh(x) -> bool:
    return isinstance(x, (MeshShape, Mapping)) or \
        getattr(x, "mesh_dim_names", None) is not None


# ---------------------------------------------------------------------------
# logical rules
# ---------------------------------------------------------------------------
class LogicalRules:
    """Ordered logical-name -> mesh-axes mapping."""

    def __init__(self, rules: Sequence[Tuple[str, MeshAxes]]):
        self._rules: Dict[str, MeshAxes] = {}
        for name, axes in rules:
            if isinstance(axes, str):
                axes = (axes,)
            self._rules[name] = axes
        self.fallbacks: List[Tuple[str, int, str]] = []  # audit log

    def mesh_axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self._rules.get(logical)

    def extend(self, rules: Sequence[Tuple[str, MeshAxes]]
               ) -> "LogicalRules":
        merged = list(self._rules.items()) + list(rules)
        return LogicalRules(merged)

    def spec(self, mesh, shape: Sequence[int],
             logical_axes: Sequence[Optional[str]], *,
             audit: bool = True) -> Spec:
        """Resolve to a spec, applying the divisibility fallback (logged
        in ``fallbacks`` unless ``audit`` is false)."""
        if len(shape) != len(logical_axes):
            raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                             f"logical axes {tuple(logical_axes)}")
        sizes = mesh_shape(mesh)
        used: set = set()
        out: List[MeshAxes] = []
        for dim, logical in zip(shape, logical_axes):
            axes = self.mesh_axes_for(logical)
            if axes is None:
                out.append(None)
                continue
            # drop axes already consumed by an earlier dim of this array
            axes = tuple(a for a in axes if a not in used and a in sizes)
            if not axes:
                out.append(None)
                continue
            prod = int(np.prod([sizes[a] for a in axes]))
            if dim % prod != 0:
                # try progressively shorter prefixes before replicating
                ok: Tuple[str, ...] = ()
                p = 1
                for a in axes:
                    if dim % (p * sizes[a]) == 0:
                        p *= sizes[a]
                        ok = ok + (a,)
                    else:
                        break
                if ok:
                    # one axis is written bare, as a PartitionSpec does
                    out.append(ok if len(ok) > 1 else ok[0])
                    used.update(ok)
                else:
                    if audit:
                        self.fallbacks.append((str(logical), dim,
                                               "->replicated"))
                    out.append(None)
                continue
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        return tuple(out)


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Sequence[MeshAxes]) -> tuple:
    """DTensor placements over ``mesh`` (a ``DeviceMesh``) for
    ``spec``: ``Shard(d)`` on each mesh axis the spec puts on dim ``d``,
    ``Replicate()`` on the others.  A dim over several axes must list
    them in mesh order (DTensor shards a dim over mesh dims in that
    order, as a ``PartitionSpec`` entry does over its axes)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} of dim {d} is not in "
                             f"mesh order {tuple(names)}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, shape: Sequence[int],
                spec: Sequence[MeshAxes]) -> Tuple[int, ...]:
    """One rank's shard of ``shape`` under ``spec`` (the rules only
    shard a dim its axes' product divides, so every rank's is equal)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        n = int(np.prod([sizes[a] for a in spec_axes(entry)]))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry!r}")
        out.append(dim // n)
    return tuple(out) + tuple(shape[len(spec):])


def named_sharding(mesh, *spec) -> tuple:
    """``placements(mesh, spec)``: the JAX package's ``NamedSharding``
    of a spec written out."""
    return placements(mesh, spec)


def logical_sharding(mesh, rules: LogicalRules, shape: Sequence[int],
                     logical_axes: Sequence[Optional[str]]) -> tuple:
    return placements(mesh, rules.spec(mesh, shape, logical_axes))


# ---------------------------------------------------------------------------
# per-family default rule tables (MaxText axis names)
# ---------------------------------------------------------------------------
def lm_rules(decode: bool = False, long_context: bool = False
             ) -> LogicalRules:
    """LM transformer rules.

    Training/prefill: batch over (pod, data); mlp + heads + vocab over
    model.  Decode: KV-cache sequence dim over model (split-K /
    flash-decoding analogue); long-context batch=1 shards KV seq over
    (data, model) too.
    """
    kv_seq: MeshAxes
    if long_context:
        kv_seq = ("pod", "data", "model")
    elif decode:
        kv_seq = ("model",)
    else:
        kv_seq = None
    return LogicalRules([
        ("batch", ("pod", "data")),
        ("seq", None),
        ("kv_seq", kv_seq),
        # weights have no batch dim, so "embed" -> data gives FSDP/ZeRO-3
        # weight+optimizer sharding; activations (batch leads) have
        # already consumed the data axis and keep embed replicated.
        ("embed", ("pod", "data")),
        ("mlp", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("qkv_fused", ("model",)),
        ("head_dim", None),
        ("vocab", ("model",)),
        ("experts", ("model",)),
        ("tokens", ("pod", "data")),
        ("expert_mlp", ("pod", "data")),
        ("expert_embed", None),
        ("layers", None),
    ])


def gnn_rules() -> LogicalRules:
    return LogicalRules([
        ("edges", ("pod", "data", "model")),
        ("nodes", ("model",)),
        ("node_feat", None),
        ("hidden", None),
        ("batch", ("pod", "data")),
        ("layers", None),
    ])


def recsys_rules(serving: bool = False) -> LogicalRules:
    """Retrieval serving replicates the embedding table: row-sharded
    tables turn every candidate lookup into an all-to-all, and a
    read-only replica's table (vocab x dim, O(100 MB)) fits device
    memory.  Training keeps row sharding (tables take optimizer state
    there)."""
    return LogicalRules([
        ("batch", ("pod", "data")),
        ("vocab_rows", None if serving else ("model",)),
        ("embed", None),
        ("mlp", ("model",)),
        ("candidates", ("data", "model")),
        ("seq", None),
        ("layers", None),
    ])


def retrieval_rules() -> LogicalRules:
    """Sharded-retrieval rules: DB shards/rows over the data axis;
    query batches and per-shard top-k candidates replicated (the merge
    collective is O(s*k) per query; see core/store.py)."""
    return LogicalRules([
        ("db_shards", ("data",)),
        ("db_rows", ("data",)),
        ("qbatch", None),
        ("topk", None),
        ("embed_flags", None),
    ])


def rules_for_family(family: str, shape_kind: str = "") -> LogicalRules:
    if family in ("lm-dense", "lm-moe"):
        return lm_rules(decode=shape_kind in ("inference-decode",
                                              "long-context-decode"),
                        long_context=shape_kind == "long-context-decode")
    if family == "gnn":
        return gnn_rules()
    if family == "recsys":
        return recsys_rules(serving=shape_kind in (
            "online-inference", "offline-scoring",
            "retrieval-scoring"))
    raise ValueError(f"unknown family {family}")


# ---------------------------------------------------------------------------
# the sharded store
# ---------------------------------------------------------------------------
def db_shard_axes(mesh, rules: Optional[LogicalRules] = None
                  ) -> Tuple[str, ...]:
    """The mesh axes the ``db_shards`` logical axis resolves to (empty
    when the rules replicate it or the mesh lacks those axes)."""
    rules = rules or retrieval_rules()
    axes = rules.mesh_axes_for("db_shards")
    if axes is None:
        return ()
    sizes = mesh_shape(mesh)
    return tuple(a for a in axes if a in sizes)


def db_axis_size(group=None, rules: Optional[LogicalRules] = None) -> int:
    """Ranks along the store's shard axis: a group's size (1 without a
    group), or the device count along a mesh's ``db_shards`` axes."""
    if group is None:
        return 1
    if _is_mesh(group):
        sizes = mesh_shape(group)
        return int(np.prod([sizes[a] for a in db_shard_axes(group, rules)]))
    return int(group.world_size)


def padded_slot_count(n_shards: int, axis_size: int) -> int:
    """Slot count for a stacked shard buffer: the smallest multiple of
    the shard axis's size that fits ``n_shards`` (extra slots stay
    empty, their rows dead-flagged, rather than ever collapsing rows
    onto one rank)."""
    return -(-int(n_shards) // int(axis_size)) * int(axis_size)


def stacked_slot_range(n_slots: int, axis_size: int, rank: int) -> range:
    """The slots of an ``n_slots`` stacked buffer that ``rank`` holds
    when the buffer is laid over ``axis_size`` ranks: a contiguous,
    shard-major group of ``n_slots / axis_size`` (``shard_placements``'
    rule when the count divides; ``padded_slot_count`` makes it
    divide)."""
    if n_slots % axis_size:
        raise ValueError(f"{n_slots} slots do not divide {axis_size} "
                         f"ranks; pad them with padded_slot_count")
    per = n_slots // axis_size
    return range(rank * per, (rank + 1) * per)


def stacked_db_shardings(mesh, rules: Optional[LogicalRules] = None
                         ) -> Tuple[tuple, tuple]:
    """``(buffer, seq-plane)`` placements for the stacked shard index:
    the ``(S, cap, d+flags)`` buffer and its ``(S, cap)`` sequence plane
    put the slot dim over the ``db_shards`` axes and replicate
    rows/features."""
    axes = db_shard_axes(mesh, rules)
    if not axes:
        raise ValueError(
            f"mesh axes {tuple(mesh_shape(mesh))} resolve no db_shards "
            f"axes; cannot lay out a stacked shard buffer")
    lead = axes if len(axes) != 1 else axes[0]
    return placements(mesh, (lead, None, None)), \
        placements(mesh, (lead, None))


def mesh_axis_devices(mesh, axes: Sequence[str]) -> List[int]:
    """Ordered ranks spanning ``axes`` of the mesh, taking one
    representative (index 0) along every other mesh axis.  A
    ``MeshShape``'s ranks are its positions in row-major order."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    if getattr(mesh, "mesh_dim_names", None) is not None:
        devs = np.asarray(mesh.mesh.cpu().numpy())
    else:
        devs = np.arange(int(np.prod(list(sizes.values())))).reshape(
            tuple(sizes.values()))
    order = [names.index(a) for a in axes] + \
        [i for i, n in enumerate(names) if n not in axes]
    devs = np.transpose(devs, order)
    lead = int(np.prod(devs.shape[:len(axes)])) if axes else 1
    return [int(d) for d in devs.reshape(lead, -1)[:, 0]]


def shard_placements(devices, n_shards: int,
                     rules: Optional[LogicalRules] = None) -> list:
    """Owning device per shard id.  ``devices`` is a sequence of
    devices, or a mesh: then the owners are ranks along its
    ``db_shards`` axes (every placement ``None`` where the rules
    replicate the shard dim or the mesh lacks those axes).  When the
    shard count divides the device count, contiguous shard groups map to
    one device (shard-major order); an uneven count degrades to
    round-robin, logged when shards outnumber devices.  One device owns
    every shard."""
    if _is_mesh(devices):
        axes = db_shard_axes(devices, rules)
        if not axes:
            return [None] * n_shards
        devs = mesh_axis_devices(devices, axes)
    else:
        devs = list(devices)
    if n_shards % len(devs) == 0:
        per = n_shards // len(devs)
        return [devs[i // per] for i in range(n_shards)]
    if n_shards > len(devs):
        logger.warning(
            "shard_placements: %d shards do not divide %d devices; "
            "falling back to round-robin placement", n_shards, len(devs))
    return [devs[i % len(devs)] for i in range(n_shards)]


def local_shard_count(device: torch.device) -> int:
    """Shards of ``index_shards=0``: one per device of the store's
    device type (``torch.cuda.device_count()`` on the card, 1 on the
    CPU)."""
    if device.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1
