"""The placement rules of the sharded store's stacked buffer.

The JAX package lays the stacked ``(S, cap, d + F)`` buffer over the
``db_shards`` axes of a device mesh (``common/sharding.py`` there).  The
port lays it over the ranks of a process group (``launch/mesh.py``'s
``DataGroup``) instead, and keeps the rules the store needs: the size of
the shard axis (``db_axis_size``: the group's ranks), how many slots a
shard count takes (``padded_slot_count``: slots are padded, never
ranks), which slots a rank holds (``stacked_slot_range``: contiguous,
shard-major) and which device owns each shard of a store on one device
(``shard_placements``).  The logical-rule engine is not ported here.
"""
from __future__ import annotations

import logging
from typing import List, Sequence

import torch

logger = logging.getLogger(__name__)


def db_axis_size(group=None) -> int:
    """Ranks along the store's shard axis: the group's size, 1 without
    a group."""
    return 1 if group is None else int(group.world_size)


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


def shard_placements(devices: Sequence[torch.device],
                     n_shards: int) -> List[torch.device]:
    """Owning device per shard id.  When the shard count divides the
    device count, contiguous shard groups map to one device (shard-major
    order); an uneven count degrades to round-robin, logged when shards
    outnumber devices.  One device owns every shard."""
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
