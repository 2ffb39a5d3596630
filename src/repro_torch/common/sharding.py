"""The placement rules of the sharded store's stacked buffer.

The JAX package lays the stacked ``(S, cap, d + F)`` buffer over the
``db_shards`` axes of a device mesh (``common/sharding.py`` there).  The
port serves one device per store, so it keeps only the two rules the
store needs, over a plain list of devices: how many slots a shard count
takes (``padded_slot_count``) and which device owns each shard
(``shard_placements``).  No mesh object is ported.
"""
from __future__ import annotations

import logging
from typing import List, Sequence

import torch

logger = logging.getLogger(__name__)


def padded_slot_count(n_shards: int, n_devices: int) -> int:
    """Slot count for a stacked shard buffer: the smallest multiple of
    the device count that fits ``n_shards`` (extra slots stay empty,
    their rows dead-flagged)."""
    return -(-int(n_shards) // int(n_devices)) * int(n_devices)


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
