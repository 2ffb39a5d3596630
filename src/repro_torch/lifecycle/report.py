"""Shard load reports: the observability half of the lifecycle loop.

``ShardLoadReport.from_store`` reads a store's counters PASSIVELY — no
refresh, no device sync — so it is safe to build from anywhere,
including inside ``refresh()`` itself.  It aggregates, per shard: live rows, tombstones,
capacity, staged rows, committed compactions, and the per-shard query
HIT counters the store accumulates on every ``search_batch`` merge —
row-count skew says where the *data* piled up, hit skew says where the
*traffic* lands, and a resharding decision needs both.  The report
also carries the store's private routing-LRU counters (per instance —
they never include another store's traffic) and the state of any
in-flight migration (always None here: no lifecycle policy starts one,
and an explicit ``Resharder.begin`` hands its migration to the caller).

A shard's ``device`` is its placement on the card (``cuda:0``) or the
CPU; the flat store has no placements and reports None.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def _skew(values: np.ndarray) -> float:
    """max/mean ratio; 1.0 for an empty or perfectly even spread."""
    total = float(values.sum())
    if total <= 0 or len(values) == 0:
        return 1.0
    return float(values.max()) / (total / len(values))


@dataclass
class ShardLoad:
    """One shard's load row."""

    shard: int
    rows: int            # live (non-tombstoned) rows
    dead: int            # tombstoned rows awaiting compaction
    capacity: int        # lockstep slot capacity
    staged: int          # rows ever uploaded to this shard
    compactions: int     # committed double-buffer swaps
    query_hits: int      # merged top-k hits served from this shard
    device: Optional[str] = None


@dataclass
class ShardLoadReport:
    """Whole-index health snapshot (see module docstring)."""

    n_shards: int
    epoch: int
    size: int                    # live rows, index-wide
    dead: int                    # tombstoned rows, index-wide
    skew: float                  # max/mean live rows per shard
    query_skew: float            # max/mean per-shard query hits
    tombstone_fraction: float    # dead / (live + dead)
    pending_compaction: Optional[int]
    migration: Optional[dict]    # in-flight reshard, or None
    routing: Dict[str, int]      # this store's routing-LRU counters
    shards: List[ShardLoad]

    @classmethod
    def from_store(cls, store) -> "ShardLoadReport":
        shards = store._shards
        placements = getattr(store, "_placements",
                             [None] * len(shards))
        hits = np.asarray(store.query_hits, np.int64)
        loads = [
            ShardLoad(
                shard=s,
                rows=sh.count - sh.n_dead,
                dead=sh.n_dead,
                capacity=sh.capacity,
                staged=sh.stats.rows_staged,
                compactions=sh.stats.compactions,
                query_hits=int(hits[s]) if s < len(hits) else 0,
                device=str(placements[s])
                if placements[s] is not None else None,
            )
            for s, sh in enumerate(shards)
        ]
        live = np.asarray([ld.rows for ld in loads], np.int64)
        dead = np.asarray([ld.dead for ld in loads], np.int64)
        total = int(live.sum() + dead.sum())
        mig = store.migration
        return cls(
            n_shards=len(shards),
            epoch=int(store.epoch),
            size=int(live.sum()),
            dead=int(dead.sum()),
            skew=_skew(live),
            query_skew=_skew(hits),
            tombstone_fraction=float(dead.sum()) / max(1, total),
            pending_compaction=store.pending_compaction,
            migration=mig.describe() if mig is not None else None,
            routing=store.routing_cache_info(),
            shards=loads,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
