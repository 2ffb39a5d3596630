"""Lifecycle triggers: when should the index reshard itself?

``LifecyclePolicy`` is the pluggable decision function the store's
explicit ``refresh()`` consults (``attach_lifecycle``): given the
current ``ShardLoadReport`` it either returns a ``ReshardPlan`` (the
refresh loop then builds the staged epoch one target shard per call
and commits it with an atomic swap) or ``None``.  Two triggers, both
threshold-gated through ``EraRAGConfig`` (0.0 disables):

- **live-row skew** (``max/mean`` rows per shard): a hot-spotted shard
  grows the shard count by ``growth_factor`` (capped at
  ``max_shards``), re-spreading the row set.
- **tombstone fraction** (index-wide dead/total): heavy churn replays
  the index at the SAME shard count: a whole-index compaction through
  the migration path, off the query path.

``min_rows`` keeps toy indexes from reacting to statistical noise.
Subclass and override ``decide`` for custom triggers (query-hit skew,
capacity watermarks, autoscaling signals: the report carries them
all).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.lifecycle.report import ShardLoadReport
from repro_torch.lifecycle.reshard import ReshardPlan


@dataclass
class LifecyclePolicy:
    skew_threshold: float = 0.0        # max/mean live rows; 0 = off
    tombstone_threshold: float = 0.0   # dead fraction; 0 = off
    min_rows: int = 256                # ignore toy indexes
    growth_factor: int = 2             # shard-count growth per trigger
    max_shards: int = 64               # growth ceiling

    @classmethod
    def from_config(cls, cfg) -> Optional["LifecyclePolicy"]:
        """Policy from ``EraRAGConfig`` thresholds; None when both
        triggers are disabled (nothing to attach)."""
        if cfg.reshard_skew_threshold <= 0 \
                and cfg.reshard_tombstone_threshold <= 0:
            return None
        return cls(skew_threshold=cfg.reshard_skew_threshold,
                   tombstone_threshold=cfg.reshard_tombstone_threshold,
                   min_rows=cfg.reshard_min_rows,
                   growth_factor=cfg.reshard_growth_factor,
                   max_shards=cfg.reshard_max_shards)

    def decide(self, store) -> Optional[ReshardPlan]:
        """Called by ``refresh()`` with the store version-synced; must
        read PASSIVELY (no refresh: we are inside one)."""
        if not hasattr(store, "install_epoch"):
            return None   # only sharded stores migrate in place
        n = store.n_shards
        report = ShardLoadReport.from_store(store)
        if report.size < self.min_rows:
            return None
        if self.skew_threshold > 0 and n < self.max_shards \
                and report.skew > self.skew_threshold:
            return ReshardPlan(
                n_from=n,
                n_to=min(self.max_shards, n * self.growth_factor),
                version=store._version, n_rows=report.size,
                reason=f"live-row skew {report.skew:.2f} > "
                       f"{self.skew_threshold:.2f}")
        if self.tombstone_threshold > 0 \
                and report.tombstone_fraction > self.tombstone_threshold:
            return ReshardPlan(
                n_from=n, n_to=n,
                version=store._version, n_rows=report.size,
                reason=f"tombstone fraction "
                       f"{report.tombstone_fraction:.2f} > "
                       f"{self.tombstone_threshold:.2f}")
        return None
