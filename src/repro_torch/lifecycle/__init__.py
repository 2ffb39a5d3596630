"""Index lifecycle management: the store's life after construction.

EraRAG's promise is that the index survives corpus growth without full
reconstruction, but growth also skews: hash routing balances
statistically, and a skewed corpus (or heavy summary churn) can
hot-spot one shard long after the build.  This package owns everything
that happens to the index once it is serving:

- ``report``  — ``ShardLoadReport``: per-shard live-row / tombstone /
  capacity / query-hit skew, collected passively from the store's
  counters (safe to build from inside ``refresh()``).
- ``reshard`` — ``ReshardPlan`` + ``ShardMigration`` + ``Resharder``:
  change ``n_shards`` on a live store by replaying its alive rows out
  of the device buffer into a freshly-routed staging store, built one
  target shard at a time and installed with one atomic epoch swap, so
  ``search_batch`` keeps serving the old epoch mid-migration.
- ``policy``  — ``LifecyclePolicy``: the trigger (skew and
  tombstone-fraction thresholds from ``EraRAGConfig``) that an explicit
  ``refresh()`` consults to schedule a migration, advancing it one
  target shard per call.
- ``manager`` — ``LifecycleManager``: epoch-versioned snapshots through
  ``checkpoint.CheckpointManager``, including the staged shards of a
  half-finished migration, so a restored store can resume (or replay)
  it.

Explicit control lives on the facade: ``EraRAG.reshard(n_shards)`` runs
a synchronous migration; ``ShardedVectorStore.from_state`` routes
snapshot/config shard-count disagreements through the same replay.
"""
from repro_torch.lifecycle.manager import LifecycleManager
from repro_torch.lifecycle.policy import LifecyclePolicy
from repro_torch.lifecycle.report import ShardLoad, ShardLoadReport
from repro_torch.lifecycle.reshard import ReshardPlan, Resharder, \
    ShardMigration

__all__ = [
    "LifecycleManager",
    "LifecyclePolicy",
    "ReshardPlan",
    "Resharder",
    "ShardLoad",
    "ShardLoadReport",
    "ShardMigration",
]
