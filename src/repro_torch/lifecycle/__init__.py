"""Index lifecycle: the store's life after construction.

Ported so far:

- ``report`` — ``ShardLoadReport``: per-shard live-row / tombstone /
  capacity / query-hit skew, collected passively from the store's
  counters (the ``load`` section of ``RAGPipeline.index_report``).
- ``reshard`` — ``ReshardPlan`` + ``ShardMigration`` + ``Resharder``,
  which change ``n_shards`` on a live store by replaying its alive rows
  out of the device buffers into a freshly-routed staging store,
  installed with one atomic epoch swap (``EraRAG.reshard``, and
  ``from_state`` with a disagreeing shard count).

The policy that triggers a migration from ``refresh()`` and the
snapshot manager are not ported yet (ROADMAP.md, queue 1: "6. Lifecycle
and checkpoint"); attaching a policy raises.
"""
from repro_torch.lifecycle.report import ShardLoad, ShardLoadReport
from repro_torch.lifecycle.reshard import ReshardPlan, Resharder, \
    ShardMigration

__all__ = ["ReshardPlan", "Resharder", "ShardLoad", "ShardLoadReport",
           "ShardMigration"]
