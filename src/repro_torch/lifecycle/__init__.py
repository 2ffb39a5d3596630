"""Index lifecycle: the store's life after construction.

Ported so far: ``reshard`` — ``ReshardPlan`` + ``ShardMigration`` +
``Resharder``, which change ``n_shards`` on a live store by replaying its
alive rows out of the device buffers into a freshly-routed staging
store, installed with one atomic epoch swap (``EraRAG.reshard``, and
``from_state`` with a disagreeing shard count).  The load reports, the
policy that triggers a migration from ``refresh()`` and the snapshot
manager are not ported yet (ROADMAP.md, queue 1: lifecycle and
checkpoint); attaching a policy raises.
"""
from repro_torch.lifecycle.reshard import ReshardPlan, Resharder, \
    ShardMigration

__all__ = ["ReshardPlan", "Resharder", "ShardMigration"]
