"""Epoch-versioned index snapshots: crash-safe lifecycle state.

``LifecycleManager`` ties the lifecycle loop to durable storage through
``checkpoint.CheckpointManager`` (atomic rename, async writer, blake2
digests, keep-last-k rotation), in the JAX package's layout, so a
snapshot taken by either package restores in the other:

- ``snapshot()`` persists the store's buffers AND, when a reshard
  migration is in flight, its staged target shards, so a crash
  mid-migration loses at most the shard being built.
- ``restore()`` rebuilds the store (through ``store_from_state``, so a
  snapshot/config shard-count disagreement reshards on load) and, when
  the snapshot carried a half-finished migration, RESUMES it from the
  persisted staged shards (``resume=True``) or replays it from scratch
  (``resume=False``); the refresh loop then finishes it exactly as if
  the process had never died.

As in the JAX package, a snapshot holds no ``"quant"`` entry: a
quantized store restores exact unless the caller passes
``quantized=True`` and the scan settings in ``store_kw``.

A store on a process group snapshots from every rank (``state_dict``
gathers the rows) but only rank 0 writes, and every rank learns the
step it wrote; a snapshot restores under a group of any size, or under
none, as the JAX package's restores under any mesh.

Snapshot steps are monotone; each manifest records the index epoch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager, \
    load_checkpoint, load_manifest
from repro_torch.core.store import AnyStore, store_from_state
from repro_torch.lifecycle.report import ShardLoadReport
from repro_torch.lifecycle.reshard import ReshardPlan, ShardMigration


def _shard_tree(sh_state: dict) -> Dict[str, np.ndarray]:
    """Checkpoint-able (pure-ndarray) form of one shard's state."""
    ids = sh_state["row_ids"]
    return {
        "buf": np.asarray(sh_state["buf"], np.float32),
        "row_ids": np.asarray(ids) if len(ids)
        else np.zeros((0,), dtype="<U1"),
        "row_layers": np.asarray(sh_state["row_layers"], np.int32),
        "row_seq": np.asarray(sh_state["row_seq"], np.int64),
        "alive": np.asarray(sh_state["alive"], bool),
    }


def _tree_shard(tree: Dict[str, np.ndarray]) -> dict:
    return {
        "buf": np.asarray(tree["buf"], np.float32),
        "row_ids": [str(i) for i in tree["row_ids"]],
        "row_layers": np.asarray(tree["row_layers"], np.int32),
        "row_seq": np.asarray(tree["row_seq"], np.int64),
        "alive": np.asarray(tree["alive"], bool),
    }


_SHARD_TEMPLATE = {"buf": 0, "row_ids": 0, "row_layers": 0,
                   "row_seq": 0, "alive": 0}


class LifecycleManager:
    """Owns a store's durable lifecycle state (see module docstring).

    ``policy`` (optional) is attached to the store so its refresh loop
    starts and advances migrations; the manager itself only persists
    and restores."""

    def __init__(self, store: AnyStore, path, *, keep: int = 3,
                 policy=None):
        self.store = store
        self.ckpt = CheckpointManager(Path(path), keep=keep)
        if policy is not None:
            store.attach_lifecycle(policy)

    # ------------------------------------------------------------------
    def report(self) -> ShardLoadReport:
        return ShardLoadReport.from_store(self.store)

    @property
    def _group(self):
        return getattr(self.store, "group", None)

    def wait(self) -> None:
        """Join the async checkpoint writer (re-raises its error); over
        a group, every rank returns once rank 0's write is on disk."""
        self.ckpt.wait()
        if self._group is not None:
            self._group.barrier()

    def snapshot(self, block: bool = False) -> int:
        """Persist the store (and any in-flight migration's staged
        shards); async by default: ``wait()`` to join."""
        store = self.store
        state = store.state_dict()
        flat = state["kind"] == "flat"
        tree: Dict[str, Any] = {
            "shards": [_shard_tree(s) for s in
                       ([state["shard"]] if flat else state["shards"])]
        }
        extra: Dict[str, Any] = {
            "kind": state["kind"],
            "version": int(state["version"]),
            "next_seq": int(state["next_seq"]),
            "n_shards": int(state.get("n_shards", 1)),
            "epoch": int(store.epoch),
        }
        mig = store.migration
        if mig is not None:
            mig_state = mig.state_dict()
            extra["migration"] = {"plan": mig_state["plan"],
                                  "built": len(mig_state["built"])}
            tree["migration"] = [_shard_tree(s)
                                 for s in mig_state["built"]]
        group = self._group
        if group is not None and group.rank != 0:
            return self._rank0_step(group, None)
        # join any in-flight async write FIRST: its step is not on disk
        # yet, and numbering the next step without it would land two
        # snapshots on one step, the first silently overwritten
        self.ckpt.wait()
        step = (self.ckpt.latest_step() or 0) + 1
        if block:
            self.ckpt.save(step, tree, extra)
        else:
            self.ckpt.save_async(step, tree, extra)
        return step if group is None else self._rank0_step(group, step)

    @staticmethod
    def _rank0_step(group, step: Optional[int]) -> int:
        """Rank 0's snapshot step, on every rank of ``group``."""
        got = torch.tensor([-1 if step is None else step],
                           dtype=torch.int64, device=group.device)
        return int(group.broadcast(got, 0).item())

    # ------------------------------------------------------------------
    def restore(self, graph, *, group=None, device=None,
                step: Optional[int] = None,
                n_shards: Optional[int] = None, resume: bool = True,
                **store_kw) -> AnyStore:
        """Rebuild the store from the latest (or given) snapshot, on
        ``group``'s ranks when given, else on ``device`` (None: the
        managed store's device).  Over a group, call ``wait()`` after
        the snapshot and before the restore, so rank 0's write is on
        disk for every rank.

        ``n_shards`` (None = keep the snapshot layout) reshards on load;
        a persisted half-finished migration is re-staged and resumed
        from its built shards (``resume=True``) or replayed from scratch;
        either way the refresh loop finishes and installs it."""
        # the manifest first, to size the template (no array reads or
        # digest work until the real load below)
        _, extra = load_manifest(self.ckpt.path, step)
        flat = extra["kind"] == "flat"
        n_snap = 1 if flat else int(extra["n_shards"])
        mig_meta = extra.get("migration")
        template = {"shards": [dict(_SHARD_TEMPLATE)
                               for _ in range(n_snap)]}
        if mig_meta:
            template["migration"] = [dict(_SHARD_TEMPLATE)
                                     for _ in range(int(mig_meta["built"]))]
        _, tree, _ = load_checkpoint(self.ckpt.path, step,
                                     template=template)
        shard_states = [_tree_shard(t) for t in tree["shards"]]
        state: Dict[str, Any] = {
            "kind": extra["kind"],
            "version": int(extra["version"]),
            "next_seq": int(extra["next_seq"]),
        }
        if flat:
            state["shard"] = shard_states[0]
        else:
            state["n_shards"] = n_snap
            state["shards"] = shard_states
        if group is not None:
            device = group.device
        elif device is None:
            device = self.store.device
        store = store_from_state(state, graph, group=group, device=device,
                                 n_shards=n_shards, **store_kw)
        store.epoch = int(extra.get("epoch", 0))
        if mig_meta and hasattr(store, "install_epoch"):
            built = [_tree_shard(t)
                     for t in tree.get("migration", [])] \
                if resume else []
            store._migration = ShardMigration(
                store, ReshardPlan(**mig_meta["plan"]), group=group,
                built_states=built)
        # carry the attached policy over to the restored store (a new
        # object: store_from_state always constructs a fresh one)
        policy = getattr(self.store, "_policy", None)
        if policy is not None:
            store.attach_lifecycle(policy)
        self.store = store
        return store
