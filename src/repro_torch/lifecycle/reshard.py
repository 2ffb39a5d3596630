"""Live resharding: replay the index into a new shard count without a
rebuild, behind an atomic epoch swap.

The migration never touches the serving store until commit:

1. **Plan** (``ReshardPlan``): target shard count + the graph/store
   version the row snapshot reflects.
2. **Stage** (``ShardMigration``): the store's alive rows are captured
   to host ONCE (``export_rows``: embeddings + flag columns straight out
   of the stacked device buffer, global-sequence order, no
   re-embedding), routed to their target shards in one bulk pass, and
   loaded into a fresh staging ``ShardedVectorStore`` one target shard
   per ``step()``.
3. **Commit** (``install``): one atomic epoch swap
   (``ShardedVectorStore.install_epoch``).  Queries issued before the
   swap served the old epoch's buffers unchanged; the delta-log tail the
   old epoch absorbed mid-migration is replayed into the new epoch at
   the next refresh (the install rewinds the store version to the plan
   version).

Because the replay preserves each row's float content and relative
global-sequence order, the resharded store's search results are
bitwise identical to a store freshly built at the target shard count.

A store's lifecycle policy (``attach_lifecycle``) starts migrations
from ``refresh()``, which then drives one ``step()`` per call and the
install.  A store on a process group builds its staging store on the
same group (each rank loading its own target slots from the gathered
rows), so every rank installs the same epoch.  ``Resharder`` runs a whole migration at once
(``EraRAG.reshard``), pre-empting any policy migration in flight, and
is the snapshot replayer (``from_state`` with a disagreeing shard
count).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.store import AnyStore, ShardedVectorStore, \
    VectorStore, pack_export_rows


@contextlib.contextmanager
def _policy_suspended(store: AnyStore):
    """Detach the store's lifecycle policy for the duration: refreshes
    inside an explicit reshard must not schedule competing
    migrations."""
    policy, store._policy = store._policy, None
    try:
        yield
    finally:
        store._policy = policy


@dataclass(frozen=True)
class ReshardPlan:
    """One migration's contract: ``n_from`` -> ``n_to`` shards over the
    row snapshot taken at store/graph ``version``."""

    n_from: int
    n_to: int
    version: int
    n_rows: int
    reason: str = ""

    def to_dict(self) -> dict:
        return {"n_from": self.n_from, "n_to": self.n_to,
                "version": self.version, "n_rows": self.n_rows,
                "reason": self.reason}


def _shard_state(rows: Dict[str, np.ndarray],
                 idx: np.ndarray) -> dict:
    """``_Shard.load_state`` payload for one target shard's subset of
    the row snapshot (replayed rows are all alive by construction)."""
    return {
        "buf": rows["rows"][idx],
        "row_ids": rows["ids"][idx].tolist(),
        "row_layers": rows["layers"][idx],
        "row_seq": rows["seqs"][idx],
        "alive": np.ones(len(idx), bool),
    }


def rows_from_state(state: dict, dim: int) -> Dict[str, np.ndarray]:
    """Alive rows (global-sequence order) out of a persisted store
    snapshot: the ``export_rows`` equivalent for ``from_state``."""
    shard_states = state["shards"] if state.get("kind") == "sharded" \
        else [state["shard"]]
    ids: List[str] = []
    layers: List[np.ndarray] = []
    seqs: List[np.ndarray] = []
    rows: List[np.ndarray] = []
    for st in shard_states:
        alive = np.asarray(st["alive"], bool)
        keep = np.nonzero(alive)[0]
        if len(keep) == 0:
            continue
        st_ids = list(st["row_ids"])
        ids.extend(str(st_ids[int(r)]) for r in keep)
        layers.append(np.asarray(st["row_layers"], np.int32)[keep])
        seqs.append(np.asarray(st["row_seq"], np.int64)[keep])
        rows.append(np.asarray(st["buf"], np.float32)[keep])
    return pack_export_rows(ids, layers, seqs, rows, dim)


def _maintenance_kw(src: AnyStore, kw: dict) -> dict:
    """``kw`` with the source store's device, maintenance tuning and
    scan settings filled in where not given: the code plane rides the
    epoch swap (``load_state`` re-hashes the replayed rows)."""
    kw = dict(kw)
    group = kw.get("group")
    kw.setdefault("device", src.device if group is None else group.device)
    kw.setdefault("compact_threshold", src._compact_threshold)
    kw.setdefault("min_capacity", src._group.min_capacity)
    kw.setdefault("quantized", src.quantized)
    kw.setdefault("coarse_mult", src.coarse_mult)
    kw.setdefault("scan_bits", src.scan_bits)
    kw.setdefault("scan_seed", src.scan_seed)
    return kw


class ShardMigration:
    """A staged reshard: the target epoch under construction.

    Holds the host row snapshot, the bulk-routed target owners and the
    staging store; ``step()`` builds ONE target shard; once every shard
    is built, ``install()`` performs the atomic epoch swap into the
    source store, which serves queries from its old epoch, untouched,
    for the whole lifetime of this object.

    ``built_states`` resumes a half-finished migration from persisted
    staged shards (``LifecycleManager.restore``): the target shards
    already built load from the snapshot, the rest replay from the
    source.  The staging store lives on ``group`` when given, else on
    the source store's group (if any)."""

    def __init__(self, store: AnyStore, plan: ReshardPlan, *,
                 group=None, store_kw: Optional[dict] = None,
                 built_states: Optional[List[dict]] = None):
        self.store = store
        self.plan = plan
        self.rows = store.export_rows()
        # one bulk routing pass at the TARGET shard count, attributed
        # to the source store's private routing counters
        self.owners = store._router.many(list(self.rows["ids"]),
                                         plan.n_to)
        self.staging = self._make_staging(group, store_kw or {})
        self.built: List[int] = []
        for sh_state in (built_states or []):
            self.staging._shards[len(self.built)].load_state(sh_state)
            self.built.append(len(self.built))
        if self.done:
            self._finalize()

    def _make_staging(self, group, store_kw: dict) -> ShardedVectorStore:
        src = self.store
        if group is None:
            group = store_kw.get("group", getattr(src, "group", None))
        kw = _maintenance_kw(src, {**store_kw, "group": group})
        if isinstance(src, ShardedVectorStore):
            kw.setdefault("collective", src.collective)
        return ShardedVectorStore(src._graph, n_shards=self.plan.n_to,
                                  **kw)

    @property
    def done(self) -> bool:
        return len(self.built) >= self.staging.n_shards

    def describe(self) -> dict:
        return {"plan": self.plan.to_dict(),
                "built": len(self.built),
                "total": self.staging.n_shards}

    def step(self) -> bool:
        """Build the next target shard from the snapshot; returns True
        while more shards remain."""
        if self.done:
            return False
        s = len(self.built)
        idx = np.nonzero(self.owners == s)[0]
        self.staging._shards[s].load_state(_shard_state(self.rows, idx))
        self.built.append(s)
        if self.done:
            self._finalize()
        return not self.done

    def run(self) -> None:
        while not self.done:
            self.step()

    def _finalize(self) -> None:
        st = self.staging
        st._rebuild_seq_map()
        st._version = self.plan.version
        seqs = self.rows["seqs"]
        st._next_seq = int(seqs[-1]) + 1 if len(seqs) else 0

    def install(self) -> None:
        """Commit: atomic epoch swap into the source store (sharded
        source only; cross-kind callers adopt ``staging`` instead).  The
        store's version rewinds to the plan version so the next refresh
        replays the delta tail into the new epoch."""
        assert self.done, "install() before every shard was built"
        self.store.install_epoch(self.staging)

    def state_dict(self) -> dict:
        """Persistable migration progress: the plan plus the staged
        target shards built so far (the resume payload)."""
        stack = self.staging._group.host_stack()
        return {"plan": self.plan.to_dict(),
                "built": [self.staging._shards[s].state_dict(stack)
                          for s in self.built]}


class Resharder:
    """Synchronous resharding + snapshot replay.

    ``group``, ``device`` and ``store_kw`` parameterize the staging
    store; anything not given is inherited from the source store (its
    group, device, collective flag, compaction threshold, growth floor,
    scan settings)."""

    def __init__(self, group=None, device=None, **store_kw):
        self.group = group
        self.device = device
        self.store_kw = store_kw

    def _kw(self) -> dict:
        kw = dict(self.store_kw)
        if self.group is not None:
            kw["group"] = self.group
            kw["device"] = self.group.device
        if self.device is not None:
            kw["device"] = self.device
        return kw

    # ------------------------------------------------------------------
    def plan(self, store: AnyStore, n_to: int,
             reason: str = "") -> ReshardPlan:
        """Sync the store to its graph, then pin the migration contract
        to that version."""
        store.refresh()
        return ReshardPlan(
            n_from=getattr(store, "n_shards", 1), n_to=int(n_to),
            version=store._version,
            n_rows=sum(sh.count - sh.n_dead for sh in store._shards),
            reason=reason)

    def begin(self, store: AnyStore, n_to: int,
              reason: str = "") -> ShardMigration:
        """Start (but do not install) a migration: the store keeps
        serving its old epoch; drive with ``step()`` and commit with
        ``install()``, or hand it to the store's refresh loop.

        An explicit reshard pre-empts a policy-scheduled migration: one
        already in flight is dropped (the old epoch was never touched),
        and the policy is suspended for the ``plan()`` refresh so that
        it cannot schedule a competing one."""
        store._migration = None
        with _policy_suspended(store):
            plan = self.plan(store, n_to, reason)
        return ShardMigration(store, plan, store_kw=self._kw())

    def reshard(self, store: AnyStore, n_to: int, *,
                flat: Optional[bool] = None,
                reason: str = "explicit") -> AnyStore:
        """Full synchronous migration.  Returns the resharded store: the
        SAME object when the source is sharded and the target is a shard
        count (live references keep working), a new store when the kind
        changes (``n_to == 1`` defaults to the single-buffer
        ``VectorStore``, mirroring ``make_store``)."""
        n_to = int(n_to)
        if n_to < 1:
            raise ValueError(f"n_to must be >= 1, got {n_to}")
        flat = (n_to == 1) if flat is None else flat
        if flat:
            store._migration = None   # explicit reshard preempts
            with _policy_suspended(store):
                store.refresh()
                rows = store.export_rows()
            seqs = rows["seqs"]
            next_seq = max(store._next_seq,
                           int(seqs[-1]) + 1 if len(seqs) else 0)
            out = self._build_flat(store._graph, rows, store._version,
                                   next_seq, source=store)
            # the new store is the NEXT epoch of the same logical index
            out.epoch = store.epoch + 1
            out._store_stats.reshards += 1
            return out
        mig = self.begin(store, n_to, reason)
        mig.run()
        if isinstance(store, ShardedVectorStore):
            mig.install()
            return store
        staging = mig.staging
        staging._next_seq = max(staging._next_seq, store._next_seq)
        staging.epoch = store.epoch + 1
        staging._store_stats.reshards += 1
        return staging

    # ------------------------------------------------------------------
    def replay_state(self, state: dict, graph, n_to: int, *,
                     flat: bool = False) -> AnyStore:
        """Restore a persisted snapshot INTO a different shard count:
        rows replay through the same routing as a live migration, and
        the store resumes at the snapshot's version, so the first
        ``refresh()`` replays only the graph's delta-log tail."""
        rows = rows_from_state(state, graph.cfg.embed_dim)
        version = int(state["version"])
        next_seq = int(state["next_seq"])
        if flat:
            return self._build_flat(graph, rows, version, next_seq)
        staging = ShardedVectorStore(graph, n_shards=int(n_to),
                                     **self._kw())
        owners = staging.owner_many(list(rows["ids"]))
        for s in range(staging.n_shards):
            idx = np.nonzero(owners == s)[0]
            staging._shards[s].load_state(_shard_state(rows, idx))
        staging._rebuild_seq_map()
        staging._version = version
        staging._next_seq = next_seq
        return staging

    def _build_flat(self, graph, rows: Dict[str, np.ndarray],
                    version: int, next_seq: int,
                    source: Optional[AnyStore] = None) -> VectorStore:
        kw = {k: v for k, v in self._kw().items()
              if k in ("device", "compact_threshold", "min_capacity",
                       "quantized", "coarse_mult", "scan_bits",
                       "scan_seed")}
        if source is not None:
            # inherit maintenance tuning from the live source store,
            # exactly like the sharded staging path does
            kw = _maintenance_kw(source, kw)
        store = VectorStore(graph, **kw)
        n = len(rows["ids"])
        if n:
            store._s.load_state(_shard_state(rows, np.arange(n)))
        store._version = version
        store._next_seq = next_seq
        return store
