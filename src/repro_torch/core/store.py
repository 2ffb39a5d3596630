"""Incremental, device-resident flat index (the single-buffer store).

Mirrors the FAISS IndexFlat role in the paper, implemented on the
``mips_topk`` kernel, but maintained *incrementally*: instead of
re-stacking every embedding after each graph version bump (O(N) host
work per insert), the store consumes the graph's per-version
``(added_ids, removed_ids)`` deltas — new rows are appended into a
preallocated, geometrically-grown device buffer and removed rows are
tombstoned in place.  Tombstones are masked at query time through the
buffer's trailing indicator columns (``[emb | dead | summary | leaf]``)
plus a per-query bias vector (``flagged_mips_topk``), which also serves
layer filtering without any host-side row gathering.  When tombstones
exceed ``compact_threshold`` of the buffer the store compacts it with
one on-device gather, preserving row order so top-k tie-breaking stays
bitwise-identical to a from-scratch rebuild.

Device buffer.  The JAX package rebuilds its buffer functionally
(``dynamic_update_slice`` / ``.at[].set`` return new arrays); here the
same writes are IN-PLACE slice writes on one device tensor: appends
copy a host block into ``buf[row0:row0 + m]``, tombstones set
``buf[rows, d + DEAD] = 1`` in place.  Two operations still allocate:
growth reallocates at twice the capacity and copies the old rows over,
and compaction gathers the live rows into a NEW tensor (the double
buffer) that replaces the old one only at the next refresh, so a query
issued in between never depends on the gather.  The buffer keeps its
ragged ``d + 3`` width (259 floats at d = 256): the kernel takes any
row width, so ``state_dict`` reads back exactly
``[emb | dead | summary | leaf]``.  Padding rows past the staged prefix
carry the dead flag, so ``MASK_BIAS`` excludes them for free.

Compaction is OFF the query path: ``refresh()`` commits a previously
scheduled compaction and schedules at most one new one; ``compact()``
is the forced, flush-everything escape hatch.  ``stats`` counts
refreshes, staged rows, tombstones and compactions; the store
serializes with ``state_dict``/``from_state`` (the JAX package's flat
snapshot dict is accepted as is) and, paired with the graph's persisted
delta-log tail, a restored store resumes incrementally instead of
paying a full O(N) re-stack.

Not served yet: the sharded store, the two-stage quantized scan and
live resharding (a lifecycle policy) raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import not_ported
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.mips_topk.ops import MASK_BIAS, flagged_mips_topk
from repro_torch.obs.trace import NULL_TRACER

# trailing indicator columns of the device buffer
N_FLAGS = 3
_DEAD, _SUMMARY, _LEAF = 0, 1, 2

# sequence number of rows past the staged prefix; the monotone global
# counter is renumbered (host metadata only, order-preserving) before it
# can reach it, keeping every sequence number within int32
_SEQ_PAD = np.int64(2**31 - 1)
_SEQ_LIMIT = 2**31 - 2**16


@dataclass
class Hit:
    node_id: str
    score: float
    layer: int
    # global insertion-order sequence of the row that scored this hit:
    # the deterministic tie-break (matching the kernel-side
    # lowest-index rule) when callers combine hits from separate scans
    # whose scores collide
    seq: int = -1


@dataclass
class StoreStats:
    """Instrumented refresh counters (O(delta) maintenance evidence).

    Field for field the JAX package's ``StoreStats``; the routing,
    reshard and quantized counters stay 0 on the flat store."""

    refreshes: int = 0
    full_rebuilds: int = 0
    rows_staged: int = 0       # host rows uploaded to the device buffer
    rows_tombstoned: int = 0
    compactions: int = 0       # committed double-buffer swaps
    compactions_skipped: int = 0
    rows_compacted: int = 0
    growths: int = 0
    route_hits: int = 0
    route_misses: int = 0
    bulk_routed: int = 0
    reshards: int = 0
    reshard_steps: int = 0
    quantized_scans: int = 0
    # scans issued by THIS store's query path (per-instance twin of the
    # process-global kernel launch counter in kernels/mips_topk/ops)
    kernel_launches: int = 0


class _DeviceBuffer:
    """Device side of the flat store: ONE ``(cap, d + N_FLAGS)`` fp32
    tensor on ``device``, grown geometrically, with padding rows
    pre-flagged dead.  Every mutation below is an in-place write on
    that tensor except growth (reallocate + copy) and compaction (a new
    tensor, swapped in by ``commit_compacted``)."""

    def __init__(self, dim: int, device: torch.device, *,
                 min_capacity: int = 64,
                 stats: Optional[StoreStats] = None):
        self.dim = int(dim)
        self.device = device
        self.min_capacity = int(min_capacity)
        self.stats = stats if stats is not None else StoreStats()
        self.reset()

    def reset(self) -> None:
        self.capacity = 0
        self.buf: Optional[torch.Tensor] = None

    def _empty(self, cap: int) -> torch.Tensor:
        buf = torch.zeros((cap, self.dim + N_FLAGS), dtype=torch.float32,
                          device=self.device)
        buf[:, self.dim + _DEAD] = 1.0
        return buf

    def ensure(self, need: int) -> None:
        """Geometric growth: reallocate at the next power-of-two
        multiple of the capacity and copy the old rows over."""
        if need <= self.capacity:
            return
        cap = max(self.min_capacity, self.capacity)
        while cap < need:
            cap *= 2
        buf = self._empty(cap)
        if self.buf is not None:
            buf[:self.capacity].copy_(self.buf)
        self.buf = buf
        self.capacity = cap
        self.stats.growths += 1

    def write_rows(self, row0: int, block: np.ndarray) -> None:
        """In place: ``buf[row0:row0 + m] = block`` (host -> device)."""
        m = block.shape[0]
        self.buf[row0:row0 + m].copy_(torch.from_numpy(block))

    def mark_dead(self, rows: np.ndarray) -> None:
        """In place: set the dead flag of ``rows``."""
        idx = torch.as_tensor(np.asarray(rows, np.int64),
                              device=self.device)
        self.buf[idx, self.dim + _DEAD] = 1.0

    def compact_gather(self, keep: np.ndarray) -> torch.Tensor:
        """The order-preserving gather of ``keep`` rows into a NEW
        tensor (the double buffer); ``buf`` is untouched until
        ``commit_compacted`` swaps it in."""
        out = self._empty(self.capacity)
        idx = torch.as_tensor(np.asarray(keep, np.int64),
                              device=self.device)
        out[:len(keep)] = self.buf[idx]
        return out

    def commit_compacted(self, compacted: torch.Tensor) -> None:
        self.buf = compacted

    def read_rows(self, n: int) -> np.ndarray:
        if n == 0:
            return np.zeros((0, self.dim + N_FLAGS), np.float32)
        # a copy on every device (a CPU tensor's .numpy() would alias)
        return self.buf[:n].to("cpu", copy=True).numpy()


class _Shard:
    """Host metadata + maintenance for the device buffer: id <-> row
    maps, layers, global sequence numbers, alive bits.  Each row
    carries a global sequence number (node-creation order), the
    tie-break hits carry as ``Hit.seq``."""

    def __init__(self, dim: int, group: _DeviceBuffer, *,
                 stats: Optional[StoreStats] = None):
        self.dim = dim
        self.group = group
        self.stats = stats if stats is not None else StoreStats()
        self.reset()

    def reset(self) -> None:
        self.count = 0              # rows in use, tombstones included
        self.n_dead = 0
        self.row_ids: List[str] = []
        self.row_layers = np.zeros((0,), np.int32)
        self.row_seq = np.zeros((0,), np.int64)  # global order
        self.alive = np.zeros((0,), bool)
        self.row_of: Dict[str, int] = {}
        self.n_alive = {"leaf": 0, "summary": 0}

    @property
    def capacity(self) -> int:
        return self.group.capacity

    @property
    def buf(self) -> torch.Tensor:
        """The (cap, d+F) device buffer the scan reads."""
        return self.group.buf

    def _grow_host(self, need: int) -> None:
        have = len(self.row_layers)
        if need <= have:
            return
        n = max(self.group.min_capacity, have)
        while n < need:
            n *= 2
        pad = n - have
        self.row_layers = np.concatenate(
            [self.row_layers, np.zeros((pad,), np.int32)])
        self.row_seq = np.concatenate(
            [self.row_seq, np.full((pad,), _SEQ_PAD, np.int64)])
        self.alive = np.concatenate(
            [self.alive, np.zeros((pad,), bool)])

    def append(self, nodes: dict, ids: Sequence[str],
               seqs: Sequence[int]) -> None:
        """Stage ``len(ids)`` new rows — the only host->device copy on
        the incremental path, O(delta) not O(N)."""
        if not ids:
            return
        m = len(ids)
        d = self.dim
        self.group.ensure(self.count + m)
        self._grow_host(self.count + m)
        block = np.zeros((m, d + N_FLAGS), np.float32)
        for j, (nid, seq) in enumerate(zip(ids, seqs)):
            node = nodes[nid]
            block[j, :d] = node.embedding
            cls = "summary" if node.layer > 0 else "leaf"
            block[j, d + (_SUMMARY if node.layer > 0 else _LEAF)] = 1.0
            row = self.count + j
            self.row_ids.append(nid)
            self.row_layers[row] = node.layer
            self.row_seq[row] = seq
            self.alive[row] = True
            self.row_of[nid] = row
            self.n_alive[cls] += 1
        self.group.write_rows(self.count, block)
        self.count += m
        self.stats.rows_staged += m

    def tombstone(self, ids: Sequence[str]) -> None:
        """Flag rows dead in place."""
        rows = []
        for nid in ids:
            row = self.row_of.pop(nid, None)
            if row is None or not self.alive[row]:
                continue
            self.alive[row] = False
            cls = "summary" if self.row_layers[row] > 0 else "leaf"
            self.n_alive[cls] -= 1
            rows.append(row)
        if rows:
            self.group.mark_dead(np.asarray(rows, np.int64))
            self.n_dead += len(rows)
            self.stats.rows_tombstoned += len(rows)

    # -- compaction: schedule (gather into double buffer) / commit ----
    def schedule_compact(self) -> Tuple[np.ndarray, torch.Tensor]:
        """Dispatch the order-preserving gather of live rows into a
        double buffer; the swap happens at ``commit_compact`` (the next
        refresh), so no query issued in between depends on it."""
        keep = np.nonzero(self.alive[:self.count])[0]
        return keep, self.group.compact_gather(keep)

    def commit_compact(self, keep: np.ndarray,
                       compacted: torch.Tensor) -> None:
        self.group.commit_compacted(compacted)
        n = len(keep)
        self.row_ids = [self.row_ids[i] for i in keep]
        size = len(self.row_layers)
        layers = np.zeros((size,), np.int32)
        layers[:n] = self.row_layers[keep]
        self.row_layers = layers
        seqs = np.full((size,), _SEQ_PAD, np.int64)
        seqs[:n] = self.row_seq[keep]
        self.row_seq = seqs
        alive = np.zeros((size,), bool)
        alive[:n] = True
        self.alive = alive
        self.row_of = {nid: i for i, nid in enumerate(self.row_ids)}
        self.count = n
        self.n_dead = 0
        self.stats.compactions += 1
        self.stats.rows_compacted += n

    def compact_now(self) -> None:
        """Forced, inline compaction (``compact()`` escape hatch)."""
        keep, compacted = self.schedule_compact()
        self.commit_compact(keep, compacted)

    def valid_count(self, layer_filter: Optional[str]) -> int:
        if layer_filter == "leaf":
            return self.n_alive["leaf"]
        if layer_filter == "summary":
            return self.n_alive["summary"]
        return self.n_alive["leaf"] + self.n_alive["summary"]

    def state_dict(self) -> dict:
        return {
            "buf": self.group.read_rows(self.count),
            "row_ids": list(self.row_ids),
            "row_layers": self.row_layers[:self.count].copy(),
            "row_seq": self.row_seq[:self.count].copy(),
            "alive": self.alive[:self.count].copy(),
        }

    def load_state(self, state: dict) -> None:
        self.reset()
        ids = list(state["row_ids"])
        n = len(ids)
        if not n:
            return
        # a private writable copy (snapshot arrays may be read-only)
        buf = np.array(state["buf"], np.float32)
        if buf.shape != (n, self.dim + N_FLAGS):
            raise ValueError(
                f"snapshot buffer is {buf.shape}, store expects "
                f"({n}, {self.dim + N_FLAGS}) — embed_dim mismatch or "
                f"truncated state")
        self.group.ensure(n)
        self._grow_host(n)
        self.row_ids = ids
        layers = np.asarray(state["row_layers"], np.int32)
        self.row_layers[:n] = layers
        self.row_seq[:n] = np.asarray(state["row_seq"], np.int64)
        self.group.write_rows(0, buf)
        alive = np.asarray(state["alive"], bool)
        self.alive[:n] = alive
        self.count = n
        self.n_dead = int(n - alive.sum())
        live = np.nonzero(alive)[0]
        self.row_of = {ids[int(r)]: int(r) for r in live}
        n_sum = int(np.count_nonzero(layers[live] > 0))
        self.n_alive = {"summary": n_sum, "leaf": len(live) - n_sum}


def _filter_bias(layer_filter: Optional[str]) -> Tuple[float, ...]:
    return (MASK_BIAS,
            MASK_BIAS if layer_filter == "leaf" else 0.0,
            MASK_BIAS if layer_filter == "summary" else 0.0)


def _check_queries(queries: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(queries, dtype=np.float32)
    if q.ndim != 2:
        raise ValueError(f"queries must be (B, d), got {q.shape}")
    return q


class _BaseStore:
    """Delta-replay orchestration: stale-resurrection handling,
    per-version replay, threshold compaction off the query path, and
    rebuild.  Subclasses define the shard set (``self._shards``) and the
    owner of an id (``owner``)."""

    _shards: List[_Shard]
    _store_stats: StoreStats       # refresh / rebuild counters

    # span recorder for the query path; the owning EraRAG swaps in its
    # Observability tracer — the class-level default keeps standalone
    # stores on the inert no-op path
    tracer = NULL_TRACER

    def __init__(self, graph, compact_threshold: float):
        self._graph = graph
        self._version = -1          # graph version the index reflects
        self._next_seq = 0          # global row insertion order
        self._compact_threshold = float(compact_threshold)
        # double-buffered compaction state
        self._pending: Optional[Tuple[int, np.ndarray, torch.Tensor]] = \
            None
        self._compact_rr = 0
        # committed reshard migrations bump the epoch; the flat store
        # never reshards, so it stays 0
        self.epoch = 0
        self.query_hits = np.zeros(1, np.int64)

    def owner(self, node_id: str) -> int:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def _append(self, ids: Sequence[str]) -> None:
        if not ids:
            return
        if self._next_seq + len(ids) >= _SEQ_LIMIT:
            self._renumber_seqs()
        nodes = self._graph.nodes
        buckets: Dict[int, Tuple[List[str], List[int]]] = {}
        for nid in ids:
            b_ids, b_seqs = buckets.setdefault(self.owner(nid), ([], []))
            b_ids.append(nid)
            b_seqs.append(self._next_seq)
            self._next_seq += 1
        for s, (b_ids, b_seqs) in buckets.items():
            self._shards[s].append(nodes, b_ids, b_seqs)

    def _renumber_seqs(self) -> None:
        """Compact the global sequence numbers to 0..n_rows-1,
        preserving order (once per ~2^31 lifetime appends)."""
        rows = [(int(sh.row_seq[r]), sh, r)
                for sh in self._shards for r in range(sh.count)]
        rows.sort(key=lambda t: t[0])
        for new_seq, (_, sh, r) in enumerate(rows):
            sh.row_seq[r] = new_seq
        self._next_seq = len(rows)

    def _tombstone(self, ids: Sequence[str]) -> None:
        buckets: Dict[int, List[str]] = {}
        for nid in ids:
            buckets.setdefault(self.owner(nid), []).append(nid)
        for s, b_ids in buckets.items():
            self._shards[s].tombstone(b_ids)

    def _apply_delta(self, added: Sequence[str],
                     removed: Sequence[str]) -> None:
        self._tombstone(removed)
        # a re-added id (content-addressed resurrection) must move to
        # the buffer tail so row order keeps tracking the graph's node
        # insertion order (exact tie-break parity with a rebuild)
        stale = [nid for nid in added
                 if nid in self._shards[self.owner(nid)].row_of]
        if stale:
            self._tombstone(stale)
        self._append([nid for nid in added if nid in self._graph.nodes])

    def _full_rebuild(self) -> None:
        self._pending = None   # stale double buffer: drop, never swap
        for sh in self._shards:
            sh.group.reset()
            sh.reset()
        self._next_seq = 0
        self._store_stats.full_rebuilds += 1
        self._append(list(self._graph.nodes))

    def _commit_pending_compaction(self) -> None:
        if self._pending is None:
            return
        s, keep, compacted = self._pending
        self._pending = None
        self._shards[s].commit_compact(keep, compacted)

    def _schedule_threshold_compaction(self) -> None:
        """Schedule at most ONE over-threshold shard per refresh
        (round-robin rotation); the rest are deferred to later turns
        and surfaced in ``StoreStats.compactions_skipped``."""
        thresh = self._compact_threshold
        over = [i for i, sh in enumerate(self._shards)
                if sh.count and sh.n_dead > thresh * sh.count]
        if not over:
            return
        n = len(self._shards)
        pick = min(over, key=lambda i: (i - self._compact_rr) % n)
        self._compact_rr = (pick + 1) % n
        self._store_stats.compactions_skipped += len(over) - 1
        keep, compacted = self._shards[pick].schedule_compact()
        self._pending = (pick, keep, compacted)

    def _refresh(self, force_commit: bool = False) -> None:
        g = self._graph
        if self._version == g.version and not force_commit:
            # version-synced queries take this hot path: they never
            # commit (or depend on) a staged compaction
            return
        # a replay turn swaps in the previously staged compaction
        # FIRST: the delta replay below must see the committed layout
        self._commit_pending_compaction()
        if self._version != g.version:
            self._store_stats.refreshes += 1
            deltas = g.deltas_since(self._version) \
                if hasattr(g, "deltas_since") else None
            if deltas is None:
                self._full_rebuild()
            else:
                for added, removed in deltas:
                    self._apply_delta(added, removed)
            self._schedule_threshold_compaction()
            self._version = g.version

    def _valid_count(self, layer_filter: Optional[str]) -> int:
        return sum(sh.valid_count(layer_filter)
                   for sh in self._shards)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def refresh(self) -> None:
        """Bring the index up to the graph's version (delta replay);
        commits a pending compaction and schedules at most one new
        one."""
        self._refresh(force_commit=True)

    def rebuild(self) -> None:
        """Force a from-scratch re-stack (tests/benchmarks baseline)."""
        self._full_rebuild()
        self._version = self._graph.version

    def compact(self) -> None:
        """Forced escape hatch: flush the pending double buffer and
        compact every shard that has tombstones, inline."""
        self._refresh(force_commit=True)
        self._commit_pending_compaction()
        for sh in self._shards:
            if sh.n_dead:
                sh.compact_now()

    @property
    def pending_compaction(self) -> Optional[int]:
        """Shard index whose compaction is staged in the double buffer
        (swapped in at the next refresh), or None."""
        return self._pending[0] if self._pending is not None else None

    @property
    def cache_token(self) -> Tuple[int, int]:
        """Exact invalidation token for result caches layered above the
        store: ``(epoch, graph version)`` — search results are a pure
        function of it."""
        return (self.epoch, self._graph.version)

    def attach_lifecycle(self, policy) -> None:
        if policy is not None:
            raise not_ported("live resharding (a lifecycle policy)",
                              "lifecycle and checkpoint")

    @property
    def migration(self):
        """The in-flight reshard migration: never one here."""
        return None

    @property
    def size(self) -> int:
        self._refresh()
        return sum(sh.count - sh.n_dead for sh in self._shards)

    def search(self, query: np.ndarray, k: int,
               layer_filter: Optional[str] = None) -> List[Hit]:
        """layer_filter: None (all) | 'leaf' | 'summary'."""
        return self.search_batch(np.asarray(query)[None, :], k,
                                 layer_filter)[0]

    def search_batch(self, queries: np.ndarray, k: int,
                     layer_filter: Optional[str] = None
                     ) -> List[List[Hit]]:
        raise NotImplementedError


class VectorStore(_BaseStore):
    """Single-buffer store: exactly one ``_Shard`` over one device
    buffer (everything routes to shard 0), searched with a single
    ``mips_topk`` call per query batch — no merge."""

    def __init__(self, graph, *, compact_threshold: float = 0.25,
                 min_capacity: int = 64, quantized: bool = False,
                 coarse_mult: int = 4, scan_bits: int = 64,
                 scan_seed: int = 0, device=None):
        if quantized:
            raise not_ported("the two-stage quantized scan "
                              "(quantized=True)",
                              "two-stage quantized scan")
        super().__init__(graph, compact_threshold)
        self.device = resolve_device(device)
        self.stats = StoreStats()
        self._store_stats = self.stats   # one object, all counters
        dim = graph.cfg.embed_dim
        self.quantized = False
        self.coarse_mult = int(coarse_mult)
        self.scan_bits = int(scan_bits)
        self.scan_seed = int(scan_seed)
        self._group = _DeviceBuffer(dim, self.device,
                                    min_capacity=int(min_capacity),
                                    stats=self.stats)
        self._s = _Shard(dim, self._group, stats=self.stats)
        self._shards = [self._s]

    def owner(self, node_id: str) -> int:
        return 0

    def search_batch(self, queries: np.ndarray, k: int,
                     layer_filter: Optional[str] = None
                     ) -> List[List[Hit]]:
        """Per-query top-k hits for a (B, d) query batch in ONE
        ``mips_topk`` call; row b of the result corresponds to
        ``queries[b]``."""
        with self.tracer.span("route", epoch=self.epoch):
            self._refresh()
        q = _check_queries(queries)
        if q.shape[0] == 0:
            return []
        n_valid = self._s.valid_count(layer_filter)
        if n_valid == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        k_eff = min(k, n_valid)
        with self.tracer.span("scan", epoch=self.epoch,
                              n=q.shape[0], k=k_eff):
            vals, idx = flagged_mips_topk(
                torch.from_numpy(q).to(self.device), self._s.buf, k_eff,
                _filter_bias(layer_filter))
        self._store_stats.kernel_launches += 1
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        out: List[List[Hit]] = []
        for b in range(q.shape[0]):
            out.append([
                Hit(node_id=self._s.row_ids[int(r)], score=float(v),
                    layer=int(self._s.row_layers[int(r)]),
                    seq=int(self._s.row_seq[int(r)]))
                for v, r in zip(vals[b], idx[b])])
        self.query_hits[0] += sum(len(hits) for hits in out)
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _quant_state(self) -> dict:
        return {"quantized": self.quantized,
                "coarse_mult": self.coarse_mult,
                "scan_bits": self.scan_bits,
                "scan_seed": self.scan_seed}

    def state_dict(self) -> dict:
        """Serializable snapshot of the synced buffer (host arrays), in
        the JAX package's flat-store layout."""
        self._refresh()
        return {
            "kind": "flat",
            "version": self._version,
            "next_seq": self._next_seq,
            "quant": self._quant_state(),
            "shard": self._s.state_dict(),
        }

    @classmethod
    def from_state(cls, state: dict, graph, **kw) -> "VectorStore":
        for key, val in (state.get("quant") or {}).items():
            kw.setdefault(key, val)   # explicit kwargs win
        store = cls(graph, **kw)
        store._s.load_state(state["shard"])
        store._next_seq = int(state["next_seq"])
        store._version = int(state["version"])
        return store


def store_from_state(state: dict, graph, *,
                     n_shards: Optional[int] = None, device=None,
                     **kw) -> VectorStore:
    """Restore a flat-store snapshot (``n_shards`` None/0/1 keeps the
    flat layout; a sharded snapshot or layout is not served yet)."""
    if state.get("kind") != "flat" or (n_shards and int(n_shards) != 1):
        raise not_ported("the sharded store", "sharded store")
    return VectorStore.from_state(state, graph, device=device, **kw)
