"""Incremental, device-resident flat index: single-buffer and sharded.

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
exceed ``compact_threshold`` of a shard the store compacts it with one
on-device gather, preserving row order so top-k tie-breaking stays
bitwise-identical to a from-scratch rebuild.

All buffer maintenance lives in one place: ``_Shard`` owns the host
metadata and ``_StackedBuffers`` the device tensors.  The single-buffer
``VectorStore`` is one shard over a one-slot group; the
``ShardedVectorStore`` is S of them behind hash routing.

Device buffer.  The JAX package rebuilds its buffers functionally
(``dynamic_update_slice`` / ``.at[].set`` return new arrays); here the
same writes are IN-PLACE slice writes on one device tensor: appends
copy a host block into a slot's ``[row0:row0 + m]``, tombstones set the
dead column in place.  A group holds ONE ``(S, cap, d + 3)`` fp32
tensor (S = 1 keeps the 2-D ``(cap, d + 3)`` layout, so the flat store
scans the buffer itself).  Growth is LOCKSTEP: every slot reaches the
new capacity in one allocation, the old rows copied over.  Compaction
gathers a slot's live rows into a standalone double buffer; the commit
at the next refresh swaps it in (the flat layout) or copies it into its
slot in place (the stacked one), so a query issued in between never
depends on the gather.  Padding rows carry the dead flag, so
``MASK_BIAS`` excludes them for free.  The kernels take any row width,
so ``state_dict`` reads back exactly ``[emb | dead | summary | leaf]``.

Sharded store.  Every node id is hash-routed (blake2b-8 of the id,
big-endian, mod S: bitwise the JAX routing) to one owning shard, so a
delta touches only its owners' slots.  Each row carries a global
sequence number (node-creation order); the group keeps them on the
device too, in an ``(S, cap)`` int32 sequence plane beside the rows.  A
query scans every non-empty slot with the kernels on the slot's view
(contiguous, at offset ``s * cap`` rows: never copied), reads its
candidates' sequence numbers from the plane, and merges the
``(S, b, k)`` candidates on the device by (score desc, sequence asc)
(``merge_sharded_topk``), with one read-back per batch.  Row order in a
slot is a subsequence of the global order and the flat store breaks
ties by row, so sharded results are bitwise the flat store's.

Compaction is OFF the query path: ``refresh()`` commits a previously
scheduled compaction and schedules at most one new one (shards rotate
round-robin; the rest are deferred and counted in
``StoreStats.compactions_skipped``); ``compact()`` is the forced,
flush-everything escape hatch.  Both stores serialize with
``state_dict``/``from_state`` in the JAX package's layouts (its
snapshots are accepted as is, and it accepts the port's); paired with
the graph's persisted delta-log tail, a restored store resumes
incrementally.  ``export_rows`` is the replay source of the lifecycle
``Resharder`` (``repro_torch.lifecycle``).

Two-stage quantized retrieval (``quantized=True``).  The group then
keeps a COMPRESSED PLANE beside the fp32 rows: an ``(S, cap, n_words)``
int32 tensor of packed LSH sign-bit codes (``kernels/quantized_scan``)
over hyperplanes derived from the persisted ``scan_seed``.  Queries run
the coarse Hamming top-C over a slot's codes and the exact fp32
rescore of only those C rows, with ``C = coarse_mult * k`` clamped to
the capacity (per shard on the sharded store, as in the JAX package).
Scores are always real inner products, bitwise the exact scan's for
the rows returned, and at C = capacity the whole result is the exact
scan's.  The plane keeps the JAX store's invariants:
- rows are hashed once, inside the ``write_rows`` that uploads them --
  on append and on ``load_state`` alike, so a restored store re-derives
  its codes and a snapshot never carries them;
- each flag column is mirrored as a penalty word group (all ones when
  set): padding rows and tombstones set the dead group in place;
- compaction gathers the codes by the same ``keep`` index as the rows
  and commits both together.

Live resharding: ``attach_lifecycle`` hands the sharded store a
``LifecyclePolicy``; every explicit ``refresh()`` then commits the
staged compaction, builds one target shard of an in-flight migration
(or installs it), replays the delta log, and consults the policy, in
that order.  Not served yet: the collective query over a process group
(the loop serves every batch, as the JAX package's does without a
mesh).
"""
from __future__ import annotations

import functools
import hashlib
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.sharding import local_shard_count, \
    padded_slot_count, shard_placements
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.mips_topk.ops import MASK_BIAS, SEQ_PAD, \
    VAL_PAD, augment_queries, flagged_mips_topk, merge_sharded_topk, \
    mips_topk
from repro_torch.kernels.quantized_scan.ops import FLAG_SET, QuantSpec, \
    encode_rows, hyperplanes, prepare_queries, quantized_flagged_topk, \
    two_stage_topk
from repro_torch.obs.trace import NULL_TRACER

logger = logging.getLogger(__name__)

# trailing indicator columns of the device buffer
N_FLAGS = 3
_DEAD, _SUMMARY, _LEAF = 0, 1, 2

# sequence number of rows past the staged prefix; the monotone global
# counter is renumbered (order-preserving) before it can reach it,
# keeping every sequence number within int32
_SEQ_PAD = np.int64(SEQ_PAD)
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

    Field for field the JAX package's ``StoreStats``."""

    refreshes: int = 0
    full_rebuilds: int = 0
    rows_staged: int = 0       # host rows uploaded to the device buffer
    rows_tombstoned: int = 0
    compactions: int = 0       # committed double-buffer swaps
    compactions_skipped: int = 0  # over-threshold shards deferred by
    # the one-shard-per-refresh rotation
    rows_compacted: int = 0
    growths: int = 0
    # id-routing cache movement (each store owns its routing LRU)
    route_hits: int = 0
    route_misses: int = 0
    bulk_routed: int = 0
    reshards: int = 0          # committed epoch swaps
    reshard_steps: int = 0
    # scans served by the two-stage quantized pipeline
    quantized_scans: int = 0
    # scans issued by THIS store's query path (per-instance twin of the
    # process-global kernel launch counters in kernels/*/ops); the
    # sharded loop adds one per non-empty shard plus one for the merge
    kernel_launches: int = 0


# ---------------------------------------------------------------------------
# id routing
# ---------------------------------------------------------------------------

_ROUTE_LRU_SIZE = 1 << 16
# at/above this many ids, routing bypasses the LRU: a full replay of a
# large corpus would otherwise evict every useful entry
_BULK_ROUTE_MIN = 4096


def _route(node_id: str, n_shards: int) -> int:
    """Stable owning shard of a node id (pure content hash: identical
    across processes, restarts and PYTHONHASHSEED)."""
    h = hashlib.blake2b(node_id.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") % n_shards


def _bulk_route(ids: List[str], n_shards: int) -> np.ndarray:
    """One blake2 sweep over the ids, then one vectorized big-endian
    reduce + mod: the LRU-bypass bulk pass."""
    raw = b"".join(hashlib.blake2b(i.encode(), digest_size=8).digest()
                   for i in ids)
    h = np.frombuffer(raw, dtype=">u8")
    return (h % np.uint64(n_shards)).astype(np.int64)


class _Router:
    """One routing cache + its counters.

    A small LRU absorbs the delta path asking for the same id up to
    three times (stale check, tombstone routing, append routing);
    batches at/above ``_BULK_ROUTE_MIN`` bypass it.  Every store owns a
    PRIVATE instance, so its ``route_hits`` / ``route_misses`` /
    ``bulk_routed`` are exactly its own traffic.  The cache key
    includes ``n_shards``, so a reshard needs no invalidation."""

    def __init__(self):
        self.cached = functools.lru_cache(
            maxsize=_ROUTE_LRU_SIZE)(_route)
        self.bulk_routed = 0

    def one(self, node_id: str, n_shards: int) -> int:
        return self.cached(node_id, n_shards)

    def many(self, ids: Sequence[str], n_shards: int) -> np.ndarray:
        ids = list(ids)
        if len(ids) < _BULK_ROUTE_MIN:
            return np.fromiter(
                (self.cached(i, n_shards) for i in ids),
                np.int64, count=len(ids))
        self.bulk_routed += len(ids)
        return _bulk_route(ids, n_shards)

    def info(self) -> Dict[str, int]:
        info = self.cached.cache_info()
        return {"hits": info.hits, "misses": info.misses,
                "size": info.currsize, "maxsize": info.maxsize,
                "bulk_routed": self.bulk_routed}


_global_router = _Router()
shard_of = _global_router.cached


def shard_of_many(ids: Sequence[str], n_shards: int) -> np.ndarray:
    """Route an id batch in one pass (process-global cache)."""
    return _global_router.many(ids, n_shards)


# ---------------------------------------------------------------------------
# stacked device buffers
# ---------------------------------------------------------------------------

# compaction's double buffer: a slot's gathered rows, sequence numbers
# and (quantized) codes
_Compacted = Tuple[torch.Tensor, Optional[torch.Tensor],
                   Optional[torch.Tensor]]


class _StackedBuffers:
    """Device side of a store: ONE ``(S, cap, d + N_FLAGS)`` fp32 tensor
    on ``device`` whose slots grow in LOCKSTEP (padding rows pre-flagged
    dead); with ``track_seqs`` an ``(S, cap)`` int32 sequence plane
    (padding ``SEQ_PAD``), and with ``quant`` an ``(S, cap, n_words)``
    int32 code plane (padding rows' dead group set), both row-aligned
    with it.  S = 1 keeps 2-D tensors (``(cap, d + N_FLAGS)``), so the
    flat store scans the buffer itself.  Every mutation is an in-place
    write on one slot except growth (reallocate + copy) and the flat
    layout's compaction commit (a swap)."""

    def __init__(self, n_slots: int, dim: int, device: torch.device, *,
                 min_capacity: int = 64, track_seqs: bool = False,
                 quant: Optional[QuantSpec] = None,
                 stats: Optional[StoreStats] = None):
        self.n_slots = int(n_slots)
        self.dim = int(dim)
        self.device = device
        self.min_capacity = int(min_capacity)
        self.track_seqs = bool(track_seqs)
        self.quant = quant
        # derived from the persisted (dim, n_bits, seed) alone: a
        # restored store re-hashes to the codes it was saved with
        self.planes = None if quant is None else \
            torch.from_numpy(hyperplanes(quant)).to(device)
        self.stats = stats if stats is not None else StoreStats()
        self._flat2d = self.n_slots == 1
        self.reset()

    def reset(self) -> None:
        self.capacity = 0
        self.buf: Optional[torch.Tensor] = None
        self.seq: Optional[torch.Tensor] = None
        self.codes: Optional[torch.Tensor] = None
        self._restack()

    def _restack(self) -> None:
        """The per-slot views of the current tensors, made once per
        allocation (a view shares the slot's storage: no copy)."""
        def views(t):
            if t is None:
                return [None] * self.n_slots
            return [t] if self._flat2d else list(t.unbind(0))
        self._views = views(self.buf)
        self._seq_views = views(self.seq)
        self._code_views = views(self.codes)

    def _lead(self) -> Tuple[int, ...]:
        return () if self._flat2d else (self.n_slots,)

    def _empty(self, lead: Tuple[int, ...], cap: int) -> torch.Tensor:
        buf = torch.zeros(lead + (cap, self.dim + N_FLAGS),
                          dtype=torch.float32, device=self.device)
        buf[..., self.dim + _DEAD] = 1.0
        return buf

    def _empty_seq(self, lead: Tuple[int, ...], cap: int) -> torch.Tensor:
        return torch.full(lead + (cap,), SEQ_PAD, dtype=torch.int32,
                          device=self.device)

    def _empty_codes(self, lead: Tuple[int, ...],
                     cap: int) -> torch.Tensor:
        codes = torch.zeros(lead + (cap, self.quant.n_words),
                            dtype=torch.int32, device=self.device)
        lo, hi = self.quant.flag_group(_DEAD)
        codes[..., lo:hi] = FLAG_SET
        return codes

    def ensure(self, need: int) -> None:
        """Lockstep geometric growth: every slot reaches the next
        power-of-two multiple of the capacity in one allocation, the old
        rows copied over."""
        if need <= self.capacity:
            return
        cap = max(self.min_capacity, self.capacity)
        while cap < need:
            cap *= 2
        lead, old = self._lead(), self.capacity
        buf = self._empty(lead, cap)
        if self.buf is not None:
            buf[..., :old, :].copy_(self.buf)
        self.buf = buf
        if self.track_seqs:
            seq = self._empty_seq(lead, cap)
            if self.seq is not None:
                seq[..., :old].copy_(self.seq)
            self.seq = seq
        if self.quant is not None:
            codes = self._empty_codes(lead, cap)
            if self.codes is not None:
                codes[..., :old, :].copy_(self.codes)
            self.codes = codes
        self.capacity = cap
        self.stats.growths += 1
        self._restack()

    def slice_view(self, slot: int) -> torch.Tensor:
        """Slot ``slot``'s contiguous ``(cap, d + N_FLAGS)`` rows, the
        tensor its scan reads (the flat layout's is the buffer)."""
        return self._views[slot]

    def seq_view(self, slot: int) -> torch.Tensor:
        return self._seq_views[slot]

    def codes_view(self, slot: int) -> torch.Tensor:
        return self._code_views[slot]

    def write_rows(self, slot: int, row0: int, block: np.ndarray,
                   seqs: Optional[np.ndarray] = None) -> None:
        """In place: ``slot[row0:row0 + m] = block`` (host -> device),
        its sequence numbers into the plane, and with ``quant`` the
        block's codes, hashed on the device: its flag columns (a
        snapshot's tombstones included) become penalty groups."""
        m = block.shape[0]
        rows = self._views[slot][row0:row0 + m]
        rows.copy_(torch.from_numpy(block))
        if self.track_seqs and seqs is not None:
            self._seq_views[slot][row0:row0 + m].copy_(
                torch.from_numpy(np.asarray(seqs, np.int32)))
        if self.quant is not None:
            self._code_views[slot][row0:row0 + m] = encode_rows(
                rows[:, :self.dim], rows[:, self.dim:], self.planes,
                self.quant)

    def upload_seqs(self, slot: int, seqs: np.ndarray) -> None:
        """Re-stamp a slot's sequence prefix (renumbering)."""
        if self.track_seqs and len(seqs):
            self._seq_views[slot][:len(seqs)].copy_(
                torch.from_numpy(np.asarray(seqs, np.int32)))

    def mark_dead(self, slot: int, rows: np.ndarray) -> None:
        """In place: set the dead flag of ``rows`` (and their codes'
        dead group: no rehash)."""
        idx = torch.as_tensor(np.asarray(rows, np.int64),
                              device=self.device)
        self._views[slot][idx, self.dim + _DEAD] = 1.0
        if self.quant is not None:
            lo, hi = self.quant.flag_group(_DEAD)
            self._code_views[slot][idx, lo:hi] = FLAG_SET

    def compact_gather(self, slot: int, keep: np.ndarray) -> _Compacted:
        """The order-preserving gather of a slot's ``keep`` rows (and
        sequence numbers and codes, by the same index) into NEW
        standalone tensors, the double buffer; the group is untouched
        until ``commit_compacted``."""
        n = len(keep)
        idx = torch.as_tensor(np.asarray(keep, np.int64),
                              device=self.device)
        rows = self._empty((), self.capacity)
        rows[:n] = self._views[slot][idx]
        seq = codes = None
        if self.track_seqs:
            seq = self._empty_seq((), self.capacity)
            seq[:n] = self._seq_views[slot][idx]
        if self.quant is not None:
            codes = self._empty_codes((), self.capacity)
            codes[:n] = self._code_views[slot][idx]
        return rows, seq, codes

    def commit_compacted(self, slot: int, compacted: _Compacted) -> None:
        rows, seq, codes = compacted
        if self._flat2d:
            self.buf, self.seq, self.codes = rows, seq, codes
            self._restack()
            return
        self._views[slot].copy_(rows)
        if seq is not None:
            self._seq_views[slot].copy_(seq)
        if codes is not None:
            self._code_views[slot].copy_(codes)

    def read_rows(self, slot: int, n: int) -> np.ndarray:
        if n == 0:
            return np.zeros((0, self.dim + N_FLAGS), np.float32)
        # a copy on every device (a CPU tensor's .numpy() would alias)
        return self._views[slot][:n].to("cpu", copy=True).numpy()


class _Shard:
    """Host metadata + maintenance for one slot of a ``_StackedBuffers``
    group: id <-> row maps, layers, global sequence numbers, alive bits.
    Device work is delegated to the group, so the flat and sharded
    stores can never diverge.  Each row carries a global sequence number
    (node-creation order), the tie-break hits carry as ``Hit.seq``."""

    def __init__(self, dim: int, group: _StackedBuffers, slot: int = 0, *,
                 stats: Optional[StoreStats] = None):
        self.dim = dim
        self.group = group
        self.slot = slot
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
        """This shard's (cap, d+F) rows, the tensor its scan reads."""
        return self.group.slice_view(self.slot)

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
        self.group.ensure(self.count + m)   # lockstep growth
        self._grow_host(self.count + m)
        block = np.zeros((m, d + N_FLAGS), np.float32)
        seq_arr = np.asarray(seqs, np.int64)
        for j, nid in enumerate(ids):
            node = nodes[nid]
            block[j, :d] = node.embedding
            cls = "summary" if node.layer > 0 else "leaf"
            block[j, d + (_SUMMARY if node.layer > 0 else _LEAF)] = 1.0
            row = self.count + j
            self.row_ids.append(nid)
            self.row_layers[row] = node.layer
            self.alive[row] = True
            self.row_of[nid] = row
            self.n_alive[cls] += 1
        self.row_seq[self.count:self.count + m] = seq_arr
        self.group.write_rows(self.slot, self.count, block, seq_arr)
        self.count += m
        self.stats.rows_staged += m

    def tombstone(self, ids: Sequence[str]) -> List[int]:
        """Flag rows dead in place; returns the retired global sequence
        numbers (the store drops them from its seq map)."""
        rows: List[int] = []
        seqs: List[int] = []
        for nid in ids:
            row = self.row_of.pop(nid, None)
            if row is None or not self.alive[row]:
                continue
            self.alive[row] = False
            cls = "summary" if self.row_layers[row] > 0 else "leaf"
            self.n_alive[cls] -= 1
            rows.append(row)
            seqs.append(int(self.row_seq[row]))
        if rows:
            self.group.mark_dead(self.slot, np.asarray(rows, np.int64))
            self.n_dead += len(rows)
            self.stats.rows_tombstoned += len(rows)
        return seqs

    # -- compaction: schedule (gather into double buffer) / commit ----
    def schedule_compact(self) -> Tuple[np.ndarray, _Compacted]:
        """Dispatch the order-preserving gather of live rows into a
        double buffer; the swap happens at ``commit_compact`` (the next
        refresh), so no query issued in between depends on it."""
        keep = np.nonzero(self.alive[:self.count])[0]
        return keep, self.group.compact_gather(self.slot, keep)

    def commit_compact(self, keep: np.ndarray,
                       compacted: _Compacted) -> None:
        self.group.commit_compacted(self.slot, compacted)
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
            "buf": self.group.read_rows(self.slot, self.count),
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
        self.group.write_rows(self.slot, 0, buf, self.row_seq[:n])
        alive = np.asarray(state["alive"], bool)
        self.alive[:n] = alive
        self.count = n
        self.n_dead = int(n - alive.sum())
        live = np.nonzero(alive)[0]
        self.row_of = {ids[int(r)]: int(r) for r in live}
        n_sum = int(np.count_nonzero(layers[live] > 0))
        self.n_alive = {"summary": n_sum, "leaf": len(live) - n_sum}


def pack_export_rows(ids: List[str], layers: List[np.ndarray],
                     seqs: List[np.ndarray], rows: List[np.ndarray],
                     dim: int) -> Dict[str, np.ndarray]:
    """The canonical replay payload from per-shard alive-row pieces:
    ``{"ids", "layers", "seqs", "rows"}``, globally sorted by sequence
    number.  Used by the live ``export_rows`` and the snapshot replay
    (``lifecycle.reshard.rows_from_state``) alike."""
    if not ids:
        return {"ids": np.zeros((0,), dtype="<U1"),
                "layers": np.zeros((0,), np.int32),
                "seqs": np.zeros((0,), np.int64),
                "rows": np.zeros((0, dim + N_FLAGS), np.float32)}
    seq_all = np.concatenate(seqs)
    order = np.argsort(seq_all, kind="stable")
    return {"ids": np.asarray(ids)[order],
            "layers": np.concatenate(layers)[order],
            "seqs": seq_all[order],
            "rows": np.concatenate(rows)[order]}


def _quant_spec(dim: int, quantized: bool, scan_bits: int,
                scan_seed: int) -> Optional[QuantSpec]:
    """Code-plane layout for a store constructed quantized (None keeps
    the default store code-plane-free)."""
    if not quantized:
        return None
    return QuantSpec(dim=int(dim), n_bits=int(scan_bits),
                     n_flags=N_FLAGS, seed=int(scan_seed))


def _apply_quant_state(state: dict, kw: dict) -> None:
    """Fold a snapshot's quant entry into constructor kwargs (explicit
    kwargs win)."""
    for key, val in (state.get("quant") or {}).items():
        kw.setdefault(key, val)


def _filter_bias(layer_filter: Optional[str]) -> Tuple[float, ...]:
    return (MASK_BIAS,
            MASK_BIAS if layer_filter == "leaf" else 0.0,
            MASK_BIAS if layer_filter == "summary" else 0.0)


def _check_queries(queries: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(queries, dtype=np.float32)
    if q.ndim != 2:
        raise ValueError(f"queries must be (B, d), got {q.shape}")
    return q


def slot_topk(q_aug: torch.Tensor, buf: torch.Tensor, seq: torch.Tensor,
              k: int, *, q_codes: Optional[torch.Tensor] = None,
              codes: Optional[torch.Tensor] = None, n_coarse: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's share of the sharded scan: its top ``k_s = min(k,
    cap)`` rows by the kernel on the slot's own view (``mips_topk``, or
    with ``q_codes`` the two-stage scan at ``C = max(min(n_coarse, cap),
    k_s)``), their sequence numbers read from the slot's plane, padded
    to k with (``VAL_PAD``, ``SEQ_PAD``): ``(b, k)`` scores and int32
    sequence numbers for ``merge_sharded_topk``."""
    cap = buf.shape[0]
    k_s = min(k, cap)
    if q_codes is None:
        vals, idx = mips_topk(q_aug, buf, k_s)
    else:
        vals, idx = two_stage_topk(q_aug, q_codes, buf, codes, k_s,
                                   max(min(n_coarse, cap), k_s))
    seqs = seq[idx.long()]
    if k_s < k:
        pad = (vals.shape[0], k - k_s)
        vals = torch.cat([vals, vals.new_full(pad, VAL_PAD)], dim=1)
        seqs = torch.cat([seqs, seqs.new_full(pad, SEQ_PAD)], dim=1)
    return vals, seqs


class _BaseStore:
    """Delta-replay orchestration shared by both stores:
    stale-resurrection handling, per-version replay, the rotating
    off-query-path compaction, rebuild.  Subclasses define the shard set
    (``self._shards``), the device group (``self._group``) and the owner
    of an id (``owner`` / ``owner_many``)."""

    _shards: List[_Shard]
    _group: _StackedBuffers
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
        # merged-candidate id resolution of the sharded store:
        # seq -> (node_id, layer, owning shard)
        self._seq_map: Dict[int, Tuple[str, int, int]] = {}
        self._track_seq_map = False
        # double-buffered compaction state
        self._pending: Optional[Tuple[int, np.ndarray, _Compacted]] = \
            None
        self._compact_rr = 0
        # index lifecycle: committed reshard migrations bump the epoch;
        # `_migration` is the in-flight staged epoch, built one target
        # shard per refresh(); `_policy` is the pluggable trigger that
        # refresh() consults (attach_lifecycle)
        self.epoch = 0
        self._migration = None
        self._policy = None         # Optional[LifecyclePolicy]
        self._router = _Router()    # per-instance routing LRU+counters
        self.query_hits = np.zeros(1, np.int64)

    def owner(self, node_id: str) -> int:
        raise NotImplementedError

    def owner_many(self, ids: Sequence[str]) -> np.ndarray:
        ids = list(ids)
        return np.fromiter((self.owner(i) for i in ids), np.int64,
                           count=len(ids))

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def _append(self, ids: Sequence[str]) -> None:
        if not ids:
            return
        if self._next_seq + len(ids) >= _SEQ_LIMIT:
            self._renumber_seqs()
        nodes = self._graph.nodes
        owners = self.owner_many(ids)
        buckets: Dict[int, Tuple[List[str], List[int]]] = {}
        for nid, s in zip(ids, owners):
            b_ids, b_seqs = buckets.setdefault(int(s), ([], []))
            b_ids.append(nid)
            b_seqs.append(self._next_seq)
            if self._track_seq_map:
                self._seq_map[self._next_seq] = (
                    nid, int(nodes[nid].layer), int(s))
            self._next_seq += 1
        for s, (b_ids, b_seqs) in buckets.items():
            self._shards[s].append(nodes, b_ids, b_seqs)

    def _renumber_seqs(self) -> None:
        """Compact the global sequence numbers to 0..n_rows-1,
        preserving order, then re-stamp the device sequence planes and
        the seq map (once per ~2^31 lifetime appends)."""
        rows = [(int(sh.row_seq[r]), sh, r)
                for sh in self._shards for r in range(sh.count)]
        rows.sort(key=lambda t: t[0])
        for new_seq, (_, sh, r) in enumerate(rows):
            sh.row_seq[r] = new_seq
        self._next_seq = len(rows)
        for sh in self._shards:
            self._group.upload_seqs(sh.slot, sh.row_seq[:sh.count])
        if self._track_seq_map:
            self._rebuild_seq_map()

    def _rebuild_seq_map(self) -> None:
        self._seq_map.clear()
        for s, sh in enumerate(self._shards):
            for r in range(sh.count):
                if sh.alive[r]:
                    self._seq_map[int(sh.row_seq[r])] = (
                        sh.row_ids[r], int(sh.row_layers[r]), s)

    def _tombstone(self, ids: Sequence[str]) -> None:
        if not ids:
            return
        owners = self.owner_many(ids)
        buckets: Dict[int, List[str]] = {}
        for nid, s in zip(ids, owners):
            buckets.setdefault(int(s), []).append(nid)
        for s, b_ids in buckets.items():
            for seq in self._shards[s].tombstone(b_ids):
                self._seq_map.pop(seq, None)

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
        self._migration = None  # staged epoch rows are stale too: abort
        # the migration (the policy re-triggers if still warranted)
        self._group.reset()
        for sh in self._shards:
            sh.reset()
        self._seq_map.clear()
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

    def _advance_migration(self) -> None:
        """Lifecycle turn (explicit ``refresh()`` only): build at most
        ONE staged target shard of an in-flight reshard migration, and
        once every target shard is built, install the new epoch with
        one atomic swap.  The install rewinds ``_version`` to the
        migration's plan version, so the replay that follows brings the
        new epoch up to date through the graph's delta-log tail."""
        mig = self._migration
        if mig is None:
            return
        if not mig.done:
            desc = mig.describe()
            with self.tracer.span("reshard_step", epoch=self.epoch,
                                  built=desc["built"],
                                  total=desc["total"]):
                mig.step()
            self._store_stats.reshard_steps += 1
        if mig.done:
            self._migration = None
            with self.tracer.span("reshard_install",
                                  old_epoch=self.epoch,
                                  new_epoch=self.epoch + 1):
                mig.install()

    def _maybe_start_reshard(self) -> None:
        """Consult the attached lifecycle policy for a reshard plan; at
        most one migration is in flight at a time."""
        if self._policy is None or self._migration is not None:
            return
        plan = self._policy.decide(self)
        if plan is None:
            return
        from repro_torch.lifecycle.reshard import ShardMigration
        logger.info("lifecycle: starting reshard %d -> %d (%s)",
                    plan.n_from, plan.n_to, plan.reason)
        self._migration = ShardMigration(self, plan)

    def _refresh(self, force_commit: bool = False) -> None:
        g = self._graph
        if self._version == g.version and not force_commit:
            # version-synced queries take this hot path: they never
            # commit (or depend on) a staged compaction or advance a
            # migration, so a query issued mid-migration always serves
            # the OLD epoch unchanged
            return
        # a replay turn swaps in the previously staged compaction
        # FIRST: the delta replay below must see the committed layout
        self._commit_pending_compaction()
        if force_commit:
            # one lifecycle turn per explicit refresh: build one staged
            # target shard, or commit the finished epoch swap (which
            # rewinds _version to the plan version: the replay below
            # then applies the delta tail to the new epoch)
            self._advance_migration()
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
        if force_commit:
            self._maybe_start_reshard()

    def _valid_count(self, layer_filter: Optional[str]) -> int:
        return sum(sh.valid_count(layer_filter)
                   for sh in self._shards)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def refresh(self) -> None:
        """Bring the index up to the graph's version (delta replay,
        routed to owning shards only); commits a pending compaction,
        schedules at most one new one, and takes one lifecycle turn
        (one migration step or install, then the policy's consult)."""
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
        """Attach a ``LifecyclePolicy`` (None detaches): every explicit
        ``refresh()`` consults it and may start (then advance, one
        target shard per call) an epoch-swapped reshard migration.  The
        flat store never migrates in place: its policy stands down."""
        self._policy = policy

    def routing_cache_info(self) -> Dict[str, int]:
        """This store's private routing-LRU counters (never another
        store's traffic: the cache is per instance)."""
        return self._router.info()

    @property
    def migration(self):
        """The in-flight ``ShardMigration`` (the staged epoch being
        built off the query path by ``refresh()``), or None."""
        return self._migration

    def _quant_state(self) -> dict:
        """The scan's settings.  The code plane itself is never saved:
        a restore re-hashes every row from ``scan_seed``."""
        return {"quantized": self.quantized,
                "coarse_mult": self.coarse_mult,
                "scan_bits": self.scan_bits,
                "scan_seed": self.scan_seed}

    def export_rows(self) -> Dict[str, np.ndarray]:
        """Alive rows in global-sequence order, captured to host: the
        replay source of the lifecycle ``Resharder``.  ``{"ids",
        "layers", "seqs", "rows"}``, ``rows`` the ``(n, d + N_FLAGS)``
        buffer content: replayed into a freshly-routed store at any
        shard count they reproduce search results bitwise (the same
        float rows, the same relative sequence order)."""
        self._refresh()
        ids: List[str] = []
        layers: List[np.ndarray] = []
        seqs: List[np.ndarray] = []
        rows: List[np.ndarray] = []
        # ONE device -> host copy of the whole stack
        stack = self._group.buf.cpu().numpy() \
            if self._group.buf is not None else None
        for sh in self._shards:
            n = sh.count
            if n == 0:
                continue
            keep = np.nonzero(sh.alive[:n])[0]
            if len(keep) == 0:
                continue
            buf = stack[:n] if stack.ndim == 2 else stack[sh.slot, :n]
            ids.extend(sh.row_ids[int(r)] for r in keep)
            layers.append(sh.row_layers[:n][keep])
            seqs.append(sh.row_seq[:n][keep])
            rows.append(np.asarray(buf[keep], np.float32))
        return pack_export_rows(ids, layers, seqs, rows,
                                self._group.dim)

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
    """Single-buffer store: exactly one ``_Shard`` over a one-slot group
    (everything routes to shard 0), searched with one scan per query
    batch — no merge."""

    def __init__(self, graph, *, compact_threshold: float = 0.25,
                 min_capacity: int = 64, quantized: bool = False,
                 coarse_mult: int = 4, scan_bits: int = 64,
                 scan_seed: int = 0, device=None):
        super().__init__(graph, compact_threshold)
        self.device = resolve_device(device)
        self.stats = StoreStats()
        self._store_stats = self.stats   # one object, all counters
        dim = graph.cfg.embed_dim
        self.quantized = bool(quantized)
        self.coarse_mult = int(coarse_mult)
        self.scan_bits = int(scan_bits)
        self.scan_seed = int(scan_seed)
        self._group = _StackedBuffers(
            1, dim, self.device, min_capacity=int(min_capacity),
            quant=_quant_spec(dim, quantized, scan_bits, scan_seed),
            stats=self.stats)
        self._s = _Shard(dim, self._group, stats=self.stats)
        self._shards = [self._s]

    def owner(self, node_id: str) -> int:
        return 0

    def search_batch(self, queries: np.ndarray, k: int,
                     layer_filter: Optional[str] = None
                     ) -> List[List[Hit]]:
        """Per-query top-k hits for a (B, d) query batch in ONE scan; row
        b of the result corresponds to ``queries[b]``.

        The scan is ``flagged_mips_topk``, or with ``quantized`` the
        two-stage pipeline (coarse Hamming top-C over the code plane,
        then the exact rescore of those C rows); flipping
        ``self.quantized`` off gives the exact scan, the oracle."""
        with self.tracer.span("route", epoch=self.epoch):
            self._refresh()
        q = _check_queries(queries)
        if q.shape[0] == 0:
            return []
        n_valid = self._s.valid_count(layer_filter)
        if n_valid == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        k_eff = min(k, n_valid)
        q_dev = torch.from_numpy(q).to(self.device)
        grp = self._group
        if self.quantized and grp.quant is not None:
            # C = coarse_mult * k clamped to the capacity: k <= C <= cap
            # (k_eff <= n_valid <= rows <= cap), and at C == cap the
            # candidate set is total -- the exact scan's result
            n_coarse = min(self.coarse_mult * k_eff, grp.capacity)
            with self.tracer.span("coarse_scan", epoch=self.epoch,
                                  n=q.shape[0], k=k_eff,
                                  fused_rescore=True):
                vals, idx = quantized_flagged_topk(
                    q_dev, grp.buf, grp.codes, k_eff, n_coarse,
                    _filter_bias(layer_filter), grp.planes, grp.quant)
            self._store_stats.quantized_scans += 1
        else:
            with self.tracer.span("scan", epoch=self.epoch,
                                  n=q.shape[0], k=k_eff):
                vals, idx = flagged_mips_topk(
                    q_dev, grp.buf, k_eff, _filter_bias(layer_filter))
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
        _apply_quant_state(state, kw)
        store = cls(graph, **kw)
        store._s.load_state(state["shard"])
        store._next_seq = int(state["next_seq"])
        store._version = int(state["version"])
        return store


# ---------------------------------------------------------------------------
# sharded store
# ---------------------------------------------------------------------------

class ShardedVectorStore(_BaseStore):
    """Hash-sharded incremental index on one device: the same public API
    and bitwise-identical results as ``VectorStore`` (see the module
    docstring).  ``n_shards`` defaults to one shard per device of the
    store's device type.  ``collective=True`` is accepted, as in the JAX
    package; the collective needs a process group of several devices,
    which a store on one device never has, so the per-shard loop
    (``collective_active`` False) serves every batch, as the JAX
    package's does without a mesh."""

    def __init__(self, graph, *, n_shards: Optional[int] = None,
                 compact_threshold: float = 0.25,
                 min_capacity: int = 64, collective: bool = True,
                 quantized: bool = False, coarse_mult: int = 4,
                 scan_bits: int = 64, scan_seed: int = 0, device=None):
        super().__init__(graph, compact_threshold)
        self.device = resolve_device(device)
        self.quantized = bool(quantized)
        self.coarse_mult = int(coarse_mult)
        self.scan_bits = int(scan_bits)
        self.scan_seed = int(scan_seed)
        if n_shards is None:
            n_shards = local_shard_count(self.device)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.collective = bool(collective)
        self._collective_capable = False
        self._store_stats = StoreStats()
        dim = graph.cfg.embed_dim
        devices = [self.device]
        self._placements = shard_placements(devices, self.n_shards)
        self._group = _StackedBuffers(
            padded_slot_count(self.n_shards, len(devices)), dim,
            self.device, min_capacity=int(min_capacity), track_seqs=True,
            quant=_quant_spec(dim, quantized, scan_bits, scan_seed),
            stats=self._store_stats)
        self._shards = [_Shard(dim, self._group, s)
                        for s in range(self.n_shards)]
        self._track_seq_map = True
        self.query_hits = np.zeros(self.n_shards, np.int64)

    def owner(self, node_id: str) -> int:
        return self._router.one(node_id, self.n_shards)

    def owner_many(self, ids: Sequence[str]) -> np.ndarray:
        return self._router.many(ids, self.n_shards)

    @property
    def collective_active(self) -> bool:
        """Whether ``search_batch`` runs as one collective launch."""
        return self.collective and self._collective_capable

    @property
    def stats(self) -> StoreStats:
        """Aggregate counters: store-level refresh/rebuild/rotation/
        reshard counts, per-shard staging/tombstone/compaction sums, and
        this instance's own routing-cache movement."""
        agg = StoreStats(**vars(self._store_stats))
        for sh in self._shards:
            agg.rows_staged += sh.stats.rows_staged
            agg.rows_tombstoned += sh.stats.rows_tombstoned
            agg.compactions += sh.stats.compactions
            agg.rows_compacted += sh.stats.rows_compacted
            agg.growths += sh.stats.growths
        route = self._router.info()
        agg.route_hits = route["hits"]
        agg.route_misses = route["misses"]
        agg.bulk_routed = route["bulk_routed"]
        return agg

    def shard_stats(self) -> List[StoreStats]:
        return [sh.stats for sh in self._shards]

    def shard_report(self) -> List[dict]:
        """Per-shard health: live rows, dead rows, the lockstep
        capacity, staged rows and the owning device."""
        pending = self.pending_compaction
        return [{
            "rows": sh.count - sh.n_dead,
            "dead": sh.n_dead,
            "dead_ratio": sh.n_dead / max(1, sh.count),
            "capacity": sh.capacity,
            "staged": sh.stats.rows_staged,
            "compactions": sh.stats.compactions,
            "query_hits": int(self.query_hits[s]),
            "compact_pending": pending == s,
            "device": str(self._placements[s]),
        } for s, sh in enumerate(self._shards)]

    def search_batch(self, queries: np.ndarray, k: int,
                     layer_filter: Optional[str] = None
                     ) -> List[List[Hit]]:
        """The per-shard loop + the on-device merge, bitwise the
        single-buffer store's result."""
        with self.tracer.span("route", epoch=self.epoch):
            self._refresh()
        q = _check_queries(queries)
        n_q = q.shape[0]
        if n_q == 0:
            return []
        n_valid = self._valid_count(layer_filter)
        if n_valid == 0 or k <= 0:
            return [[] for _ in range(n_q)]
        k_eff = min(k, n_valid)
        quant = self.quantized and self._group.quant is not None
        mv, ms = self._loop_dispatch(q, k_eff, _filter_bias(layer_filter),
                                     quantized=quant)
        if quant:
            self._store_stats.quantized_scans += 1
        # ONE read-back: the scores' bits beside the sequence numbers
        both = torch.cat([mv.view(torch.int32), ms], dim=1).cpu().numpy()
        mv = both[:, :k_eff].view(np.float32)
        ms = both[:, k_eff:]
        out: List[List[Hit]] = []
        for b in range(n_q):
            hits: List[Hit] = []
            for v, s in zip(mv[b], ms[b]):
                nid, layer, shard = self._seq_map[int(s)]
                self.query_hits[shard] += 1
                hits.append(Hit(node_id=nid, score=float(v),
                                layer=layer, seq=int(s)))
            out.append(hits)
        return out

    def _loop_dispatch(self, q: np.ndarray, k_eff: int,
                       bias: Tuple[float, ...], quantized: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One scan per non-empty shard on its slot view (the query
        block, and its codes, made once for the loop), then the merge
        on the device."""
        grp = self._group
        q_dev = torch.from_numpy(q).to(self.device)
        if quantized:
            q_aug, q_codes = prepare_queries(q_dev, bias, grp.planes,
                                             grp.quant)
        else:
            q_aug, q_codes = augment_queries(q_dev, bias).contiguous(), \
                None
        vals: List[torch.Tensor] = []
        seqs: List[torch.Tensor] = []
        span = "coarse_scan" if quantized else "scan"
        with self.tracer.span(span, epoch=self.epoch, n=q.shape[0],
                              k=k_eff, collective=False):
            for sh in self._shards:
                if sh.count == 0:
                    continue
                v, s = slot_topk(
                    q_aug, sh.buf, grp.seq_view(sh.slot), k_eff,
                    q_codes=q_codes,
                    codes=grp.codes_view(sh.slot) if quantized else None,
                    n_coarse=self.coarse_mult * k_eff)
                vals.append(v)
                seqs.append(s)
        # one scan per non-empty shard above, plus the merge below
        self._store_stats.kernel_launches += len(vals) + 1
        with self.tracer.span("merge", epoch=self.epoch,
                              shards=len(vals)):
            return merge_sharded_topk(torch.stack(vals),
                                      torch.stack(seqs), k_eff)

    # ------------------------------------------------------------------
    # lifecycle: atomic epoch swap (reshard commit)
    # ------------------------------------------------------------------
    def install_epoch(self, staging: "ShardedVectorStore") -> None:
        """Atomically adopt ``staging``'s fully-built buffers, shards
        and routing as this store's next epoch (the reshard commit).
        ``_version`` rewinds to the staging snapshot's version, so the
        next refresh replays the graph's delta tail into the new epoch;
        a pending old-epoch compaction gather is dropped."""
        assert staging._graph is self._graph, "epoch from another graph"
        self._pending = None
        self._compact_rr = 0
        self._group = staging._group
        self._group.stats = self._store_stats
        self._shards = staging._shards
        self.n_shards = staging.n_shards
        self._collective_capable = staging._collective_capable
        self._placements = staging._placements
        self._seq_map = staging._seq_map
        self._version = staging._version
        # appends after the swap must stay above every replayed seq
        self._next_seq = max(self._next_seq, staging._next_seq)
        self.query_hits = np.zeros(self.n_shards, np.int64)
        self.epoch += 1
        self._store_stats.reshards += 1

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        self._refresh()
        return {
            "kind": "sharded",
            "n_shards": self.n_shards,
            "version": self._version,
            "next_seq": self._next_seq,
            "quant": self._quant_state(),
            "shards": [sh.state_dict() for sh in self._shards],
        }

    @classmethod
    def from_state(cls, state: dict, graph, *,
                   n_shards: Optional[int] = None,
                   **kw) -> "ShardedVectorStore":
        """Restore a snapshot.  ``n_shards`` (None/0 = keep the
        snapshot's layout) may disagree with the snapshot: the rows are
        then replayed through the lifecycle ``Resharder`` into a
        freshly-routed store at the requested count."""
        _apply_quant_state(state, kw)
        snap = int(state["n_shards"])
        want = snap if not n_shards else int(n_shards)
        if want != snap:
            from repro_torch.lifecycle.reshard import Resharder
            return Resharder(**kw).replay_state(state, graph, want)
        store = cls(graph, n_shards=snap, **kw)
        for sh, sh_state in zip(store._shards, state["shards"]):
            sh.load_state(sh_state)
        store._rebuild_seq_map()
        store._next_seq = int(state["next_seq"])
        store._version = int(state["version"])
        return store


AnyStore = Union[VectorStore, ShardedVectorStore]


def store_from_state(state: dict, graph, *,
                     n_shards: Optional[int] = None, **kw) -> AnyStore:
    """Restore whichever store kind ``state`` was saved from (the JAX
    package's snapshots included).  ``n_shards`` (None/0 = respect the
    snapshot's layout) reshards the snapshot through the lifecycle
    ``Resharder`` when it disagrees, across kinds too."""
    _apply_quant_state(state, kw)   # replayed stores keep their plane
    want = int(n_shards) if n_shards else None
    if state.get("kind") == "sharded":
        if want is not None and want != int(state["n_shards"]):
            from repro_torch.lifecycle.reshard import Resharder
            return Resharder(**kw).replay_state(state, graph, want,
                                                flat=want == 1)
        return ShardedVectorStore.from_state(state, graph, **kw)
    if want is not None and want != 1:
        from repro_torch.lifecycle.reshard import Resharder
        return Resharder(**kw).replay_state(state, graph, want)
    kw.pop("collective", None)   # flat store has no dispatch modes
    return VectorStore.from_state(state, graph, **kw)
