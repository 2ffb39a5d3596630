"""Hierarchical EraRAG graph: build (Alg 1) + selective update (Alg 3).

One code path serves both: the static build is an insert into an empty
graph (Alg 1 is the degenerate case of Alg 3 — the paper presents them
separately but the update rules subsume construction).  Per-layer
update: route new nodes to segments by code key, repartition only the
affected contiguous regions, re-summarize only changed segments, and
propagate (added, removed) parent sets upward.  ``remove_chunks``
drives the same machinery for shrinking corpora.  Node ids are content
addresses (hash of layer, children, text) so an update that regenerates
an identical summary converges instead of cascading.

Hashing runs on the graph's ``device`` (the CUDA ``lsh_hash`` kernel on
``cuda``, through ``HyperplaneLSH``); everything else here is host
Python, as in the JAX package.

Summarization — the dominant update cost (paper Fig 8) — is batched:
every segment a layer update touches is collected and materialized in
ONE ``Summarizer.summarize_batch`` call (``_materialize_summaries``),
and a content-keyed ``SummaryCache`` short-circuits segments whose
membership digest was summarized before.  Both are behavior-preserving
accelerations: node-creation order matches the serial path exactly and
summarizers are deterministic, so the graph (and the vector store's
row order) is bitwise identical with them on or off.

Locality guarantee (tested): segments outside the affected regions keep
their identity, parent, and summary — the structural basis for the
paper's order-of-magnitude update savings.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.common.config import EraRAGConfig
from repro_torch.obs.timers import timed_block
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.core.lsh import HyperplaneLSH
from repro_torch.core.partition import partition_items
from repro_torch.core.summarize import ExtractiveSummarizer, SummaryCache, \
    SummaryResult, Summarizer
from repro_torch.data.chunker import Chunk
from repro_torch.data.tokenizer import HashTokenizer


@dataclass
class Node:
    node_id: str
    layer: int
    text: str
    embedding: np.ndarray           # (d,) unit float32
    key: int                        # packed LSH code as int
    children: Tuple[str, ...] = ()
    doc_id: str = ""
    n_tokens: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.layer == 0


@dataclass
class Segment:
    members: Tuple[str, ...]        # node ids, (key, id)-sorted
    min_key: int = 0                # code key of first member (routing)
    parent: str = ""                # summary node id at layer+1

    @property
    def size(self) -> int:
        return len(self.members)


@dataclass
class UpdateReport:
    n_new_chunks: int = 0
    n_removed_chunks: int = 0
    n_resummarized: int = 0
    n_affected_segments: int = 0
    n_new_layers: int = 0
    tokens_in: int = 0
    tokens_out: int = 0
    # content-keyed summary-cache movement: segments whose summary was
    # reused instead of regenerated, and the prompt tokens that saved
    summary_cache_hits: int = 0
    summary_tokens_saved: int = 0
    time_embed: float = 0.0
    time_hash: float = 0.0
    time_partition: float = 0.0
    time_summarize: float = 0.0

    @property
    def tokens_total(self) -> int:
        return self.tokens_in + self.tokens_out

    @property
    def time_total(self) -> float:
        return (self.time_embed + self.time_hash + self.time_partition
                + self.time_summarize)

    def merge(self, other: "UpdateReport") -> "UpdateReport":
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self


def _node_id(layer: int, children: Sequence[str], text: str) -> str:
    h = hashlib.blake2b(digest_size=12)
    h.update(str(layer).encode())
    for c in children:
        h.update(c.encode())
    h.update(b"\x00")
    h.update(text.encode("utf-8"))
    return f"L{layer}-{h.hexdigest()}"


class EraGraph:
    # span recorder for the update path; the owning EraRAG swaps in
    # its Observability tracer (the UpdateReport ``time_*`` fields and
    # the spans share one timed_block, so they can never drift apart)
    tracer = NULL_TRACER

    def __init__(self, cfg: EraRAGConfig, embedder,
                 summarizer: Optional[Summarizer] = None,
                 tokenizer: Optional[HashTokenizer] = None,
                 device=None):
        self.cfg = cfg
        self.embedder = embedder
        self.tokenizer = tokenizer or HashTokenizer()
        self.summarizer = summarizer or ExtractiveSummarizer(
            embedder, cfg.summary_max_tokens, self.tokenizer)
        self.lsh = HyperplaneLSH(cfg.embed_dim, cfg.n_hyperplanes,
                                 cfg.seed, device=device)
        # content-keyed summary reuse (persisted with the snapshot);
        # None when disabled — every materialization then regenerates
        self.summary_cache: Optional[SummaryCache] = \
            SummaryCache(cfg.summary_cache_size) \
            if getattr(cfg, "summary_cache_size", 0) > 0 else None
        # summarizer launch accounting for index_report()["launches"]:
        # one launch per summarize_batch call issued from
        # _materialize_summaries (one a segment on the serial loop under
        # batch_summaries=False), segments counted per cache miss
        self.stats = {"summarize_launches": 0,
                      "segments_summarized": 0}
        self.nodes: Dict[str, Node] = {}
        # layer_order[l]: insertion-ordered node-id set for layer l
        self.layer_order: List[Dict[str, None]] = []
        # segments[l] partitions layer l (sorted by first-member key)
        self.segments: List[List[Segment]] = []
        self.member_seg: List[Dict[str, Segment]] = []
        self.version = 0
        # per-version (added_ids, removed_ids) deltas consumed by the
        # vector store for O(delta) index maintenance; added ids are
        # logged in node-creation order so the store's row order tracks
        # the ``nodes`` dict insertion order exactly (tie-breaking in
        # top-k then matches a from-scratch rebuild).
        self._delta_log: Dict[int, Tuple[Tuple[str, ...],
                                         Tuple[str, ...]]] = \
            {0: ((), ())}
        self._delta_keep = 512
        self._pending_added: List[str] = []
        self._pending_removed: List[str] = []

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.layer_order)

    def layer_ids(self, layer: int) -> List[str]:
        return list(self.layer_order[layer]) if layer < self.n_layers \
            else []

    def insert_chunks(self, chunks: Sequence[Chunk],
                      precomputed: Optional[Dict[str, Tuple]] = None
                      ) -> UpdateReport:
        """Insert leaf chunks; build or incrementally update the graph.

        ``precomputed`` optionally maps chunk ids to ``(embedding,
        key)`` rows prepared ahead of time (the streaming
        ``IngestService`` embeds and LSH-routes arriving chunks in
        per-tick batches off the query path).  The embedder and hash
        are row-deterministic, so a precomputed insert is bitwise the
        synchronous one; any chunk missing from the map is embedded
        inline as before."""
        report = UpdateReport()
        fresh = [c for c in chunks if c.chunk_id not in self.nodes]
        report.n_new_chunks = len(fresh)
        if not fresh:
            return report

        pre = dict(precomputed) if precomputed else {}
        need = [c for c in fresh if c.chunk_id not in pre]
        if need:
            with timed_block(report, "time_embed", self.tracer,
                             "embed", n=len(need)):
                embs_new = self.embedder.encode(
                    [c.text for c in need])
            with timed_block(report, "time_hash", self.tracer,
                             "hash", n=len(need)):
                keys_new = self.lsh.hash_ints(embs_new)
            for c, e, k in zip(need, embs_new, keys_new):
                pre[c.chunk_id] = (e, int(k))

        added: List[str] = []
        for c in fresh:
            e, k = pre[c.chunk_id]
            node = Node(node_id=c.chunk_id, layer=0, text=c.text,
                        embedding=np.asarray(e, dtype=np.float32),
                        key=int(k), doc_id=c.doc_id,
                        n_tokens=c.n_tokens)
            self.nodes[node.node_id] = node
            self._pending_added.append(node.node_id)
            added.append(node.node_id)

        self._propagate(added, [], report)
        self.version += 1
        self._log_delta()
        return report

    def remove_chunks(self, chunk_ids: Sequence[str]) -> UpdateReport:
        """Delete leaf chunks (shrinking / churning corpora).

        Removals ride the same per-layer machinery as inserts: each
        affected segment repartitions (merging with neighbors when it
        falls below ``s_min``) and re-summarizes, (added, removed)
        parent sets propagate upward, and untouched segments keep
        their identity and summaries.  Ids absent from the graph (or
        naming non-leaf nodes) are ignored."""
        report = UpdateReport()
        present = [c for c in dict.fromkeys(chunk_ids)
                   if c in self.nodes and self.nodes[c].layer == 0]
        report.n_removed_chunks = len(present)
        if not present:
            return report
        for nid in present:
            self.nodes.pop(nid)
            self._pending_removed.append(nid)
        self._propagate([], list(present), report)
        self.version += 1
        self._log_delta()
        return report

    def _propagate(self, added: List[str], removed: List[str],
                   report: UpdateReport) -> None:
        """Run the per-layer update loop until the churn settles."""
        layer = 0
        while added or removed:
            added, removed, rep = self._update_layer(layer, added,
                                                     removed)
            report.merge(rep)
            layer += 1

    # ------------------------------------------------------------------
    # delta log (vector-store index maintenance)
    # ------------------------------------------------------------------
    def _log_delta(self) -> None:
        """Coalesce this update's node churn into the per-version log."""
        added = tuple(n for n in dict.fromkeys(self._pending_added)
                      if n in self.nodes)
        removed = tuple(n for n in dict.fromkeys(self._pending_removed)
                        if n not in self.nodes)
        self._pending_added = []
        self._pending_removed = []
        self._delta_log[self.version] = (added, removed)
        while len(self._delta_log) > self._delta_keep:
            del self._delta_log[min(self._delta_log)]

    def deltas_since(self, version: int
                     ) -> Optional[List[Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]]]:
        """(added, removed) per version in ``(version, self.version]``.

        Returns ``None`` when the log cannot reconcile the two
        versions: a span the trimmed window no longer covers, a graph
        restored without its log (old ``from_state`` snapshots), or a
        caller AHEAD of the graph (e.g. a persisted store restored
        against an older graph snapshot — serving its extra rows would
        mean ghost nodes).  Callers must fall back to a full rebuild.
        """
        if version == self.version:
            return []
        if version > self.version:
            return None
        span = range(version + 1, self.version + 1)
        if any(v not in self._delta_log for v in span):
            return None
        return [self._delta_log[v] for v in span]

    # ------------------------------------------------------------------
    # layer update machinery
    # ------------------------------------------------------------------
    def _ensure_layer(self, layer: int) -> None:
        while len(self.layer_order) <= layer:
            self.layer_order.append({})
        while len(self.segments) <= layer:
            self.segments.append([])
            self.member_seg.append({})

    def _materialize_summaries(self, layer: int,
                               jobs: Sequence[Tuple[str, ...]],
                               report: UpdateReport) -> List[str]:
        """Create the parent summary nodes for ``jobs`` (ordered member
        tuples of layer ``layer``); returns parent ids in job order.

        This is the single summarization choke point for a layer
        update: every segment needing a (re)summary is collected here
        and the cache misses are materialized in ONE
        ``summarize_batch`` call (with ``cfg.batch_summaries``, the
        default, and a summarizer that has one), else one ``summarize``
        call a segment.  Node-creation order is the job order, which
        fixes ``nodes`` / ``_pending_added`` and therefore the vector
        store's row order.

        The content-keyed ``summary_cache`` short-circuits jobs whose
        (layer, member-id) digest was summarized before: summarizers
        are deterministic, so the cached text IS the regenerated text
        and only the summarizer cost disappears (counted in
        ``summary_cache_hits`` / ``summary_tokens_saved``)."""
        if not jobs:
            return []
        texts = [[self.nodes[m].text for m in members]
                 for members in jobs]
        results: List[Optional[SummaryResult]] = [None] * len(jobs)
        digests: List[str] = []
        miss: List[int] = []
        cache = self.summary_cache
        with timed_block(report, "time_summarize", self.tracer,
                         "summarize", layer=layer, jobs=len(jobs)):
            for i, members in enumerate(jobs):
                if cache is None:
                    miss.append(i)
                    continue
                digest = SummaryCache.digest(layer + 1, members)
                digests.append(digest)
                hit = cache.get(digest)
                if hit is None:
                    miss.append(i)
                    continue
                saved = sum(self.tokenizer.count(t) for t in texts[i])
                cache.stats.tokens_saved += saved
                report.summary_cache_hits += 1
                report.summary_tokens_saved += saved
                results[i] = SummaryResult(hit, 0, 0)
            if miss:
                batch = [texts[i] for i in miss]
                if self.cfg.batch_summaries and \
                        hasattr(self.summarizer, "summarize_batch"):
                    outs = self.summarizer.summarize_batch(batch)
                    self.stats["summarize_launches"] += 1
                else:
                    outs = [self.summarizer.summarize(t) for t in batch]
                    self.stats["summarize_launches"] += len(batch)
                self.stats["segments_summarized"] += len(batch)
                for i, res in zip(miss, outs):
                    results[i] = res
                    if cache is not None:
                        cache.put(digests[i], res.text)
        for i in miss:
            report.tokens_in += results[i].tokens_in
            report.tokens_out += results[i].tokens_out
        report.n_resummarized += len(jobs)

        with timed_block(report, "time_embed", self.tracer, "embed",
                         n=len(results)):
            embs = np.asarray(
                self.embedder.encode([r.text for r in results]),
                dtype=np.float32)
        with timed_block(report, "time_hash", self.tracer, "hash",
                         n=len(results)):
            keys = self.lsh.hash_ints(embs)

        parents: List[str] = []
        for members, res, emb, key in zip(jobs, results, embs, keys):
            nid = _node_id(layer + 1, members, res.text)
            if nid not in self.nodes:
                self._pending_added.append(nid)
            # n_tokens is recounted from the text (== tokens_out on a
            # regeneration) so cache hits produce identical nodes
            self.nodes[nid] = Node(
                node_id=nid, layer=layer + 1, text=res.text,
                embedding=np.asarray(emb, np.float32), key=int(key),
                children=tuple(members),
                n_tokens=self.tokenizer.count(res.text))
            parents.append(nid)
        return parents

    def _route(self, layer: int, key: int) -> int:
        """Index of the segment owning code ``key`` (rightmost whose
        first-member key <= key; else 0)."""
        segs = self.segments[layer]
        lo, hi = 0, len(segs) - 1
        ans = 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if segs[mid].min_key <= key:
                ans = mid
                lo = mid + 1
            else:
                hi = mid - 1
        return ans

    def _update_layer(self, layer: int, added: List[str],
                      removed: List[str]
                      ) -> Tuple[List[str], List[str], UpdateReport]:
        report = UpdateReport()
        self._ensure_layer(layer)
        order = self.layer_order[layer]
        for nid in added:
            order[nid] = None
        for nid in removed:
            order.pop(nid, None)

        segs = self.segments[layer]
        if not segs:
            return self._maybe_create_layer_above(layer, report)

        # --- route additions / removals to segments ------------------
        affected: Set[int] = set()
        updated: Dict[int, List[str]] = {}

        def members_of(idx: int) -> List[str]:
            if idx not in updated:
                updated[idx] = list(segs[idx].members)
            return updated[idx]

        for nid in added:
            idx = self._route(layer, self.nodes[nid].key)
            members_of(idx).append(nid)
            affected.add(idx)
        for nid in removed:
            seg = self.member_seg[layer].pop(nid, None)
            if seg is None:
                continue
            idx = segs.index(seg)  # small layer counts; OK
            m = members_of(idx)
            if nid in m:
                m.remove(nid)
            affected.add(idx)
        if not affected:
            return [], [], report

        # --- repartition affected regions -----------------------------
        # Locality: each affected segment is its own region when its
        # updated size stays within [s_min, s_max] (one re-summary);
        # only bound-violating segments pull in neighbors (the paper's
        # merge-with-adjacent rule).  Joint re-splitting of merely-
        # adjacent affected segments would shift their boundaries and
        # re-summarize segments that didn't need it.
        added_parents: List[str] = []
        removed_parents: List[str] = []
        plan: List[Tuple[int, int, List, Dict, Set[str]]] = []
        jobs: List[Tuple[str, ...]] = []
        with timed_block(report, "time_partition", self.tracer,
                         "partition", layer=layer,
                         affected=len(affected)):
            regions: List[Tuple[int, int]] = []
            for idx in sorted(affected):
                size = len(updated[idx]) if idx in updated \
                    else len(segs[idx].members)
                lo = hi = idx
                if size < self.cfg.s_min:
                    lo, hi = self._extend_group(layer, idx, idx,
                                                updated)
                regions.append((lo, hi))
            groups = self._merge_intervals(regions)
            # pass 1 — plan right-to-left (the splice order): decide
            # every group's partition before any mutation and collect
            # the member tuples that need a fresh summary, in
            # node-creation order
            for lo, hi in reversed(groups):
                items = []
                for idx in range(lo, hi + 1):
                    cur = updated[idx] if idx in updated \
                        else segs[idx].members
                    for nid in cur:
                        items.append((self.nodes[nid].key, nid))
                parts = partition_items(items, self.cfg.s_min,
                                        self.cfg.s_max)
                report.n_affected_segments += hi - lo + 1
                old_by_members = {segs[i].members: segs[i]
                                  for i in range(lo, hi + 1)}
                old_parents = {segs[i].parent
                               for i in range(lo, hi + 1)
                               if segs[i].parent}
                for part in parts:
                    members = tuple(nid for _, nid in part)
                    if members not in old_by_members:
                        jobs.append(members)
                plan.append((lo, hi, parts, old_by_members,
                             old_parents))

        # ONE batched materialization for the whole layer update
        # (segments are disjoint, so member tuples are unique keys)
        by_members = dict(zip(
            jobs, self._materialize_summaries(layer, jobs, report)))

        # pass 2 — splice in plan (right-to-left) order so earlier
        # indices stay valid
        with timed_block(report, "time_partition", self.tracer,
                         "partition", layer=layer, splice=True):
            for lo, hi, parts, old_by_members, old_parents in plan:
                new_segs: List[Segment] = []
                new_parents: Set[str] = set()
                for part in parts:
                    members = tuple(nid for _, nid in part)
                    reuse = old_by_members.get(members)
                    if reuse is not None:
                        new_segs.append(reuse)
                        if reuse.parent:
                            new_parents.add(reuse.parent)
                        continue
                    new_segs.append(Segment(
                        members=members, min_key=part[0][0],
                        parent=by_members[members]))
                    new_parents.add(by_members[members])
                segs[lo:hi + 1] = new_segs
                for seg in new_segs:
                    for nid in seg.members:
                        self.member_seg[layer][nid] = seg
                added_parents.extend(sorted(new_parents
                                            - old_parents))
                removed_parents.extend(sorted(old_parents
                                              - new_parents))

        # drop removed parent nodes from the graph (paper: delete the
        # original node; children were adopted by the new summary node)
        for nid in removed_parents:
            self.nodes.pop(nid, None)
            self._pending_removed.append(nid)
        return added_parents, removed_parents, report

    def _merge_intervals(self, regions: List[Tuple[int, int]]
                         ) -> List[Tuple[int, int]]:
        """Merge overlapping/touching [lo, hi] index intervals."""
        out: List[Tuple[int, int]] = []
        for lo, hi in sorted(regions):
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], hi))
            else:
                out.append((lo, hi))
        return out

    def _extend_group(self, layer: int, lo: int, hi: int,
                      updated: Dict[int, List[str]]
                      ) -> Tuple[int, int]:
        """Grow an undersized region so the merge step has neighbors."""
        segs = self.segments[layer]

        def total(a: int, b: int) -> int:
            return sum(len(updated[i]) if i in updated
                       else len(segs[i].members)
                       for i in range(a, b + 1))

        while total(lo, hi) < self.cfg.s_min and (lo > 0 or
                                                  hi < len(segs) - 1):
            if lo > 0:
                lo -= 1
            else:
                hi += 1
        return lo, hi

    def _maybe_create_layer_above(self, layer: int, report: UpdateReport
                                  ) -> Tuple[List[str], List[str],
                                             UpdateReport]:
        """Top-layer rule (Alg 3 L14): partition + summarize the whole
        layer once it outgrows s_max, creating the next layer."""
        ids = list(self.layer_order[layer])
        stop = (len(ids) <= self.cfg.s_max
                or layer >= self.cfg.max_layers)
        if stop:
            return [], [], report
        with timed_block(report, "time_partition", self.tracer,
                         "partition", layer=layer, new_layer=True):
            items = [(self.nodes[n].key, n) for n in ids]
            parts = partition_items(items, self.cfg.s_min,
                                    self.cfg.s_max)
        report.n_new_layers += 1
        jobs = [tuple(nid for _, nid in part) for part in parts]
        parents = self._materialize_summaries(layer, jobs, report)
        new_segs = [Segment(members=members, min_key=part[0][0],
                            parent=parent)
                    for part, members, parent
                    in zip(parts, jobs, parents)]
        self.segments[layer] = new_segs
        for seg in new_segs:
            for nid in seg.members:
                self.member_seg[layer][nid] = seg
        return parents, [], report

    # ------------------------------------------------------------------
    # integrity + persistence
    # ------------------------------------------------------------------
    def check_integrity(self) -> List[str]:
        """Structural invariants; returns list of violations (tests)."""
        errs: List[str] = []
        for layer, segs in enumerate(self.segments):
            if not segs:
                continue
            seen: Set[str] = set()
            for seg in segs:
                if seg.size > self.cfg.s_max:
                    errs.append(f"L{layer}: segment > s_max "
                                f"({seg.size})")
                for nid in seg.members:
                    if nid in seen:
                        errs.append(f"L{layer}: duplicate member {nid}")
                    seen.add(nid)
                    if nid not in self.nodes:
                        errs.append(f"L{layer}: dangling member {nid}")
                p = seg.parent
                if p and p not in self.nodes:
                    errs.append(f"L{layer}: dangling parent {p}")
                if p and tuple(self.nodes[p].children) != seg.members:
                    errs.append(f"L{layer}: parent children mismatch")
            layer_ids = set(self.layer_order[layer])
            if seen != layer_ids:
                errs.append(
                    f"L{layer}: partition covers {len(seen)} of "
                    f"{len(layer_ids)} nodes")
        for nid, node in self.nodes.items():
            if node.layer >= self.n_layers or \
                    nid not in self.layer_order[node.layer]:
                errs.append(f"node {nid} missing from layer order")
        return errs

    def all_embeddings(self) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(ids, (n, d) embeddings, (n,) layers) for the vector store."""
        ids = list(self.nodes)
        if not ids:
            return [], np.zeros((0, self.cfg.embed_dim), np.float32), \
                np.zeros((0,), np.int32)
        embs = np.stack([self.nodes[i].embedding for i in ids])
        layers = np.asarray([self.nodes[i].layer for i in ids],
                            dtype=np.int32)
        return ids, embs, layers

    def state_dict(self) -> dict:
        return {
            "cfg": self.cfg.__dict__,
            "lsh": self.lsh.state_dict(),
            "version": self.version,
            "nodes": [
                {"node_id": n.node_id, "layer": n.layer, "text": n.text,
                 "embedding": n.embedding, "key": str(n.key),
                 "children": list(n.children), "doc_id": n.doc_id,
                 "n_tokens": n.n_tokens}
                for n in self.nodes.values()],
            "layer_order": [list(d) for d in self.layer_order],
            "segments": [
                [{"members": list(s.members), "parent": s.parent}
                 for s in segs]
                for segs in self.segments],
            # delta-log tail: lets a restored vector store resume with
            # O(delta) refreshes instead of one full O(N) re-stack
            "delta_log": [
                [v, list(a), list(r)]
                for v, (a, r) in sorted(self._delta_log.items())],
            # content-keyed summary reuse survives the snapshot: a
            # restored graph's churn re-summarizations hit instead of
            # paying the summarizer again
            "summary_cache": self.summary_cache.state_dict()
            if self.summary_cache is not None else [],
        }

    @classmethod
    def from_state(cls, state: dict, embedder,
                   summarizer: Optional[Summarizer] = None,
                   device=None) -> "EraGraph":
        cfg = EraRAGConfig(**state["cfg"])
        g = cls(cfg, embedder, summarizer, device=device)
        g.lsh = HyperplaneLSH.from_state(state["lsh"], device=g.lsh.device)
        g.version = int(state["version"])
        for nd in state["nodes"]:
            node = Node(node_id=nd["node_id"], layer=int(nd["layer"]),
                        text=nd["text"],
                        embedding=np.asarray(nd["embedding"],
                                             dtype=np.float32),
                        key=int(nd["key"]),
                        children=tuple(nd["children"]),
                        doc_id=nd["doc_id"],
                        n_tokens=int(nd["n_tokens"]))
            g.nodes[node.node_id] = node
        g.layer_order = [dict.fromkeys(ids)
                         for ids in state["layer_order"]]
        g.segments = []
        g.member_seg = []
        for segs in state["segments"]:
            lst = [Segment(members=tuple(s["members"]),
                           min_key=g.nodes[s["members"][0]].key,
                           parent=s["parent"]) for s in segs]
            g.segments.append(lst)
            g.member_seg.append({nid: seg for seg in lst
                                 for nid in seg.members})
        if "delta_log" in state:   # older snapshots lack the log tail:
            g._delta_log = {       # stores then fall back to a rebuild
                int(v): (tuple(a), tuple(r))
                for v, a, r in state["delta_log"]}
        if g.summary_cache is not None and state.get("summary_cache"):
            g.summary_cache.load_state(state["summary_cache"])
        return g
