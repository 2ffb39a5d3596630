"""EraRAG facade: the paper's full pipeline behind one object.

``insert_docs`` chunks + embeds + updates the hierarchical graph
(incremental after the first call); ``query`` runs collapsed, adaptive
or multihop retrieval and returns the budgeted context.  All cost
metrics (tokens, per-stage wall time) accumulate in ``self.reports``.

The LSH hashing and the vector store live on ``device`` (``cuda``
unless the caller passes another; without CUDA the constructor raises
unless asked for ``device="cpu"``).  Chunking, embedding and
summarization stay on the host, as in the JAX package.

``from_state`` accepts the JAX package's ``EraRAG.state_dict(
include_store=True)`` dict as is (numpy arrays and Python values) and
serves the same queries from it with no re-embedding.

Served here: the single-buffer store (``index_shards=1``) and the
hash-sharded store (``index_shards`` > 1, or 0 for one shard per device
of the store's device type), each with the exact scan or, under
``quantized_scan=True``, the two-stage quantized scan (``coarse_mult``,
``scan_bits`` and the config seed pass through to the store), and the
explicit ``EraRAG.reshard``.  ``group`` (a ``launch/mesh.py``
``DataGroup``, the JAX package's ``mesh``) lays the sharded store over a
process group's ranks, each holding its own slots on the group's
device; every rank then builds the same graph and makes the same calls.
``collective_query`` (on by default) then serves each query batch as
one collective call over the group; with no group, or a group of one
rank, the per-shard loop serves it, as in the JAX package without a
mesh.  ``query_cache=True`` puts the epoch-invalidated
``SemanticQueryCache`` in front of retrieval.  The ``reshard_*``
thresholds attach a ``LifecyclePolicy`` to the store, whose explicit
``refresh()`` then starts and advances live reshard migrations.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.graph import EraGraph, UpdateReport
from repro_torch.core.query_cache import SemanticQueryCache
from repro_torch.core.retrieve import BridgeFn, Retrieval, \
    adaptive_search_batch, collapsed_search_batch, \
    multihop_search_batch
from repro_torch.core.store import AnyStore, ShardedVectorStore, \
    VectorStore, store_from_state
from repro_torch.core.summarize import Summarizer
from repro_torch.data.chunker import chunk_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import Observability


def _quant_kw(cfg: EraRAGConfig) -> dict:
    return {"quantized": cfg.quantized_scan,
            "coarse_mult": cfg.coarse_mult,
            "scan_bits": cfg.scan_bits, "scan_seed": cfg.seed}


def make_store(graph, cfg: EraRAGConfig, device=None,
               group=None) -> AnyStore:
    """cfg.index_shards: 1 -> the single-buffer store (a group does not
    override an explicitly unsharded config); > 1 -> that many
    hash-routed shards, over ``group``'s ranks when given; 0 -> one
    shard per rank of the group, or without one per device of the
    store's device type (``torch.cuda.device_count()`` on the card, 1 on
    the CPU).  ``cfg.collective_query`` selects the collective query."""
    if cfg.index_shards == 1:
        return VectorStore(graph, device=device, **_quant_kw(cfg))
    return ShardedVectorStore(
        graph, n_shards=cfg.index_shards or None, group=group,
        device=device, collective=cfg.collective_query, **_quant_kw(cfg))


class EraRAG:
    def __init__(self, cfg: EraRAGConfig, embedder,
                 summarizer: Optional[Summarizer] = None, device=None,
                 group=None):
        self.cfg = cfg
        self.embedder = embedder
        self.group = group
        self.device = group.device if group is not None and \
            device is None else resolve_device(device)
        self.tokenizer = HashTokenizer()
        # per-pipeline observability: a private metrics registry plus
        # the span tracer (NULL_TRACER unless cfg.obs_trace)
        self.obs = Observability(cfg.obs_trace, cfg.obs_max_spans)
        self.graph = EraGraph(cfg, embedder, summarizer, self.tokenizer,
                              device=self.device)
        self.graph.tracer = self.obs.tracer
        self.store = make_store(self.graph, cfg, self.device, group)
        self.store.tracer = self.obs.tracer
        self._attach_lifecycle()
        self.reports: List[UpdateReport] = []
        # batched-retrieval-round counter: every batched store sweep
        # (however many questions it serves) counts ONE round
        # (cache-served queries never consume a round)
        self.stats = {"retrieval_rounds": 0}
        # semantic query cache in front of retrieval: exact +
        # cosine-threshold hits, invalidated by the store cache_token
        # (epoch + graph version), so cached Retrievals are never stale
        self.query_cache = None
        if cfg.query_cache:
            self.query_cache = SemanticQueryCache(
                capacity=cfg.query_cache_size,
                threshold=cfg.query_cache_threshold)

    def _attach_lifecycle(self) -> None:
        """Attach the config's reshard policy (if any threshold is on)
        so the store's refresh loop schedules and advances live reshard
        migrations on its own."""
        from repro_torch.lifecycle.policy import LifecyclePolicy
        policy = LifecyclePolicy.from_config(self.cfg)
        if policy is not None:
            self.store.attach_lifecycle(policy)

    def reshard(self, n_shards: int) -> AnyStore:
        """Change the index shard count NOW (a synchronous epoch-swapped
        migration: rows replay out of the live buffers, no
        re-embedding, results bitwise-equal to a fresh build at the
        target count).  Sharded-to-sharded migrations swap in place
        (``self.store`` keeps its identity); ``n_shards == 1`` returns to
        the single-buffer store, and a flat store reshards into a new
        ``ShardedVectorStore``.  Either way ``self.store`` is the store
        to use afterwards; its epoch, the first half of the cache token,
        moves on by one."""
        from repro_torch.lifecycle.reshard import Resharder
        resharder = Resharder(group=self.group, device=self.device,
                              collective=self.cfg.collective_query,
                              **_quant_kw(self.cfg))
        self.store = resharder.reshard(self.store, n_shards)
        self.store.tracer = self.obs.tracer  # store may be a NEW object
        self.cfg = dataclasses.replace(self.cfg,
                                       index_shards=int(n_shards))
        self._attach_lifecycle()
        if self.query_cache is not None:
            # a flat<->sharded reshard may swap in a NEW store object
            # whose epoch counter restarts, so the token could collide
            # with the old store's: drop the generation explicitly (an
            # in-place sharded migration is covered by the epoch bump)
            self.query_cache.clear()
        return self.store

    # ------------------------------------------------------------------
    def insert_docs(self, docs: Iterable[Tuple[str, str]]) -> UpdateReport:
        chunks = chunk_corpus(docs, self.tokenizer,
                              self.cfg.chunk_tokens)
        report = self.graph.insert_chunks(chunks)
        self.reports.append(report)
        return report

    def remove_docs(self, doc_ids: Iterable[str]) -> UpdateReport:
        """Shrink the corpus: drop every chunk of the given documents
        and propagate the removal up the hierarchy (the same selective
        update as inserts).  Unknown ids are ignored, so removal is
        idempotent."""
        wanted = set(doc_ids)
        victims = [nid for nid, n in self.graph.nodes.items()
                   if n.layer == 0 and n.doc_id in wanted]
        report = self.graph.remove_chunks(victims)
        self.reports.append(report)
        return report

    def query(self, text: str, k: Optional[int] = None,
              mode: str = "collapsed",
              bridge_fn: Optional[BridgeFn] = None) -> Retrieval:
        """mode: collapsed | detailed | summarized | multihop."""
        return self.query_batch([text], k=k, mode=mode,
                                bridge_fn=bridge_fn)[0]

    def query_batch(self, texts: Sequence[str],
                    k: Optional[int] = None,
                    mode: str = "collapsed",
                    bridge_fn: Optional[BridgeFn] = None
                    ) -> List[Retrieval]:
        """Batched retrieval: one embedder call + one store scan per
        ``mips_topk`` call for the whole query block.  ``query`` is the
        B=1 special case.  ``mode='multihop'`` runs two-round retrieval
        and returns ``HopRetrieval`` rows with composed contexts;
        ``bridge_fn`` is only consulted in multihop mode.  With the
        query cache on, only the block's misses go to the store, in one
        sweep (multihop bypasses the cache)."""
        k = k or self.cfg.top_k
        texts = list(texts)
        if not texts:
            return []
        tr = self.obs.tracer
        with tr.span("retrieve", n=len(texts), mode=mode,
                     epoch=self.store.epoch):
            if mode == "multihop":
                rets = multihop_search_batch(
                    self.graph, self.store, self.embedder.encode,
                    texts, k, self.cfg.token_budget,
                    self.cfg.retrieval_bias_p,
                    bridge_fn=bridge_fn, tokenizer=self.tokenizer)
                self.stats["retrieval_rounds"] += \
                    1 + int(any(r.hops == 2 for r in rets))
                return rets
            with tr.span("embed", n=len(texts)):
                q = np.asarray(self.embedder.encode(texts))
            if self.query_cache is None:
                self.stats["retrieval_rounds"] += 1
                return self._search(q, k, mode)
            # semantic cache front: per-query exact/cosine lookup
            # under the current store token; only the misses form a
            # (single) store sweep, and every fresh result is cached
            # under the same token
            token = self.store.cache_token
            key = (k, mode, self.cfg.token_budget,
                   self.cfg.retrieval_bias_p)
            with tr.span("cache_lookup", n=len(texts)) as sp:
                out = self.query_cache.lookup_batch(token, key, q)
                miss = [i for i, r in enumerate(out) if r is None]
                if sp is not None:
                    sp.attrs["misses"] = len(miss)
            if miss:
                self.stats["retrieval_rounds"] += 1
                fresh = self._search(q[np.asarray(miss)], k, mode)
                for i, r in zip(miss, fresh):
                    self.query_cache.put(token, key, q[i], r)
                    out[i] = r
            return out

    def _search(self, q: np.ndarray, k: int, mode: str
                ) -> List[Retrieval]:
        if mode == "collapsed":
            return collapsed_search_batch(self.graph, self.store, q, k,
                                          self.cfg.token_budget,
                                          self.tokenizer)
        return adaptive_search_batch(self.graph, self.store, q, k,
                                     self.cfg.token_budget,
                                     self.cfg.retrieval_bias_p, mode,
                                     self.tokenizer)

    # ------------------------------------------------------------------
    @property
    def total_tokens(self) -> int:
        return sum(r.tokens_total for r in self.reports)

    @property
    def total_build_time(self) -> float:
        return sum(r.time_total for r in self.reports)

    def last_report(self) -> UpdateReport:
        return self.reports[-1] if self.reports else UpdateReport()

    def state_dict(self, include_store: bool = False) -> dict:
        """Graph snapshot (with delta-log tail); ``include_store``
        additionally embeds the synced index buffer so a restart skips
        even the initial re-stack.  Same layout as the JAX package's."""
        state = self.graph.state_dict()
        if include_store:
            state["store"] = self.store.state_dict()
        return state

    @classmethod
    def from_state(cls, state: dict, embedder,
                   summarizer: Optional[Summarizer] = None,
                   device=None, group=None) -> "EraRAG":
        cfg = EraRAGConfig(**state["cfg"])
        obj = cls(cfg, embedder, summarizer, device=device, group=group)
        obj.graph = EraGraph.from_state(state, embedder, summarizer,
                                        device=obj.device)
        obj.graph.tracer = obj.obs.tracer
        if "store" in state:
            # cfg.index_shards is the desired layout (0 keeps the
            # snapshot's); a disagreement with the snapshot replays
            # through the lifecycle Resharder, never a full re-embed
            obj.store = store_from_state(state["store"], obj.graph,
                                         group=group,
                                         n_shards=cfg.index_shards,
                                         collective=cfg.collective_query,
                                         device=obj.device,
                                         **_quant_kw(cfg))
        else:
            obj.store = make_store(obj.graph, cfg, obj.device, group)
        obj.store.tracer = obj.obs.tracer
        obj._attach_lifecycle()
        return obj
