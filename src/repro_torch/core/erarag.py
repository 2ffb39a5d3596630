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

Served here: the single-buffer store (``index_shards=1``).  The
sharded store, live resharding, the two-stage quantized scan and the
semantic query cache raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.config import EraRAGConfig, not_ported
from repro_torch.core.graph import EraGraph, UpdateReport
from repro_torch.core.retrieve import BridgeFn, Retrieval, \
    adaptive_search_batch, collapsed_search_batch, \
    multihop_search_batch
from repro_torch.core.store import VectorStore, store_from_state
from repro_torch.core.summarize import Summarizer
from repro_torch.data.chunker import chunk_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import Observability


def _check_served(cfg: EraRAGConfig) -> None:
    """Raise for the config options whose subsystem is not ported."""
    if cfg.index_shards != 1:
        raise not_ported(f"index_shards={cfg.index_shards}",
                          "sharded store")
    if cfg.query_cache:
        raise not_ported("the semantic query cache (query_cache=True)",
                          "serving caches")
    if cfg.reshard_skew_threshold > 0 \
            or cfg.reshard_tombstone_threshold > 0:
        raise not_ported("live resharding (reshard_* thresholds)",
                          "lifecycle and checkpoint")


def _quant_kw(cfg: EraRAGConfig) -> dict:
    return {"quantized": cfg.quantized_scan,
            "coarse_mult": cfg.coarse_mult,
            "scan_bits": cfg.scan_bits, "scan_seed": cfg.seed}


def make_store(graph, cfg: EraRAGConfig, device=None) -> VectorStore:
    """The store ``cfg`` asks for: the single-buffer ``VectorStore``."""
    _check_served(cfg)
    return VectorStore(graph, device=device, **_quant_kw(cfg))


class EraRAG:
    def __init__(self, cfg: EraRAGConfig, embedder,
                 summarizer: Optional[Summarizer] = None, device=None):
        _check_served(cfg)
        self.cfg = cfg
        self.embedder = embedder
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer()
        # per-pipeline observability: a private metrics registry plus
        # the span tracer (NULL_TRACER unless cfg.obs_trace)
        self.obs = Observability(cfg.obs_trace, cfg.obs_max_spans)
        self.graph = EraGraph(cfg, embedder, summarizer, self.tokenizer,
                              device=self.device)
        self.graph.tracer = self.obs.tracer
        self.store = make_store(self.graph, cfg, self.device)
        self.store.tracer = self.obs.tracer
        self.reports: List[UpdateReport] = []
        # batched-retrieval-round counter: every batched store sweep
        # (however many questions it serves) counts ONE round
        self.stats = {"retrieval_rounds": 0}

    def reshard(self, n_shards: int):
        raise not_ported("EraRAG.reshard", "sharded store")

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
        ``bridge_fn`` is only consulted in multihop mode."""
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
            self.stats["retrieval_rounds"] += 1
            return self._search(q, k, mode)

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
                   device=None) -> "EraRAG":
        cfg = EraRAGConfig(**state["cfg"])
        obj = cls(cfg, embedder, summarizer, device=device)
        obj.graph = EraGraph.from_state(state, embedder, summarizer,
                                        device=obj.device)
        obj.graph.tracer = obj.obs.tracer
        if "store" in state:
            obj.store = store_from_state(state["store"], obj.graph,
                                         n_shards=cfg.index_shards,
                                         device=obj.device,
                                         **_quant_kw(cfg))
        else:
            obj.store = make_store(obj.graph, cfg, obj.device)
        obj.store.tracer = obj.obs.tracer
        return obj
