"""End-to-end RAG serving: EraRAG retrieval -> prompt -> reader.

The paper's Alg 2 as a service: queries retrieve a budgeted context
from the hierarchical graph, the context + question form the reader
prompt, and the reader answers.  ``answer_batch`` micro-batches
concurrent questions end-to-end — one retrieval scan per round for the
whole question block (``EraRAG.query_batch``) and, with an LM reader
attached (``engine=``, a ``serving.Engine``), bucketed-prefill
shared-slot decodes via ``Engine.generate_batch``.  Multihop questions
batch too (``mode='multihop'``): round-1 retrieval, bridge extraction
(ONE ``generate_batch`` when an LM reader is attached), round-2
retrieval, and the final reader pass each run once per question
*block*, so a B-question multihop batch costs exactly two reader
launches and two batched retrieval rounds.  ``answer`` is the
sequential per-question oracle ``answer_batch`` must match answer for
answer.  Without an engine the deterministic ``ExtractiveReader``
answers, so Accuracy / Recall are measurable offline (containment
metric, §IV).

Also served: an attached streaming ``IngestService`` (``ingest=`` or
``attach_ingest``) and ``index_report``, the serving-side view of the
index over the obs registry's live collectors.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.erarag import EraRAG
from repro_torch.core.retrieve import Retrieval, compose_hop_query, \
    default_bridge_fn, is_hop_question
from repro_torch.lifecycle.report import ShardLoadReport
from repro_torch.obs.schema import INDEX_REPORT_SCHEMA
from repro_torch.obs.trace import NULL_TRACER


@dataclass
class RAGAnswer:
    answer: str
    context: str
    n_context_tokens: int
    hits: int
    # store epoch the retrieval was served from
    epoch: int = 0


class ExtractiveReader:
    """Deterministic QA reader over retrieved context.

    Emulates the LLM reader for benchmark purposes: finds the sentence
    most lexically aligned with the question and extracts the value
    position ('The <rel> of <ent> is <val>' patterns first, else the
    best-overlap sentence).  Containment scoring then matches the
    paper's metric.
    """

    _FACT = re.compile(
        r"The (\w+) of (\w+) is (\w+)", re.IGNORECASE)

    def answer(self, question: str, context: str) -> str:
        q_words = set(w.lower() for w in re.findall(r"\w+", question))
        best_val = ""
        best_score = -1.0
        for m in self._FACT.finditer(context):
            rel, ent, val = m.groups()
            score = (rel.lower() in q_words) * 2.0 + \
                (ent.lower() in q_words) * 3.0
            if score > best_score:
                best_score = score
                best_val = val
        if best_val and best_score > 0:
            return best_val
        # fallback: sentence with max word overlap
        sents = re.split(r"(?<=[.!?])\s+", context)
        best = max(sents, default="", key=lambda s: len(
            q_words & set(w.lower() for w in re.findall(r"\w+", s))))
        return best

    def answer_multihop(self, question: str, rag: "EraRAG",
                        k: Optional[int] = None) -> Tuple[str, Retrieval]:
        """Two-round retrieval: resolve the bridge entity, re-query
        (sequential path; serving goes through
        ``RAGPipeline.answer_batch(mode='multihop')``)."""
        r1 = rag.query(question, k=k)
        [q2] = default_bridge_fn([question], [r1])
        if q2:
            r2 = rag.query(q2, k=k)
            merged = r1.context + "\n" + r2.context
            return self.answer(q2, merged), r2
        return self.answer(question, r1.context), r1


class RAGPipeline:
    def __init__(self, rag: EraRAG, reader=None, engine=None,
                 ingest=None):
        self.rag = rag
        self.reader = reader or ExtractiveReader()
        self.engine = engine  # optional LM reader (serving.Engine)
        self.ingest = ingest  # optional repro_torch.ingest.IngestService
        self._wire_obs()

    def _wire_obs(self) -> None:
        """Hand the pipeline's subsystems to the EraRAG observability
        layer: the (possibly null) tracer flows onto the engine and the
        ingest service, and live *collectors* land on the metrics
        registry so ``index_report()`` is a view over it.  Collectors
        close over ``self`` — never over a store or engine object — so
        reshard/restore store swaps need no re-registration."""
        obs = self.rag.obs
        if self.engine is not None:
            self.engine.tracer = obs.tracer
        if self.ingest is not None:
            self.ingest.tracer = obs.tracer
        reg = obs.registry
        reg.register_collector("store", self._collect_store)
        reg.register_collector("retrieval", self._collect_retrieval)
        reg.register_collector("query_cache", self._collect_query_cache)
        reg.register_collector("prefix_cache", self._collect_prefix_cache)
        reg.register_collector("ingest", self._collect_ingest)
        reg.register_collector("launches", self._collect_launches)
        reg.register_collector("obs", self._collect_obs)
        reg.declare_many(INDEX_REPORT_SCHEMA)

    def attach_ingest(self, service) -> None:
        """Attach a streaming ``IngestService`` so its queue/commit
        counters surface in ``index_report()['ingest']``.  The serving
        loop interleaves ``service.tick()`` with ``answer_batch`` calls
        — the service never runs threads of its own."""
        self.ingest = service
        self.ingest.tracer = self.rag.obs.tracer

    # -- registry collectors (live views, read at collection time) -----
    def _collect_store(self) -> dict:
        """Index health: size + refresh counters, the lifecycle
        ``ShardLoadReport`` (per-shard live-row / tombstone / query-hit
        skew, routing-cache counters, epoch), plus the per-shard
        breakdown when the store is sharded."""
        store = self.rag.store
        out = {"size": store.size, "stats": dict(vars(store.stats)),
               "epoch": store.epoch,
               "load": ShardLoadReport.from_store(store).to_dict()}
        # two-stage quantized retrieval: whether searches serve through
        # the coarse sign-bit scan, and at what candidate multiplier
        out["quantized_scan"] = bool(
            getattr(store, "quantized", False)
            and store._group.quant is not None)
        if out["quantized_scan"]:
            out["coarse_mult"] = store.coarse_mult
            out["scan_bits"] = store.scan_bits
        if hasattr(store, "shard_report"):
            out["shards"] = store.shard_report()
            # dispatch mode + rotating-compaction state
            out["collective_query"] = store.collective_active
            out["pending_compaction"] = store.pending_compaction
        return out

    def _collect_retrieval(self) -> dict:
        return {"rounds": self.rag.stats["retrieval_rounds"]}

    def _collect_query_cache(self) -> dict:
        """Semantic query-cache movement counters; empty when the cache
        is disabled."""
        qc = self.rag.query_cache
        return qc.stats.to_dict() if qc is not None else {}

    def _collect_prefix_cache(self) -> dict:
        """Engine KV prefix-reuse counters; empty without an LM reader."""
        eng = self.engine
        if eng is None:
            return {}
        return {"hits": eng.stats["prefix_hits"],
                "tokens_saved": eng.stats["prefix_tokens_saved"],
                "entries": len(eng._prefix_cache)}

    def _collect_ingest(self) -> dict:
        """Write-path health: summary-cache movement and, when a
        streaming IngestService is attached, its queue depth /
        burst-commit counters."""
        out: dict = {}
        if self.rag.graph.summary_cache is not None:
            out["summary_cache"] = \
                self.rag.graph.summary_cache.stats.to_dict()
            out["summary_cache_entries"] = \
                len(self.rag.graph.summary_cache)
        if self.ingest is not None:
            out["service"] = self.ingest.report()
        return out

    def _collect_launches(self) -> dict:
        """Per-subsystem launch accounting: embedder encode calls,
        summarizer materializations, retrieval sweep rounds, store
        maintenance turns and the store's scans, and (with an LM
        reader) the engine's prefill and decode launches."""
        store = self.rag.store
        launches = {
            "retrieval_rounds": self.rag.stats["retrieval_rounds"],
            "store": {"refreshes": store.stats.refreshes,
                      "compactions": store.stats.compactions,
                      "reshard_steps": store.stats.reshard_steps,
                      "quantized_scans": store.stats.quantized_scans,
                      "kernel_launches": store.stats.kernel_launches}}
        emb_stats = getattr(self.rag.graph.embedder, "stats", None)
        if emb_stats is not None:
            launches["embedder"] = dict(emb_stats)
        launches["summarizer"] = dict(self.rag.graph.stats)
        if self.engine is not None:
            launches["engine"] = {
                "prefill_launches":
                    self.engine.stats["prefill_launches"],
                "decode_launches":
                    self.engine.stats["decode_launches"],
                "generate_batches":
                    self.engine.stats["generate_batches"]}
        return launches

    def _collect_obs(self) -> dict:
        """Tracer accounting — only surfaced when tracing is enabled,
        so the default counters-only report is unchanged."""
        tr = self.rag.obs.tracer
        if tr is NULL_TRACER:
            return {}
        return {"spans": tr.total_spans, "spans_dropped": tr.dropped}

    def index_report(self) -> dict:
        """Serving-side index health as a view over the obs registry:
        every section is one registered collector (``store``,
        ``retrieval``, ``query_cache``, ``prefix_cache``, ``ingest``,
        ``launches``, ``obs``), read live at call time.  The same
        collectors back ``registry.snapshot()`` and
        ``registry.to_prometheus()``, so the report, the flat metric
        view and the text exposition cannot drift apart.  Every numeric
        key is declared in ``obs.schema.INDEX_REPORT_SCHEMA``."""
        reg = self.rag.obs.registry
        report = dict(reg.collect("store"))
        report["retrieval_rounds"] = reg.collect("retrieval")["rounds"]
        for section in ("query_cache", "prefix_cache", "ingest"):
            got = reg.collect(section)
            if got:
                report[section] = got
        report["launches"] = reg.collect("launches")
        obs = reg.collect("obs")
        if obs:
            report["obs"] = obs
        return report

    @staticmethod
    def _prefix(context: str) -> str:
        """The reusable context block of the reader prompts — declared
        to the engine's KV prefix cache so N questions over one
        retrieved context pay its prefill once.  Ends at a whitespace
        boundary, so prefix tokens are a prefix of prompt tokens."""
        return f"Context:\n{context}\n\n"

    @classmethod
    def _prompt(cls, question: str, context: str) -> str:
        return cls._prefix(context) + f"Question: {question}\nAnswer:"

    @classmethod
    def _bridge_prompt(cls, question: str, context: str) -> str:
        return cls._prefix(context) + \
            f"Question: {question}\nBridge entity:"

    def _generate(self, prompts: List[str], contexts: List[str],
                  batched: bool) -> List[str]:
        """The engine's answers to ``prompts``, each declaring its
        context block as the reusable prefix: ONE ``generate_batch`` on
        the batched path, one ``generate`` a prompt on the oracle
        path."""
        prefixes = [self._prefix(c) for c in contexts]
        if batched:
            return self.engine.generate_batch(prompts, prefixes=prefixes)
        return [self.engine.generate(p, prefix=px)
                for p, px in zip(prompts, prefixes)]

    def _bridge_fn(self, batched: bool):
        """Bridge resolution for the multihop rounds.  The
        deterministic regex gate decides WHICH questions take a second
        hop (so batched and per-question paths agree on short-
        circuits); with an LM reader attached the follow-up query is
        composed from its bridge-extraction output."""
        if self.engine is None:
            return None  # retrieve.default_bridge_fn

        def fn(questions, retrievals):
            bridges = default_bridge_fn(questions, retrievals)
            gated = [i for i, b in enumerate(bridges) if b]
            if not gated:
                return bridges
            outs = self._generate(
                [self._bridge_prompt(questions[i], retrievals[i].context)
                 for i in gated],
                [retrievals[i].context for i in gated], batched)
            for i, entity in zip(gated, outs):
                bridges[i] = compose_hop_query(questions[i], entity)
            return bridges

        return fn

    def _multihop(self, questions: List[str], batched: bool
                  ) -> List[RAGAnswer]:
        """Two-round multihop answering.  ``batched=True`` groups the
        block: ONE round-1 retrieval batch, ONE bridge-extraction
        launch, ONE round-2 batch, ONE final reader launch.
        ``batched=False`` is the sequential per-question oracle."""
        bridge_fn = self._bridge_fn(batched)
        if batched:
            rets = self.rag.query_batch(questions, mode="multihop",
                                        bridge_fn=bridge_fn)
        else:
            rets = [self.rag.query(q, mode="multihop",
                                   bridge_fn=bridge_fn)
                    for q in questions]
        with self.rag.obs.tracer.span("compose", n=len(questions),
                                      multihop=True):
            if self.engine is not None:
                texts = self._generate(
                    [self._prompt(q, r.context)
                     for q, r in zip(questions, rets)],
                    [r.context for r in rets], batched)
            else:
                texts = [self.reader.answer(r.bridge_query or q,
                                            r.context)
                         for q, r in zip(questions, rets)]
        return [RAGAnswer(answer=t, context=r.context,
                          n_context_tokens=r.n_tokens,
                          hits=len(r.hits),
                          epoch=getattr(r, "epoch", 0))
                for t, r in zip(texts, rets)]

    def answer(self, question: str, mode: str = "collapsed"
               ) -> RAGAnswer:
        """Per-question oracle path: sequential rounds, B=1 scans —
        ``answer_batch`` must match it answer-for-answer."""
        tr = self.rag.obs.tracer
        with tr.span("query", n=1, mode=mode):
            if mode == "multihop" or (self.engine is None
                                      and is_hop_question(question)):
                return self._multihop([question], batched=False)[0]
            r = self.rag.query(question, mode=mode)
            with tr.span("compose", n=1):
                text = (self._generate([self._prompt(question, r.context)],
                                       [r.context], batched=False)[0]
                        if self.engine is not None
                        else self.reader.answer(question, r.context))
            return RAGAnswer(answer=text, context=r.context,
                             n_context_tokens=r.n_tokens,
                             hits=len(r.hits),
                             epoch=getattr(r, "epoch", 0))

    def answer_batch(self, questions: Sequence[str],
                     mode: str = "collapsed") -> List[RAGAnswer]:
        """Answer a question block with shared launches: one batched
        retrieval scan per round and (with an LM reader) bucketed
        prefill with every prompt in an engine slot at once.
        ``mode='multihop'`` batches both rounds end-to-end; on the
        extractive path, two-hop-shaped questions route through the
        same batched multihop machinery (there is no per-question
        fallback)."""
        questions = list(questions)
        if not questions:
            return []
        tr = self.rag.obs.tracer
        with tr.span("query", n=len(questions), mode=mode):
            if mode == "multihop":
                return self._multihop(questions, batched=True)
            out: List[Optional[RAGAnswer]] = [None] * len(questions)
            hop = [i for i, q in enumerate(questions)
                   if self.engine is None and is_hop_question(q)]
            hop_set = set(hop)
            plain = [i for i in range(len(questions)) if i not in hop_set]
            if plain:
                rets = self.rag.query_batch(
                    [questions[i] for i in plain], mode=mode)
                with tr.span("compose", n=len(plain)):
                    if self.engine is not None:
                        texts = self._generate(
                            [self._prompt(questions[i], r.context)
                             for i, r in zip(plain, rets)],
                            [r.context for r in rets], batched=True)
                    else:
                        texts = [self.reader.answer(questions[i],
                                                    r.context)
                                 for i, r in zip(plain, rets)]
                for i, r, text in zip(plain, rets, texts):
                    out[i] = RAGAnswer(answer=text, context=r.context,
                                       n_context_tokens=r.n_tokens,
                                       hits=len(r.hits),
                                       epoch=getattr(r, "epoch", 0))
            if hop:
                for i, ans in zip(hop, self._multihop(
                        [questions[i] for i in hop], batched=True)):
                    out[i] = ans
        return out  # type: ignore[return-value]
