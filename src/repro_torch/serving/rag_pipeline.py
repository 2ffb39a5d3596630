"""End-to-end RAG serving: EraRAG retrieval -> context -> reader.

The paper's Alg 2 as a service: questions retrieve a budgeted context
from the hierarchical graph and the deterministic ``ExtractiveReader``
answers from it, so Accuracy / Recall are measurable offline
(containment metric, §IV).  ``answer_batch`` micro-batches questions
end-to-end — one retrieval scan per round for the whole question block
(``EraRAG.query_batch``); two-hop-shaped questions batch through the
two-round multihop machinery.  ``answer`` is the sequential
per-question oracle ``answer_batch`` must match answer for answer.

Served here: the reader path (``engine=None``).  An LM reader, an
attached ingest service and ``index_report`` raise
``NotImplementedError``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.erarag import EraRAG
from repro_torch.core.retrieve import Retrieval, default_bridge_fn, \
    is_hop_question
from repro_torch.common.config import not_ported


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
        if engine is not None:
            raise not_ported("an LM reader (engine=...)",
                              "LM serving")
        if ingest is not None:
            raise not_ported("an attached ingest service", "ingest")
        self.rag = rag
        self.reader = reader or ExtractiveReader()

    def index_report(self) -> dict:
        raise not_ported("RAGPipeline.index_report",
                          "lifecycle and checkpoint")

    def _multihop(self, questions: List[str], batched: bool
                  ) -> List[RAGAnswer]:
        """Two-round multihop answering.  ``batched=True`` serves the
        block as ONE round-1 retrieval batch and ONE round-2 batch;
        ``batched=False`` is the sequential per-question oracle."""
        if batched:
            rets = self.rag.query_batch(questions, mode="multihop")
        else:
            rets = [self.rag.query(q, mode="multihop")
                    for q in questions]
        with self.rag.obs.tracer.span("compose", n=len(questions),
                                      multihop=True):
            texts = [self.reader.answer(r.bridge_query or q, r.context)
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
            if mode == "multihop" or is_hop_question(question):
                return self._multihop([question], batched=False)[0]
            r = self.rag.query(question, mode=mode)
            with tr.span("compose", n=1):
                text = self.reader.answer(question, r.context)
            return RAGAnswer(answer=text, context=r.context,
                             n_context_tokens=r.n_tokens,
                             hits=len(r.hits),
                             epoch=getattr(r, "epoch", 0))

    def answer_batch(self, questions: Sequence[str],
                     mode: str = "collapsed") -> List[RAGAnswer]:
        """Answer a question block with shared scans: one batched
        retrieval scan per round.  ``mode='multihop'`` batches both
        rounds end-to-end; two-hop-shaped questions route through the
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
                   if is_hop_question(q)]
            hop_set = set(hop)
            plain = [i for i in range(len(questions)) if i not in hop_set]
            if plain:
                rets = self.rag.query_batch(
                    [questions[i] for i in plain], mode=mode)
                with tr.span("compose", n=len(plain)):
                    texts = [self.reader.answer(questions[i], r.context)
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
