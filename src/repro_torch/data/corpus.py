"""Deterministic synthetic corpus + QA generator.

The paper evaluates on QA corpora (PopQA/HotpotQA/QuALITY/...) with a
*containment* correctness metric: a prediction is correct if it contains
the gold answer.  To make the benchmark harness self-contained and
exactly reproducible offline, we generate corpora with the same
statistical structure the paper's datasets exercise:

- **topical clustering**: documents draw words from per-topic vocabularies,
  so embedding similarity has real cluster structure for LSH to find;
- **planted facts**: (entity, relation, value) triples embedded in
  sentences — *detailed* queries ask for a value (answerable from one
  leaf chunk);
- **multi-hop facts**: chains entity→e2, e2→value spread across two
  documents — queries need two retrieval hops (HotpotQA/MuSiQue style);
- **thematic structure**: topic-level summary queries answerable only by
  aggregating several chunks (QuALITY style) — these are what summary
  nodes help with.

Every item is derived from ``numpy.random.Generator(seed)`` so two
processes generate identical corpora.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

_SYLLABLES = ["ba", "ce", "di", "fo", "gu", "ha", "ki", "lo", "mu", "na",
              "pe", "qi", "ro", "su", "ta", "vu", "wa", "xe", "yo", "zu"]

_RELATIONS = ["capital", "founder", "color", "origin", "material",
              "language", "currency", "leader", "element", "symbol"]


def _word(rng: np.random.Generator, n_syll: int = 3) -> str:
    return "".join(rng.choice(_SYLLABLES) for _ in range(n_syll))


@dataclass(frozen=True)
class QAItem:
    question: str
    answer: str
    kind: str            # detailed | multihop | summary
    doc_ids: Tuple[str, ...]


@dataclass
class SyntheticCorpus:
    docs: List[Tuple[str, str]] = field(default_factory=list)
    qa: List[QAItem] = field(default_factory=list)
    topics: List[str] = field(default_factory=list)

    @staticmethod
    def generate(n_docs: int = 200, n_topics: int = 8,
                 sentences_per_doc: int = 20, facts_per_doc: int = 4,
                 seed: int = 0) -> "SyntheticCorpus":
        rng = np.random.Generator(np.random.PCG64(seed))
        topics = [f"topic_{_word(rng, 2)}" for _ in range(n_topics)]
        # per-topic filler vocabulary: gives embeddings cluster structure
        topic_vocab = {t: [_word(rng) for _ in range(60)] for t in topics}
        corpus = SyntheticCorpus(topics=topics)
        entity_of_doc: Dict[str, str] = {}
        facts: List[Tuple[str, str, str, str]] = []  # (doc, ent, rel, val)

        for i in range(n_docs):
            topic = topics[i % n_topics]
            doc_id = f"doc{i:05d}"
            entity = f"ent_{_word(rng)}"
            entity_of_doc[doc_id] = entity
            vocab = topic_vocab[topic]
            sents: List[str] = [
                f"This article describes {entity} in the context of "
                f"{topic}."]
            rels = rng.choice(len(_RELATIONS), size=facts_per_doc,
                              replace=False)
            for r in rels:
                rel = _RELATIONS[int(r)]
                val = f"val_{_word(rng)}"
                facts.append((doc_id, entity, rel, val))
                sents.append(f"The {rel} of {entity} is {val}.")
            while len(sents) < sentences_per_doc:
                ws = [vocab[int(j)] for j in
                      rng.integers(0, len(vocab), size=9)]
                sents.append(
                    f"In {topic}, {ws[0]} {ws[1]} {ws[2]} relates "
                    f"{ws[3]} {ws[4]} to {ws[5]} via {ws[6]} {ws[7]} "
                    f"{ws[8]}.")
            order = rng.permutation(len(sents) - 1) + 1
            body = " ".join([sents[0]] + [sents[int(k)] for k in order])
            corpus.docs.append((doc_id, body))

        # detailed QA: one per fact (capped)
        for doc_id, ent, rel, val in facts:
            corpus.qa.append(QAItem(
                question=f"What is the {rel} of {ent}?",
                answer=val, kind="detailed", doc_ids=(doc_id,)))

        # multihop QA: entity A's relation points at entity B (by name),
        # question asks for B's fact — needs both docs.
        n_hops = max(1, n_docs // 10)
        for _ in range(n_hops):
            i, j = rng.integers(0, n_docs, size=2)
            if i == j:
                continue
            da, db = f"doc{i:05d}", f"doc{j:05d}"
            ea, eb = entity_of_doc[da], entity_of_doc[db]
            db_facts = [f for f in facts if f[0] == db]
            if not db_facts:
                continue
            _, _, rel, val = db_facts[int(rng.integers(len(db_facts)))]
            bridge = f"The partner of {ea} is {eb}."
            # append bridge sentence to doc A
            for k, (d_id, text) in enumerate(corpus.docs):
                if d_id == da:
                    corpus.docs[k] = (d_id, text + " " + bridge)
            corpus.qa.append(QAItem(
                question=f"What is the {rel} of the partner of {ea}?",
                answer=val, kind="multihop", doc_ids=(da, db)))

        # summary QA: which entities appear under a topic
        for t_idx, topic in enumerate(topics):
            ents = [entity_of_doc[f"doc{i:05d}"]
                    for i in range(n_docs) if i % n_topics == t_idx]
            if len(ents) >= 2:
                corpus.qa.append(QAItem(
                    question=f"Name an entity described in the context "
                             f"of {topic}.",
                    answer=ents[0], kind="summary",
                    doc_ids=tuple(f"doc{i:05d}" for i in range(n_docs)
                                  if i % n_topics == t_idx)))
        return corpus

    def split(self, frac: float) -> Tuple[List[Tuple[str, str]],
                                          List[Tuple[str, str]]]:
        """Initial/growing split (paper: 50/50)."""
        n = int(len(self.docs) * frac)
        return self.docs[:n], self.docs[n:]

    def growth_rounds(self, init_frac: float = 0.5,
                      n_rounds: int = 10) -> Tuple[
                          List[Tuple[str, str]],
                          List[List[Tuple[str, str]]]]:
        init, rest = self.split(init_frac)
        if n_rounds <= 0 or not rest:
            return init, []
        per = max(1, len(rest) // n_rounds)
        rounds = [rest[i * per:(i + 1) * per] for i in range(n_rounds)]
        leftover = rest[n_rounds * per:]
        if leftover:
            rounds[-1] = rounds[-1] + leftover
        return init, [r for r in rounds if r]
