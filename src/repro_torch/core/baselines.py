"""Baseline retrieval systems the paper compares against (§IV).

- ``VanillaRAG``   — flat dense retrieval (no hierarchy, no summaries);
- ``BM25``         — sparse lexical retrieval (Robertson-Walker);
- ``RaptorLike``   — recursive k-means + summarize, rebuilt from
  scratch on every update (what RAPTOR must do: its GMM/k-means
  clustering is not stable under growth, the gap EraRAG targets);
- ``GraphRAGLike`` — entity co-occurrence graph + label-propagation
  communities + per-community summaries, fully rebuilt per update
  (mirrors GraphRAG's re-clustering cost profile).

All share EraRAG's tokenizer/embedder/summarizer and the same token
accounting so the paper's update-cost and accuracy comparisons are
apples-to-apples.

The dense baselines keep their embedding matrix on ``device`` (``cuda``
unless the caller passes another): ``VanillaRAG`` appends to it once
per insert, ``RaptorLike`` replaces it once per rebuild, and a query
moves only its own vector there and runs one ``mips_topk`` at b = 1.
Chunking, embedding, k-means (numpy, the same PCG64 seeds as the JAX
package, so cluster assignments are bitwise its own), BM25 scoring and
GraphRAG's label propagation stay on the host.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.graph import UpdateReport
from repro_torch.core.retrieve import Retrieval
from repro_torch.core.store import Hit
from repro_torch.core.summarize import ExtractiveSummarizer, Summarizer
from repro_torch.data.chunker import Chunk, chunk_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.mips_topk.ops import mips_topk
from repro_torch.obs.timers import timed_block


class _Base:
    """Shared doc bookkeeping + budgeted context assembly."""

    def __init__(self, cfg: EraRAGConfig, embedder, device=None):
        self.cfg = cfg
        self.embedder = embedder
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer()
        self.docs: List[Tuple[str, str]] = []
        self.reports: List[UpdateReport] = []

    @property
    def total_tokens(self) -> int:
        return sum(r.tokens_total for r in self.reports)

    @property
    def total_build_time(self) -> float:
        return sum(r.time_total for r in self.reports)

    def last_report(self) -> UpdateReport:
        return self.reports[-1] if self.reports else UpdateReport()

    def _budget(self, texts: Sequence[str], scores: Sequence[float],
                ids: Sequence[str]) -> Retrieval:
        picked: List[Hit] = []
        out: List[str] = []
        total = 0
        for t, s, i in zip(texts, scores, ids):
            n = self.tokenizer.count(t)
            if picked and total + n > self.cfg.token_budget:
                continue
            picked.append(Hit(node_id=i, score=float(s), layer=0))
            out.append(t)
            total += n
            if total >= self.cfg.token_budget:
                break
        return Retrieval(hits=picked, context="\n".join(out),
                         n_tokens=total)

    def _to_device(self, embs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(embs, np.float32)).to(self.device)

    def _scan(self, text: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """One query against ``self._embs``: its top-k scores and row
        indices (one ``mips_topk`` at b = 1; ties to the lowest row)."""
        q = self.embedder.encode([text])
        k_eff = min(k, self._embs.shape[0])
        vals, idx = mips_topk(self._to_device(q), self._embs, k_eff)
        return vals.cpu().numpy()[0], idx.cpu().numpy()[0]


class VanillaRAG(_Base):
    def __init__(self, cfg: EraRAGConfig, embedder, device=None):
        super().__init__(cfg, embedder, device)
        self.chunks: List[Chunk] = []
        self._embs: Optional[torch.Tensor] = None

    def insert_docs(self, docs: Iterable[Tuple[str, str]]) -> UpdateReport:
        docs = list(docs)
        self.docs.extend(docs)
        rep = UpdateReport()
        with timed_block(rep, "time_embed"):
            new = chunk_corpus(docs, self.tokenizer,
                               self.cfg.chunk_tokens)
            known = {x.chunk_id for x in self.chunks}
            new = [c for c in new if c.chunk_id not in known]
            rep.n_new_chunks = len(new)
            if new:
                embs = self._to_device(
                    self.embedder.encode([c.text for c in new]))
                self.chunks.extend(new)
                self._embs = embs if self._embs is None else \
                    torch.cat([self._embs, embs])
        self.reports.append(rep)
        return rep

    def query(self, text: str, k: Optional[int] = None,
              mode: str = "collapsed") -> Retrieval:
        k = k or self.cfg.top_k
        if not self.chunks:
            return Retrieval([], "", 0)
        vals, idx = self._scan(text, k)
        return self._budget([self.chunks[int(i)].text for i in idx],
                            vals.tolist(),
                            [self.chunks[int(i)].chunk_id for i in idx])


class BM25(_Base):
    K1 = 1.5
    B = 0.75

    def __init__(self, cfg: EraRAGConfig, embedder=None, device=None):
        super().__init__(cfg, embedder, device)
        self.chunks: List[Chunk] = []
        self.tf: List[Counter] = []
        self.df: Counter = Counter()
        self.lens: List[int] = []

    def insert_docs(self, docs: Iterable[Tuple[str, str]]) -> UpdateReport:
        docs = list(docs)
        self.docs.extend(docs)
        rep = UpdateReport()
        with timed_block(rep, "time_partition"):  # index time
            new = chunk_corpus(docs, self.tokenizer,
                               self.cfg.chunk_tokens)
            seen = {c.chunk_id for c in self.chunks}
            for c in new:
                if c.chunk_id in seen:
                    continue
                toks = [t.lower()
                        for t in self.tokenizer.tokenize(c.text)]
                tf = Counter(toks)
                self.chunks.append(c)
                self.tf.append(tf)
                self.lens.append(len(toks))
                for term in tf:
                    self.df[term] += 1
            rep.n_new_chunks = len(new)
        self.reports.append(rep)
        return rep

    def query(self, text: str, k: Optional[int] = None,
              mode: str = "collapsed") -> Retrieval:
        k = k or self.cfg.top_k
        n = len(self.chunks)
        if n == 0:
            return Retrieval([], "", 0)
        avg_len = sum(self.lens) / n
        q_terms = [t.lower() for t in self.tokenizer.tokenize(text)]
        scores = np.zeros(n, dtype=np.float64)
        for term in q_terms:
            df = self.df.get(term)
            if not df:
                continue
            idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
            for i, tf in enumerate(self.tf):
                f = tf.get(term, 0)
                if f:
                    denom = f + self.K1 * (1 - self.B +
                                           self.B * self.lens[i] / avg_len)
                    scores[i] += idf * f * (self.K1 + 1) / denom
        order = np.argsort(-scores, kind="stable")[:k]
        return self._budget([self.chunks[int(i)].text for i in order],
                            scores[order].tolist(),
                            [self.chunks[int(i)].chunk_id for i in order])


def _kmeans(embs: np.ndarray, n_clusters: int, seed: int = 0,
            iters: int = 10) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(seed))
    n = embs.shape[0]
    n_clusters = min(n_clusters, n)
    centers = embs[rng.choice(n, size=n_clusters, replace=False)]
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        sims = embs @ centers.T
        assign = np.argmax(sims, axis=1)
        for c in range(n_clusters):
            m = assign == c
            if m.any():
                v = embs[m].mean(axis=0)
                nv = np.linalg.norm(v)
                centers[c] = v / (nv if nv > 0 else 1.0)
    return assign


class RaptorLike(_Base):
    """Recursive k-means + summarization, rebuilt per update."""

    def __init__(self, cfg: EraRAGConfig, embedder,
                 summarizer: Optional[Summarizer] = None, device=None):
        super().__init__(cfg, embedder, device)
        self.summarizer = summarizer or ExtractiveSummarizer(
            embedder, cfg.summary_max_tokens, self.tokenizer)
        self.texts: List[str] = []
        self.ids: List[str] = []
        self._embs: Optional[torch.Tensor] = None

    def _encode_all(self, texts: List[str]) -> torch.Tensor:
        """The rebuilt index's embedding matrix, on the device."""
        embs = self.embedder.encode(texts) if texts else \
            np.zeros((0, self.cfg.embed_dim), np.float32)
        return self._to_device(embs)

    def _rebuild(self, rep: UpdateReport) -> None:
        chunks = chunk_corpus(self.docs, self.tokenizer,
                              self.cfg.chunk_tokens)
        texts = [c.text for c in chunks]
        ids = [c.chunk_id for c in chunks]
        with timed_block(rep, "time_embed"):
            embs = self.embedder.encode(texts) if texts else \
                np.zeros((0, self.cfg.embed_dim), np.float32)
        level = 0
        cur_texts, cur_embs = list(texts), embs
        target = (self.cfg.s_min + self.cfg.s_max) / 2
        while len(cur_texts) > self.cfg.s_max and \
                level < self.cfg.max_layers:
            with timed_block(rep, "time_partition"):
                n_clusters = max(1,
                                 int(round(len(cur_texts) / target)))
                assign = _kmeans(cur_embs, n_clusters, seed=level)
            nxt_texts: List[str] = []
            for c in range(assign.max() + 1):
                members = [cur_texts[i] for i in
                           np.nonzero(assign == c)[0]]
                if not members:
                    continue
                with timed_block(rep, "time_summarize"):
                    res = self.summarizer.summarize(members)
                rep.tokens_in += res.tokens_in
                rep.tokens_out += res.tokens_out
                rep.n_resummarized += 1
                nxt_texts.append(res.text)
            texts.extend(nxt_texts)
            ids.extend(f"sum-{level}-{i}"
                       for i in range(len(nxt_texts)))
            with timed_block(rep, "time_embed"):
                cur_embs = self.embedder.encode(nxt_texts) \
                    if nxt_texts \
                    else np.zeros((0, self.cfg.embed_dim), np.float32)
            cur_texts = nxt_texts
            level += 1
        self.texts, self.ids = texts, ids
        with timed_block(rep, "time_embed"):
            self._embs = self._encode_all(texts)

    def insert_docs(self, docs: Iterable[Tuple[str, str]]) -> UpdateReport:
        self.docs.extend(list(docs))
        rep = UpdateReport()
        rep.n_new_chunks = len(self.docs)
        self._rebuild(rep)   # full reconstruction every time
        self.reports.append(rep)
        return rep

    def query(self, text: str, k: Optional[int] = None,
              mode: str = "collapsed") -> Retrieval:
        k = k or self.cfg.top_k
        if not self.texts:
            return Retrieval([], "", 0)
        vals, idx = self._scan(text, k)
        return self._budget([self.texts[int(i)] for i in idx],
                            vals.tolist(),
                            [self.ids[int(i)] for i in idx])


class GraphRAGLike(RaptorLike):
    """Entity-graph + community summaries, fully rebuilt per update.

    Heavier than RAPTOR: every chunk pair sharing an entity adds an
    edge; label propagation finds communities; every community is
    re-summarized on every rebuild -- reproducing GraphRAG's cost
    profile (paper: 'performs full re-clustering after each update').
    """

    def _communities(self, chunks: List[Chunk]) -> List[List[int]]:
        ent_chunks: Dict[str, List[int]] = defaultdict(list)
        for i, c in enumerate(chunks):
            for t in self.tokenizer.tokenize(c.text):
                if t.startswith(("ent_", "val_", "topic_")):
                    ent_chunks[t].append(i)
        n = len(chunks)
        labels = np.arange(n)
        adj: Dict[int, set] = defaultdict(set)
        for members in ent_chunks.values():
            for a in members:
                adj[a].update(m for m in members if m != a)
        for _ in range(5):  # label propagation rounds
            changed = False
            for i in range(n):
                if not adj[i]:
                    continue
                cnt = Counter(labels[j] for j in adj[i])
                best = min(cnt, key=lambda l: (-cnt[l], l))
                if labels[i] != best:
                    labels[i] = best
                    changed = True
            if not changed:
                break
        comms: Dict[int, List[int]] = defaultdict(list)
        for i, l in enumerate(labels):
            comms[int(l)].append(i)
        return list(comms.values())

    def _rebuild(self, rep: UpdateReport) -> None:
        chunks = chunk_corpus(self.docs, self.tokenizer,
                              self.cfg.chunk_tokens)
        texts = [c.text for c in chunks]
        ids = [c.chunk_id for c in chunks]
        # GraphRAG's indexing runs an entity/relation-extraction LLM
        # call over EVERY chunk on every rebuild (its dominant cost,
        # which the paper contrasts against: 'GraphRAG performs full
        # re-clustering after each update').  tokens_in = chunk text,
        # tokens_out ~ extracted triple list.
        with timed_block(rep, "time_summarize"):
            for c in chunks:
                rep.tokens_in += c.n_tokens
                rep.tokens_out += max(8, c.n_tokens // 4)
        with timed_block(rep, "time_partition"):
            comms = self._communities(chunks)
        for ci, members in enumerate(comms):
            if len(members) < 2:
                continue
            with timed_block(rep, "time_summarize"):
                res = self.summarizer.summarize(
                    [texts[i] for i in members])
            rep.tokens_in += res.tokens_in
            rep.tokens_out += res.tokens_out
            rep.n_resummarized += 1
            texts.append(res.text)
            ids.append(f"comm-{ci}")
        self.texts, self.ids = texts, ids
        with timed_block(rep, "time_embed"):
            self._embs = self._encode_all(texts)
