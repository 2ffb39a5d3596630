"""Query processing (paper Alg 2) + adaptive detailed/summarized search.

Collapsed search treats every node — leaf chunks and summaries — as one
flat retrieval space; adaptive search splits the budget ``k`` into a
``p`` fraction taken from the preferred granularity and the remainder
from the other (paper §III.D).  Both enforce the token budget ``T`` by
greedy truncation of the score-ordered candidates.

Every search comes in a batched variant (``*_search_batch``) that
serves a whole ``(B, d)`` query block with one ``mips_topk`` call per
store scan; the single-query functions are the B=1 special case, so
batched and looped results are identical by construction.
``multihop_search_batch`` extends the discipline to two-round
retrieval: round 1 serves the entire question block as one batch, a
pluggable ``bridge_fn`` resolves per-question follow-up queries, and
the follow-ups form one round-2 batch — so a B-question multihop block
costs at most two batched retrieval rounds regardless of B.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.store import AnyStore, Hit
from repro_torch.data.tokenizer import HashTokenizer


@dataclass
class Retrieval:
    hits: List[Hit]
    context: str
    n_tokens: int
    # index epoch that served the scan (bumped by every committed
    # reshard migration; the flat store stays at 0)
    epoch: int = 0


@dataclass
class HopRetrieval(Retrieval):
    """Two-round retrieval result.  ``context`` is the composed reader
    context (round-1 + round-2 when the question hopped); ``rounds``
    keeps the per-round retrievals, ``bridge_query`` the resolved
    follow-up query, and ``hops == 1`` marks a question that
    short-circuited after round 1 (no bridge found)."""
    hops: int = 1
    bridge_query: Optional[str] = None
    rounds: Tuple[Retrieval, ...] = field(default_factory=tuple)


def _budgeted(graph, hits: Sequence[Hit], budget: int,
              tokenizer: HashTokenizer) -> Retrieval:
    """Greedy score-ordered truncation of the context to ``budget``
    tokens (paper Alg 2): take hits in score order until the next one
    no longer fits, then STOP — a later (lower-scored) hit must never
    leapfrog a skipped higher-scored one.  The top hit is always kept:
    when it alone exceeds the budget its text is truncated to exactly
    ``budget`` tokens, so the composed context never blows the budget
    either."""
    picked: List[Hit] = []
    texts: List[str] = []
    total = 0
    for h in hits:
        node = graph.nodes[h.node_id]
        n = node.n_tokens or tokenizer.count(node.text)
        if total + n > budget:
            if not picked:
                # an answer needs at least its best hit: truncate the
                # text to the budget instead of returning nothing
                picked.append(h)
                texts.append(" ".join(
                    tokenizer.tokenize(node.text)[:budget]))
                total = budget
            break
        picked.append(h)
        texts.append(node.text)
        total += n
        if total >= budget:
            break
    return Retrieval(hits=picked, context="\n".join(texts),
                     n_tokens=total)


def collapsed_search_batch(graph, store: AnyStore, query_embs,
                           k: int, token_budget: int,
                           tokenizer: Optional[HashTokenizer] = None
                           ) -> List[Retrieval]:
    tok = tokenizer or HashTokenizer()
    hits_b = store.search_batch(np.asarray(query_embs), k)
    out = [_budgeted(graph, hits, token_budget, tok)
           for hits in hits_b]
    for r in out:
        r.epoch = store.epoch
    return out


def collapsed_search(graph, store: AnyStore, query_emb, k: int,
                     token_budget: int,
                     tokenizer: Optional[HashTokenizer] = None
                     ) -> Retrieval:
    return collapsed_search_batch(
        graph, store, np.asarray(query_emb)[None, :], k, token_budget,
        tokenizer)[0]


def adaptive_search_batch(graph, store: AnyStore, query_embs,
                          k: int, token_budget: int, p: float,
                          mode: str = "detailed",
                          tokenizer: Optional[HashTokenizer] = None
                          ) -> List[Retrieval]:
    """mode='detailed': top-pk from leaves + top-(k-pk) from summaries;
    mode='summarized': the reverse (paper §III.D)."""
    if mode not in ("detailed", "summarized"):
        raise ValueError(mode)
    tok = tokenizer or HashTokenizer()
    q = np.asarray(query_embs)
    n_q = q.shape[0]
    k_primary = max(0, min(k, int(round(p * k))))
    k_rest = k - k_primary
    primary = "leaf" if mode == "detailed" else "summary"
    secondary = "summary" if mode == "detailed" else "leaf"
    prim_b = store.search_batch(q, k_primary, layer_filter=primary) \
        if k_primary else [[] for _ in range(n_q)]
    rest_b = store.search_batch(q, k_rest, layer_filter=secondary) \
        if k_rest else [[] for _ in range(n_q)]
    out: List[Retrieval] = []
    for prim, rest in zip(prim_b, rest_b):
        hits = prim + rest
        # score ties between the two layer scans break on insertion
        # seq (the kernel-side lowest-index rule): without it the
        # budgeted context would depend on which layer was scanned
        # first, making adaptive search order-sensitive
        hits.sort(key=lambda h: (-h.score, h.seq))
        out.append(_budgeted(graph, hits, token_budget, tok))
    for r in out:
        r.epoch = store.epoch
    return out


def adaptive_search(graph, store: AnyStore, query_emb, k: int,
                    token_budget: int, p: float,
                    mode: str = "detailed",
                    tokenizer: Optional[HashTokenizer] = None
                    ) -> Retrieval:
    return adaptive_search_batch(
        graph, store, np.asarray(query_emb)[None, :], k, token_budget,
        p, mode, tokenizer)[0]


# ---------------------------------------------------------------------------
# batched multihop (two-round) retrieval
# ---------------------------------------------------------------------------
# Surface form of the corpus generator's two-hop questions
# (HotpotQA/MuSiQue style): the question names a bridge relation
# ("partner of X"), round 1 must retrieve the bridge fact, and the
# follow-up query asks the original relation of the bridge entity.
_HOP_QUESTION = re.compile(r"partner of (\w+)")
_HOP_RELATION = re.compile(r"What is the (\w+) of")

BridgeFn = Callable[[Sequence[str], Sequence[Retrieval]],
                    List[Optional[str]]]


def is_hop_question(question: str) -> bool:
    """Does the question have the two-hop surface form?  The single
    gate used by the retrieval bridge, the serving pipeline's implicit
    multihop routing, and the extractive reader."""
    return _HOP_QUESTION.search(question) is not None


def compose_hop_query(question: str, entity: str) -> str:
    """Round-2 query: re-ask the question's relation of the resolved
    bridge entity (falls back to the entity itself as the query)."""
    m = _HOP_RELATION.search(question)
    return f"What is the {m.group(1)} of {entity}?" if m else entity


def default_bridge_fn(questions: Sequence[str],
                      retrievals: Sequence[Retrieval]
                      ) -> List[Optional[str]]:
    """Deterministic (regex) bridge resolution: returns one follow-up
    query per question, or ``None`` to short-circuit after round 1 —
    either the question is not two-hop shaped, or its bridge fact was
    not retrieved.  Serving layers with an LM reader keep this gate and
    replace only the entity resolution."""
    out: List[Optional[str]] = []
    for q, r in zip(questions, retrievals):
        m = _HOP_QUESTION.search(q)
        bridge = m and re.search(
            rf"The partner of {re.escape(m.group(1))} is (\w+)",
            r.context)
        out.append(compose_hop_query(q, bridge.group(1))
                   if bridge else None)
    return out


def multihop_search_batch(graph, store: AnyStore, embed,
                          questions: Sequence[str], k: int,
                          token_budget: int, p: float,
                          bridge_fn: Optional[BridgeFn] = None,
                          round_mode: str = "detailed",
                          tokenizer: Optional[HashTokenizer] = None
                          ) -> List[HopRetrieval]:
    """Two-round batched retrieval: the serving multihop path.

    Round 1 serves ALL questions as one batched search; ``bridge_fn``
    maps (questions, round-1 retrievals) to a per-question follow-up
    query or None; the non-None follow-ups form ONE round-2 batch and
    contexts compose per question.  Any block size costs at most two
    batched retrieval rounds, and the B=1 case is the sequential
    oracle the differential serving suite compares against.

    ``embed`` maps a list of texts to a (B, d) query block (the
    follow-up queries are new text and must be embedded here);
    ``round_mode`` selects the per-round search (collapsed | detailed
    | summarized — multihop defaults to detailed-biased adaptive
    search, the paper's granularity for fact questions).
    """
    tok = tokenizer or HashTokenizer()
    bridge_fn = bridge_fn or default_bridge_fn
    questions = list(questions)

    def _round(texts: List[str]) -> List[Retrieval]:
        q = np.asarray(embed(texts))
        if round_mode == "collapsed":
            return collapsed_search_batch(graph, store, q, k,
                                          token_budget, tok)
        return adaptive_search_batch(graph, store, q, k, token_budget,
                                     p, round_mode, tok)

    r1 = _round(questions)
    bridges = list(bridge_fn(questions, r1))
    follow = [i for i, b in enumerate(bridges) if b]
    r2 = _round([bridges[i] for i in follow]) if follow else []
    out = [HopRetrieval(hits=list(r.hits), context=r.context,
                        n_tokens=r.n_tokens, epoch=r.epoch, hops=1,
                        rounds=(r,))
           for r in r1]
    for i, rb in zip(follow, r2):
        ra = r1[i]
        out[i] = HopRetrieval(
            hits=list(ra.hits) + list(rb.hits),
            context=ra.context + "\n" + rb.context,
            n_tokens=ra.n_tokens + rb.n_tokens, epoch=rb.epoch,
            hops=2, bridge_query=bridges[i], rounds=(ra, rb))
    return out
