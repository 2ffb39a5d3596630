"""Batched LM serving engine (continuous-batching lite + KV prefix
reuse).

Requests queue up; the engine admits them into fixed decode slots with
*bucketed prefill*: each admission wave drains the queue into the free
slots, groups the pending prompts by padded length (pow-2 buckets up
to ``max_seq_len``), and runs ONE ``prefill_padded`` launch per bucket
over a ``max_batch``-wide block — a length mask picks each row's true
last position, and each row's K/V land straight in its slot of the
shared cache.  ``stats['prefill_launches']`` vs
``stats['prefill_prompts']`` measures that sharing.  Decode is
*micro-batched* the same way: active slots are grouped by cache length
and each group shares ONE ``decode_step`` launch over all
``max_batch`` rows; ``stats['decode_launches']`` vs
``stats['slot_steps']`` is the decode-side sharing ratio.  Slots free
as soon as a sequence emits EOS or hits its token budget and are
refilled from the queue.  Over-long prompts are truncated
deterministically to ``max_seq_len - budget - 1`` tokens at admission,
so a mis-sized request can never spill into a neighbor slot's cache.

**KV prefix reuse** (``EngineConfig.prefix_cache_entries > 0``):
callers may declare a reusable leading block of the prompt — the RAG
pipeline passes the composed retrieval context, so N questions over
one retrieved context pay its prefill once.  Admission hashes the
prefix's token ids; on a hit the cached prefix K/V rows are copied
into the slot's cache, only the *suffix* runs through a
``prefill_extend`` launch (global RoPE positions, per-row cache
offsets), and the slot decodes from the full combined length.  On a
miss the prefix slice of the freshly prefilled slot is copied into an
LRU keyed by the prefix token hash.  A prefix is only reused when its
token ids survive truncation intact and the suffix bucket still fits
(``plen + bucket(suffix) <= max_seq_len``); otherwise the request
takes the cold path.  Disabled (the default) the engine is the
pre-cache engine.

Every launch keeps the ``(max_batch, ·)`` shapes, so a row's result
does not depend on how many rows are live, and writes the shared cache
only at the rows it serves: the rest of the cache is never copied, and
rows outside the launch's group are left as they were.  Those rows
still compute what the reference computes for them, and an MoE layer
needs that: its experts' capacity is shared by every token of a launch,
so a row's garbage can take a slot from a served row.  So a cold
admission gives its slot the reference's whole new cache row (its K/V,
zeros past the bucket), and in decode and suffix prefill every row
attends over its own new K/V (``layers._attend_written``), as the
reference's rows do in the caches it builds and then drops.  The cache
thus holds, position for position, what the reference's holds.  The
engine holds its ``LM`` in its compute dtype (a model in another dtype
is cast once, at construction), and runs every call under
``torch.inference_mode``.

This is the LLM backend for EraRAG's summarizer (``LMSummarizer``) and
for ``RAGPipeline``'s LM reader and multihop bridge extraction.
"""
from __future__ import annotations

import hashlib
import queue
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import LMConfig
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, HashTokenizer
from repro_torch.models import transformer as T
from repro_torch.obs.trace import NULL_TRACER


@dataclass
class EngineConfig:
    max_batch: int = 4
    max_seq_len: int = 512
    max_new_tokens: int = 64
    compute_dtype: torch.dtype = torch.float32
    # KV prefix cache capacity (reusable prompt-prefix K/V blocks held
    # across requests); 0 disables reuse
    prefix_cache_entries: int = 0


@dataclass
class _Slot:
    active: bool = False
    length: int = 0
    budget: int = 0
    out_tokens: List[int] = field(default_factory=list)
    request_id: int = -1


def _in_dtype(model: T.LM, dtype: torch.dtype) -> T.LM:
    """``model`` itself when its weights are in the dtypes an ``LM`` of
    ``dtype`` holds (an MoE router stays fp32), else a copy cast to
    them.  ``final_norm`` keeps its dtype: the reference widens it to
    fp32 inside the norm, never rounding it to the compute dtype."""
    held = T.LM(model.cfg, dtype, "meta")
    if all(p.dtype == q.dtype for p, q in zip(model.parameters(),
                                               held.parameters())):
        return model
    cast = T.LM(model.cfg, dtype, model.device)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(cast.named_parameters(),
                                      model.named_parameters()):
            dst.copy_(src)
    cast.final_norm = torch.nn.Parameter(model.final_norm.detach().clone())
    return cast


class Engine:
    # span recorder for the serving path; RAGPipeline swaps in the
    # pipeline's Observability tracer (inert no-op by default)
    tracer = NULL_TRACER

    def __init__(self, cfg: LMConfig, model: T.LM, ecfg: EngineConfig,
                 tokenizer: Optional[HashTokenizer] = None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.model = _in_dtype(model, ecfg.compute_dtype)
        self.device = self.model.device
        self.tok = tokenizer or HashTokenizer(cfg.vocab_size)
        self.slots = [_Slot() for _ in range(ecfg.max_batch)]
        with torch.inference_mode():
            self.caches = T.make_kv_cache(cfg, ecfg.max_batch,
                                          ecfg.max_seq_len,
                                          ecfg.compute_dtype, self.device)
        self._queue: "queue.Queue" = queue.Queue()
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        # launch-sharing instrumentation: slot_steps counts (slot,
        # token) decode units, decode_launches the launches that served
        # them; prefill_prompts counts admitted prompts,
        # prefill_launches the bucketed prefill launches that served
        # them; generate_batches counts ``generate_batch`` calls (the
        # pipeline's multihop path costs exactly two per question
        # block); prefix_hits / prefix_tokens_saved: admissions served
        # from the KV prefix cache and the prompt tokens not prefilled
        self.stats = {"decode_launches": 0, "slot_steps": 0,
                      "prefill_launches": 0, "prefill_prompts": 0,
                      "generate_batches": 0, "prefix_hits": 0,
                      "prefix_tokens_saved": 0}
        # prefix token-hash -> ({"k", "v"} (n_layers, hkv, plen, hd)
        # copies, plen), LRU
        self._prefix_cache: "OrderedDict[bytes, Tuple[Dict, int]]" = \
            OrderedDict()

    # the three launches, as attributes like the reference's jitted
    # callables (a caller may wrap one to time or observe it)
    def _prefill_bucket(self, tokens, lengths, slots):
        return T.prefill_padded(self.model, tokens, lengths, self.cfg,
                                compute_dtype=self.ecfg.compute_dtype,
                                caches=self.caches, slots=slots)

    def _decode_step(self, tokens, length, rows):
        return T.decode_step(self.model, tokens, self.caches, length,
                             self.cfg, compute_dtype=self.ecfg.compute_dtype,
                             rows=rows)

    def _prefill_extend(self, tokens, lengths, offsets, rows):
        return T.prefill_extend(self.model, tokens, lengths, offsets,
                                self.caches, self.cfg,
                                compute_dtype=self.ecfg.compute_dtype,
                                rows=rows)

    # ------------------------------------------------------------------
    def submit(self, prompt: str, max_new_tokens: Optional[int] = None,
               prefix: Optional[str] = None) -> int:
        """Queue a request.  ``max_new_tokens=None`` falls back to the
        engine default; an explicit non-positive budget is a caller bug
        and raises.  ``prefix`` declares a reusable leading block of the
        prompt (the composed retrieval context) for the KV prefix cache
        — it must be a string prefix of ``prompt``."""
        if max_new_tokens is None:
            max_new_tokens = self.ecfg.max_new_tokens
        elif max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prefix is not None and not prompt.startswith(prefix):
            raise ValueError("prefix is not a prefix of prompt")
        rid = self._next_id
        self._next_id += 1
        self._queue.put((rid, prompt, max_new_tokens, prefix))
        return rid

    @property
    def launches(self) -> int:
        """Total launches issued so far (bucketed prefill + micro-batched
        decode): an N-segment update through ``generate_batch`` must
        cost O(length buckets), not N, launch growth."""
        return (self.stats["prefill_launches"]
                + self.stats["decode_launches"])

    def generate(self, prompt: str, max_new_tokens: Optional[int] = None,
                 prefix: Optional[str] = None) -> str:
        return self.generate_batch([prompt], max_new_tokens,
                                   prefixes=[prefix])[0]

    def generate_batch(self, prompts: List[str],
                       max_new_tokens: Optional[int] = None,
                       prefixes: Optional[List[Optional[str]]] = None
                       ) -> List[str]:
        """Submit a prompt batch before draining so concurrent requests
        land in slots together and share prefill + decode launches.
        ``prefixes`` optionally declares each prompt's reusable context
        block for the KV prefix cache (None entries opt out)."""
        if not prompts:
            return []
        self.stats["generate_batches"] += 1
        prefixes = prefixes or [None] * len(prompts)
        rids = [self.submit(p, max_new_tokens, prefix=px)
                for p, px in zip(prompts, prefixes)]
        self.run_until_done()
        out = []
        for r in rids:
            toks = self._results.pop(r)
            if toks and toks[-1] == EOS_ID:
                # the EOS sentinel is a stop signal, not text
                toks = toks[:-1]
            out.append(" ".join(f"tok{t}" for t in toks))
        return out

    # ------------------------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        """Pow-2 padded length bucket, capped at ``max_seq_len``."""
        length = 8
        while length < n:
            length *= 2
        return min(length, self.ecfg.max_seq_len)

    def _prefix_tokens(self, prefix: str, ids: List[int]
                       ) -> Optional[List[int]]:
        """Prefix token ids ([BOS] + prefix words) when they survive in
        ``ids`` intact with a nonempty suffix after them, else None."""
        pt = [BOS_ID] + [int(t) for t in
                         self.tok.encode(prefix, add_special=False)]
        if len(pt) < len(ids) and ids[: len(pt)] == pt:
            return pt
        return None

    @staticmethod
    def _prefix_key(ptoks: List[int]) -> bytes:
        return hashlib.blake2b(
            np.asarray(ptoks, np.int32).tobytes(),
            digest_size=16).digest()

    def _pick(self, logits: torch.Tensor, rows: List[int],
              keys: List[Tuple[int, int]]) -> List[int]:
        """Every row's greedy token (the first index on ties). ``rows``
        are the rows that serve a request, ``keys`` each one's (request
        id, step): an observer that wraps this method reads them."""
        return torch.argmax(logits, dim=-1).tolist()

    def _admit(self) -> None:
        """Drain the queue into free slots with bucketed prefill (cold
        prompts) and suffix-only prefill (prefix-cache hits)."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        cold, hits = [], []
        while free and not self._queue.empty():
            rid, prompt, budget, prefix = self._queue.get()
            budget = max(1, min(budget, self.ecfg.max_seq_len - 2))
            ids = self.tok.encode(prompt, add_special=True)
            ids = [int(t) for t in
                   ids[: max(1, self.ecfg.max_seq_len - budget - 1)]]
            pkey, plen = None, 0
            if prefix is not None and self.ecfg.prefix_cache_entries:
                ptoks = self._prefix_tokens(prefix, ids)
                if ptoks is not None:
                    pkey, plen = self._prefix_key(ptoks), len(ptoks)
            item = (free.pop(0), rid, ids, budget, pkey, plen)
            # a hit admits through suffix-only prefill when the suffix
            # bucket still fits behind the prefix; else degrade to cold
            if pkey is not None and pkey in self._prefix_cache and \
                    plen + self._bucket_len(len(ids) - plen) \
                    <= self.ecfg.max_seq_len:
                hits.append(item)
            else:
                cold.append(item)
        self._admit_cold(cold)
        self._admit_hits(hits)

    def _admit_cold(self, pending: List[tuple]) -> None:
        if not pending:
            return
        buckets: Dict[int, list] = {}
        for item in pending:
            buckets.setdefault(self._bucket_len(len(item[2])),
                               []).append(item)
        for blen, group in sorted(buckets.items()):
            tokens = np.zeros((self.ecfg.max_batch, blen), np.int32)
            lengths = np.zeros((self.ecfg.max_batch,), np.int32)
            for j, (_, _, ids, *_rest) in enumerate(group):
                tokens[j, :len(ids)] = ids
                lengths[j] = len(ids)
            slots = [i for i, *_ in group]
            with self.tracer.span("prefill", bucket=blen,
                                  prompts=len(group), prefix_hit=False):
                logits, _ = self._prefill_bucket(tokens, lengths, slots)
                # the rest of each slot's row as in the reference's new
                # cache: zeros past the bucket
                for c in self.caches.values():
                    c[:, slots, :, blen:] = 0
            self.stats["prefill_launches"] += 1
            self.stats["prefill_prompts"] += len(group)
            firsts = self._pick(logits, list(range(len(group))),
                                [(rid, 0) for _, rid, *_ in group])
            for j, (i, rid, ids, budget, pkey, plen) in enumerate(group):
                if pkey is not None and pkey not in self._prefix_cache:
                    self._capture_prefix(pkey, i, plen)
                self.slots[i] = _Slot(
                    active=True, length=len(ids), budget=budget,
                    out_tokens=[firsts[j]], request_id=rid)

    def _capture_prefix(self, pkey: bytes, slot: int, plen: int) -> None:
        """LRU-insert a copy of a freshly prefilled slot's prefix K/V (a
        view would see the slot's next occupant)."""
        kv = {name: c[:, slot, :, :plen].clone()
              for name, c in self.caches.items()}
        self._prefix_cache[pkey] = (kv, plen)
        while len(self._prefix_cache) > self.ecfg.prefix_cache_entries:
            self._prefix_cache.popitem(last=False)

    def _admit_hits(self, pending: List[tuple]) -> None:
        """Prefix-cache-hit admission: seed each slot's cache with the
        reused prefix rows, then ONE ``prefill_extend`` launch per
        suffix bucket computes only the suffix K/V (global positions,
        per-row offsets), written into the group's rows only."""
        if not pending:
            return
        buckets: Dict[int, list] = {}
        for item in pending:
            slen = len(item[2]) - item[5]
            buckets.setdefault(self._bucket_len(slen), []).append(item)
        for blen, group in sorted(buckets.items()):
            tokens = np.zeros((self.ecfg.max_batch, blen), np.int32)
            lengths = np.zeros((self.ecfg.max_batch,), np.int32)
            offsets = np.zeros((self.ecfg.max_batch,), np.int32)
            for i, rid, ids, budget, pkey, plen in group:
                kv, _ = self._prefix_cache[pkey]
                self._prefix_cache.move_to_end(pkey)
                # slot-indexed batch layout: the launch reads and writes
                # row i of the live cache directly
                for name, c in self.caches.items():
                    c[:, i, :, :plen].copy_(kv[name])
                suf = ids[plen:]
                tokens[i, :len(suf)] = suf
                lengths[i] = len(suf)
                offsets[i] = plen
            rows = [i for i, *_ in group]
            with self.tracer.span("prefill", bucket=blen,
                                  prompts=len(group), prefix_hit=True):
                logits, _ = self._prefill_extend(tokens, lengths, offsets,
                                                 rows)
            self.stats["prefill_launches"] += 1
            self.stats["prefill_prompts"] += len(group)
            self.stats["prefix_hits"] += len(group)
            self.stats["prefix_tokens_saved"] += sum(
                item[5] for item in group)
            firsts = self._pick(logits, rows,
                                [(rid, 0) for _, rid, *_ in group])
            for i, rid, ids, budget, pkey, plen in group:
                self.slots[i] = _Slot(
                    active=True, length=len(ids), budget=budget,
                    out_tokens=[firsts[i]], request_id=rid)

    def step(self) -> int:
        """One engine iteration: admit + micro-batched decode.

        ``decode_step`` strides the whole slot batch at ONE cache
        length, so slots are grouped by length and each group shares a
        single launch (slots admitted together stay in lock-step until
        one finishes).  Rows outside the group compute garbage that is
        discarded, and their caches are not written.  Returns the number
        of active slots stepped."""
        with torch.inference_mode():
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s.active]
            if not active:
                return 0
            groups: Dict[int, List[int]] = {}
            for i in active:
                groups.setdefault(self.slots[i].length, []).append(i)
            for length, idxs in sorted(groups.items()):
                tok = np.zeros((self.ecfg.max_batch, 1), dtype=np.int32)
                for i in idxs:
                    tok[i, 0] = self.slots[i].out_tokens[-1]
                with self.tracer.span("decode", length=length,
                                      slots=len(idxs)):
                    logits, _ = self._decode_step(tok, length, idxs)
                self.stats["decode_launches"] += 1
                self.stats["slot_steps"] += len(idxs)
                nxt = self._pick(logits, idxs, [
                    (self.slots[i].request_id,
                     len(self.slots[i].out_tokens)) for i in idxs])
                for i in idxs:
                    slot = self.slots[i]
                    slot.out_tokens.append(nxt[i])
                    slot.length += 1
                    done = (nxt[i] == EOS_ID or
                            len(slot.out_tokens) >= slot.budget or
                            slot.length >= self.ecfg.max_seq_len - 1)
                    if done:
                        self._results[slot.request_id] = slot.out_tokens
                        self.slots[i] = _Slot()
            return len(active)

    def run_until_done(self, max_iters: int = 10_000) -> None:
        for _ in range(max_iters):
            if self._queue.empty() and not any(s.active
                                               for s in self.slots):
                return
            self.step()
        raise RuntimeError("engine did not drain")
