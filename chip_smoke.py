#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    PYTHONPATH=src python3 chip_smoke.py

Run from the repository root.  It imports nothing of JAX or of the JAX
package.  Phases, each printing one JSON line:

1. ``device``    the card, torch and CUDA versions; builds every kernel
                 of the main path from ``src/repro_torch/csrc`` (one nvcc
                 per source, started together) into ``build/``.
2. ``main_path`` the paper's loop on ``ERARAG_DEFAULT`` through the entry
                 points a user calls: a 5000-document synthetic corpus
                 (50 % initial build + 5 growth rounds), 64 questions
                 through ``EraRAG.query_batch`` in collapsed, detailed and
                 summarized modes, 5 through ``RAGPipeline.answer``.  The
                 kernels' launch counters are set to 0 just before and
                 read just after; every kernel must have launched.  Then
                 the quickstart configuration runs on the card and on the
                 CPU (plain versions): graphs, hits, contexts and answers
                 must agree.
3. ``lsh_hash``  kernel against its plain version at the main path's
                 shape (real embeddings; k = 12, and k = 128 for two
                 groups of 64 hyperplanes), at a growth round's chunk
                 batch and at n = 2^22 rows; each case's grid
                 (``lsh_grid``), launches a call (1, by the wrapper's
                 count and the profiler's), event and device-only time
                 and bound share; and the host time of one
                 ``HyperplaneLSH.hash_packed`` call at the build's shape
                 beside its parts (the rows' copy to the card, the
                 kernel, the codes' copy back).
4. ``mips_topk`` ``flagged_mips_topk`` through the kernel against its
                 plain version at the main path's shape (the real store
                 buffer) and at n = 2^22 rows x (256 + 3), b = 64 and
                 b = 1, k = 8; b = 1 against b = 64 must agree bitwise.
                 Times beside the bound, TFLOP/s, the bound share and
                 each kernel's device-only time.
5. ``quantized_path`` the same corpus, build, growth rounds and questions
                 through ``EraRAG`` with ``quantized_scan=True``, the
                 counters set to 0 just before and read just after:
                 ``lsh_hash``, ``hamming_topk`` and ``mips_rescore`` must
                 have launched, ``hamming_topk`` on its list route only.
                 The graph must equal the exact path's;
                 every returned score must be bitwise the exact kernel's
                 for its row; with C = capacity the hits must be bitwise
                 the exact path's; b = 1 must equal b = 64; no tombstoned
                 row may return after ``remove_docs``.  Recall@8 against
                 the exact path and batches/s are reported, not checked.
                 The ``reference`` phase runs again with the quantized
                 scan.
6. ``hamming_topk`` first ``lsh_hash`` at the quantized path's shape
                 (the store's rows, k = 64) and at its query encoding
                 (the 64 questions, k = 64) against its plain version,
                 and the store's code plane and the query codes against
                 the plain hash plus the flag groups.  Then the kernel
                 against its plain version, bitwise, at the
                 main path's shape (the quantized store's codes, b = 64,
                 C = 32 and C = LIST_MAX_C) and at n = 2^22 rows x 11
                 words (real codes of random rows, duplicated rows
                 planted), C = 32 (b = 64, and b = 1 bitwise query 0 of
                 b = 64) and 4096; each case checks the route that ran
                 (list for C <= LIST_MAX_C, count above) and reports the
                 grid, each kernel's device-only time and the bound
                 share;
                 the gathered-rows rescore (``mips_rescore``) against its
                 plain version and the exact kernel at the same shapes
                 (at 2^22 query 0's top 5 must be the planted rows
                 999..1003 in order), one kernel launch a call (the
                 wrapper's count and the profiler's), its grid, event and
                 device-only times, bound share, and a composition of
                 library calls (gather, ``torch.bmm``, ``torch.topk``)
                 timed as a yardstick;
                 the whole two-stage scan beside the exact scan at the
                 main path's shape and at 2^22.
6b. ``sharded_path`` the main path's store resharded in place
                 (``EraRAG.reshard(4)``): every ``query_batch`` hit in
                 the three modes equal to the flat store's (node id,
                 layer, sequence number, score bits); the last growth
                 round's documents removed and re-inserted and every
                 shard compacted, each step against a flat
                 ``VectorStore`` tracking the same graph; then
                 ``reshard(8)`` and ``reshard(1)``, equal each time.
                 The counters are set to 0 as it starts and count only
                 its own steps: ``lsh_hash``, ``mips_topk`` and the merge
                 must have launched.  Prints batches/s and launches a
                 batch (flat against sharded), the merge's device ms,
                 each reshard's seconds, the shard report and the
                 routing counters.  Then the quantized store resharded
                 to 4 (its kernels' launches; ``hamming_topk`` on the
                 list route only), equal to the exact sharded store at
                 C = capacity.
6c. ``baselines`` the paper's comparison systems on the card, each
                 over a 50 % build and 5 growth rounds: ``VanillaRAG``
                 on the main path's corpus (25015 chunks, d = 256), and
                 ``BM25``, ``RaptorLike``, ``GraphRAGLike`` and an
                 ``EraRAG`` on a cut corpus of 500 documents (they
                 rebuild everything on the host every round; printed as
                 ``reduced``).  Seconds and tokens a round; 64 questions
                 asked one at a time (ms a question, ``mips_topk``
                 launches: one a question for the dense systems and the
                 ``EraRAG``, none for BM25); every dense scan against
                 the plain scan of the same device embeddings, and the
                 ``EraRAG``'s flagged scans against theirs (each b = 1
                 row bitwise its batch row); the b = 1 scan at
                 VanillaRAG's shape
                 (event and device ms, byte bound, plain and
                 ``torch.topk(q @ db.T)`` times).
6d. ``query_cache`` the main path's index restored through
                 ``state_dict(include_store=True)``/``from_state`` with
                 ``query_cache=True``: a cold 64-question batch in each
                 mode equal to the cache-off store's (score bits
                 included), the same batch warm (no retrieval round, no
                 launch), 32 repeats + 32 new questions (one sweep of
                 the 32 misses), and an insert burst (the token moves,
                 the next batch misses entirely and equals a cache-off
                 store on the same graph).  The sweeps' scans (b = 32
                 and 64) against the plain scan.  Cold and warm
                 batches/s: medians of 10 batches a mode, with quartiles
                 (the cache cleared before each cold one).
6e. ``ingest``   two indexes restored at the main path's final state:
                 500 fresh documents and one removal through
                 ``IngestService`` (a 64-question ``query_batch`` after
                 every tick) against ``insert_docs``/``remove_docs`` on
                 the twin: node ids, store rows (bytes) and hits equal;
                 one ``lsh_hash`` launch an embed tick, and the kernel
                 at the ticks' shapes (n = 64 and the last tick's n,
                 k = 12) against the plain hash on the rows they hashed;
                 ticks by stage, median and max tick ms; each batch after
                 a tick paired with the same batch again back to back,
                 and the batch with the queue idle.
6f. ``index_report`` the ingest phase's ``RAGPipeline.index_report``:
                 its sections, key counts and ``to_prometheus()`` length;
                 its numbers equal to the live objects'.
6g. ``serving_reference`` the tiny ``make_test_engine`` recipe (fp32,
                 weights drawn once on the CPU) on the card and on the
                 CPU: 6 prompts in two buckets, tokens under the margin
                 rule, stats equal, every step's logits within 1e-4; the
                 same with the prefix cache, hits against the cold path.
6h. ``serving_engine`` llama3-8b at all 32 layers in bf16 (random
                 weights, seed 0) behind an ``Engine`` of 8 slots x 4096
                 positions: 8 prompts of 120-3000 tokens (6 buckets) as
                 one batch and one at a time, and 8 prompts over 2
                 declared prefixes against an engine without the cache,
                 each under the margin rule with the largest logit
                 difference printed; ``decode_step`` against ``prefill``;
                 prefill ms and tokens/s by bucket, the decode step's
                 median ms at 8 live slots against its byte bound, its
                 kernels, device ms by kind and host share from the
                 profiler; no ``flash_attention`` launch.
6i. ``serving_rag`` ``RAGPipeline(rag, engine=...)`` over the main
                 path's index: 16 questions twice (the second pass all
                 prefix hits, under the margin rule), 4 through
                 ``answer`` against their batch rows, 8 multihop
                 questions in exactly 2 ``generate_batch`` calls; the
                 report's ``prefix_cache`` and ``launches.engine``.
6j. ``serving_summarizer`` ``EraRAG`` with an ``LMSummarizer`` on the
                 same weights (32 documents: 24 built, 8 grown), batched
                 and serial summaries, no prefix cache: summaries under
                 the margin rule, node ids and update tokens equal, the
                 serial run one ``generate_batch`` a segment, the
                 batched one at most half as many.  The margin rule: two
                 runs of the same prompts give equal tokens, or where
                 they part the smaller top-1 over top-2 margin lies
                 within the largest logit difference at that step.
6k. ``lifecycle`` the quantized index that ``sharded_path`` resharded
                 to 4 (before it is dropped): a ``LifecyclePolicy``
                 stages a migration to 8 shards from ``refresh()``; after
                 2 of the 8 target shards a ``LifecycleManager``
                 snapshot, restored twice (resumed from the staged
                 shards and replayed, the scan settings passed
                 explicitly); the three migrations finished by
                 ``refresh()`` turns (6, 6, 8), every hit bitwise equal
                 among them and, sequence numbers aside, to a fresh
                 8-shard build; then the last growth round removed and a
                 tombstone-triggered same-width replay, equal to a fresh
                 build.  ``lsh_hash`` (the code planes re-hashed),
                 ``hamming_topk`` (list route) and the rescore must
                 launch; every shape they launched is held against its
                 plain version.  Snapshot seconds and bytes, restore
                 seconds.
6l. ``live_day`` ``LiveHarness`` on ``ERARAG_DEFAULT`` with 4 shards and
                 the query cache over the main path's corpus cut to 2000
                 documents (``make_schedule(seed=0, query_batch=64,
                 queries_per_phase=4)``, compaction threshold 0.15, the
                 extractive reader; a walk of the schedule, checked
                 against the service's deepest queue, shows the 5000
                 documents' schedule over the ingest queue's bound at
                 2, 4 and 8 bursts): ingest bursts, removals, Zipf query
                 batches, a snapshot and restore mid-stream and a policy
                 migration to 8 shards, gated inside ``run()``
                 (availability 1.0, completion, bitwise parity with the
                 synchronous replay).  Per-phase p50/p99 batch ms, the
                 migration record, the store counters (compactions
                 >= 1, 8 reshard steps), snapshot seconds and bytes,
                 restore seconds, and the launches; every ``mips_topk``
                 and ``lsh_hash`` shape the day launched held against
                 its plain version (a scan's queries also one at a
                 time).  The shapes are recorded during the timed
                 batches: a copy on the card of each new shape's
                 inputs, with no wait for the host.
    ``sharded_2_22`` 2^22 rows hash-routed into 4 slots of one stacked
                 buffer (capacity the largest slot): the per-slot
                 ``mips_topk`` scans plus the merge against
                 ``flagged_mips_topk`` over the same rows, ids (the
                 rows' flat index as sequence number) and scores
                 bitwise equal; event and device ms of both, by kernel,
                 and the merge's.  The ``reference`` phase runs again
                 with ``index_shards=4``, exact and quantized.
7. ``flash_attention`` the forward and backward kernels against the
                 plain version (``attention_ref`` and autograd through it):
                 output, logsumexp and dQ/dK/dV from a seeded dO at the
                 training slice's shape (b = 2, hq = 32, hkv = 8,
                 l = 4096, d = 128, causal) and at small shapes (odd
                 lengths, lq < lk causal, not causal, groups 1, 4 and 8,
                 d 16 to 128, single rows), each in bf16 (the tensor-core
                 kernels) and fp32 (the FMA kernels); two backward runs
                 must agree bitwise.  Times at the training shape in both
                 dtypes, beside the bound, TFLOP/s and
                 ``scaled_dot_product_attention`` (a yardstick only).
8. ``train_path`` the LM training slice through the port's entry points
                 (``init_params`` -> ``run_training``/``make_train_step``
                 -> ``loss_fn``): llama3-8b at full width with 4 layers,
                 5 AdamW steps of 2 sequences of 4096 tokens in 2
                 microbatches, bf16 compute, on one fixed batch.  Every
                 loss must be finite and the last below the first; both
                 attention passes must have launched, on the tensor-core
                 route only, and the plain attention never (counters set
                 to 0 just before).
9. ``train_reference`` llama3-8b at ``reduced()``: 3 steps from the same
                 seeded weights on the card (kernels) and on the CPU
                 (plain versions); losses and weights must agree, and
                 the card's fp32 attention must have run on the FMA
                 kernels only.
9b. ``train_resume`` llama3-8b at ``reduced()`` in bf16 through
                 ``run_training``: 6 steps unbroken against 3 steps with
                 ``ckpt_dir`` and a resume to 6 in a fresh model; losses,
                 weights and both AdamW moments (the final checkpoints)
                 bitwise equal; the resume on the bf16 attention kernels
                 only, its shape held against the plain version.
10. ``kernels``  one line listing every kernel with its numbers (the
                 ``lsh_hash`` and ``mips_topk`` entries with the
                 launches of phases 6c-6e and 6g-6j beside the main
                 path's, and every entry with the launches of
                 ``live_day``, ``lifecycle`` and ``train_resume``).

Times are CUDA-event medians after a warm-up.  Any failed check raises,
and the script exits non-zero; the last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# __popc results per SM per clock at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table); times the
# SM count and the card's maximum SM clock from nvidia-smi
POPC_PER_SM_CLOCK = 16
N_DEPLOY = 1 << 22          # rows of the deployment-size checks
LSH_FLIP_BAND = 1e-5        # |fp64 projection| below which a bit may flip
SCORE_TOL = 1e-5            # kernel vs plain score tolerance (fp32 sums)
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
# flash attention, kernels vs plain: |out error| <= out_abs + out_rel *
# |plain out|.  fp32 sums in other orders differ by ~1e-7 of the summed
# terms (out_abs); bf16 outputs round those fp32 values, so one may land
# one bf16 step apart (out_rel = 2^-7), and the kernels' backward reads
# the bf16 output for D = rowsum(dO * O).  lse: rows of up to 4096
# exponentials summed in two orders, |lse| ~ 10.
FA_TOL = {"float32": {"out_abs": 2e-5, "out_rel": 0.0, "lse": 1e-4,
                      "grad_rel": 1e-5},
          "bfloat16": {"out_abs": 2e-5, "out_rel": 2.0 ** -7, "lse": 1e-4,
                       "grad_rel": 1e-2}}
TRAIN_SHAPE = {"b": 2, "hq": 32, "hkv": 8, "l": 4096, "d": 128}
# card vs CPU training, fp32 compute: losses, and each weight's change
# over the steps (relative Frobenius; see tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_UPDATE_RTOL = 1e-4


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(n_bytes: float, n_flop: float,
          ops_per_s: float = FP32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over their peak rate (fp32 outside the tensor cores
    unless ``ops_per_s`` says otherwise)."""
    by_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    by_ops = n_flop / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def popc_per_s() -> float:
    """The card's __popc rate: 16 a clock on each SM at its maximum SM
    clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_SM_CLOCK * sms * float(mhz) * 1e6


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------

def run_main_path():
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.kernels.lsh_hash import ops as lsh_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.serving.rag_pipeline import RAGPipeline

    t0 = time.perf_counter()
    corpus = SyntheticCorpus.generate(n_docs=5000, n_topics=64, seed=0)
    gen_s = time.perf_counter() - t0
    init, rounds = corpus.growth_rounds(0.5, 5)
    questions = [qa.question for qa in corpus.qa[:64]]

    lsh_ops.reset_launch_count()
    mips_ops.reset_launch_count()
    rag = EraRAG(ERARAG_DEFAULT, HashingEmbedder(dim=256), device="cuda")
    t0 = time.perf_counter()
    rep = rag.insert_docs(init)
    build_s = time.perf_counter() - t0
    n_init_chunks = rep.n_new_chunks
    round_s = []
    for docs in rounds:
        t0 = time.perf_counter()
        rag.insert_docs(docs)
        round_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rag.store.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    # where the update time went (UpdateReport stage timers, summed)
    breakdown = {stage: sum(getattr(r, f"time_{stage}")
                            for r in rag.reports)
                 for stage in ("embed", "hash", "partition", "summarize")}
    batches_per_s = {}
    empty = {}
    for mode in ("collapsed", "detailed", "summarized"):
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            rets = rag.query_batch(questions, mode=mode)
        batches_per_s[mode] = reps / (time.perf_counter() - t0)
        empty[mode] = sum(1 for r in rets if not r.hits)
    pipe = RAGPipeline(rag)
    answers = [pipe.answer(qa.question) for qa in corpus.qa[:5]]
    launches = {"lsh_hash": lsh_ops.launch_count(),
                "mips_topk": mips_ops.launch_count()}

    errs = rag.graph.check_integrity()
    check(not errs, f"graph integrity: {errs[:5]}")
    for name, n in launches.items():
        check(n > 0, f"{name} kernel never launched on the main path")
    for mode, n in empty.items():
        check(n == 0, f"{mode}: {n} of {len(questions)} queries "
                      f"returned no hits")
    check(all(a.hits > 0 for a in answers), "an answer had no hits")
    correct = sum(qa.answer in a.answer
                  for qa, a in zip(corpus.qa[:5], answers))
    emit("main_path", docs=len(corpus.docs),
         chunks=sum(1 for n in rag.graph.nodes.values() if n.layer == 0),
         rows=rag.store.size, capacity=rag.store._group.capacity,
         layers=rag.graph.n_layers, corpus_gen_s=gen_s,
         build_s=build_s, round_s=round_s, refresh_s=refresh_s,
         update_breakdown_s=breakdown,
         query_batch=len(questions), batches_per_s=batches_per_s,
         answers_correct=f"{correct}/5", launches=launches,
         integrity="clean")
    return corpus, rag, questions, n_init_chunks, launches


def run_reference_check(quantized_scan: bool = False,
                        index_shards: int = 1):
    """The quickstart configuration on the card against the same code
    on the CPU (plain versions, which the CPU tests hold against the
    JAX package): same graph, hits, contexts and answers.  With
    ``quantized_scan`` both run the two-stage quantized scan, and with
    ``index_shards`` > 1 the sharded store."""
    from repro_torch.common.config import EraRAGConfig
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving.rag_pipeline import RAGPipeline

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                       max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024, quantized_scan=quantized_scan,
                       index_shards=index_shards)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)
    rags = {dev: EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim),
                        device=dev) for dev in ("cuda", "cpu")}
    for docs in [init] + rounds:
        reps = [rag.insert_docs(docs) for rag in rags.values()]
        check(reps[0].tokens_total == reps[1].tokens_total,
              "reference: update token counts differ")
    gpu, cpu = rags["cuda"], rags["cpu"]
    check(list(gpu.graph.nodes) == list(cpu.graph.nodes),
          "reference: node ids differ between card and CPU")
    questions = [qa.question for qa in corpus.qa[:40]]
    max_err = 0.0
    for mode in ("collapsed", "detailed", "summarized", "multihop"):
        for a, b in zip(gpu.query_batch(questions, mode=mode),
                        cpu.query_batch(questions, mode=mode)):
            check([(h.node_id, h.layer, h.seq) for h in a.hits]
                  == [(h.node_id, h.layer, h.seq) for h in b.hits],
                  f"reference: {mode} hits differ")
            check(a.context == b.context,
                  f"reference: {mode} contexts differ")
            for ha, hb in zip(a.hits, b.hits):
                max_err = max(max_err, abs(ha.score - hb.score))
    check(max_err <= SCORE_TOL, f"reference: score error {max_err}")
    pg, pc = RAGPipeline(gpu), RAGPipeline(cpu)
    check([pg.answer(q).answer for q in questions[:10]]
          == [pc.answer(q).answer for q in questions[:10]],
          "reference: answers differ")
    scans = [rag.store.stats.quantized_scans for rag in (gpu, cpu)]
    check(scans[0] == scans[1] and (scans[0] > 0) == quantized_scan,
          f"reference: quantized scans {scans}")
    shards = [getattr(rag.store, "n_shards", 1) for rag in (gpu, cpu)]
    check(shards == [index_shards] * 2, f"reference: shards {shards}")
    emit("reference",
         config="quickstart" + ("_quantized" if quantized_scan else "")
         + (f"_sharded{index_shards}" if index_shards != 1 else ""),
         index_shards=index_shards,
         nodes=len(gpu.graph.nodes), queries=len(questions), modes=4,
         quantized_scans=scans[0], max_score_err=max_err,
         tolerance=SCORE_TOL, hits_equal=True, answers_equal=True)


# ---------------------------------------------------------------------------
# phase 3: lsh_hash
# ---------------------------------------------------------------------------

def lsh_flips(got, want, v, h, label):
    """(bits that differ, largest |fp64 projection| among them) between
    two packed code blocks of rows ``v`` under planes ``h``; a bit may
    differ only inside the flip band, where fp32 sums disagree on the
    sign."""
    from repro_torch.kernels.lsh_hash import ops

    k = h.shape[1]
    flipped = ops.unpack_bits(got, k) != ops.unpack_bits(want, k)
    n_flipped = int(flipped.sum())
    max_flip_proj = 0.0
    if n_flipped:
        rows = flipped.any(dim=1).nonzero().flatten()
        proj = v[rows].double() @ h.double()
        max_flip_proj = float(proj.abs()[flipped[rows]].max())
    check(max_flip_proj <= LSH_FLIP_BAND,
          f"lsh_hash {label}: a bit with |projection| "
          f"{max_flip_proj} > {LSH_FLIP_BAND} differs")
    return n_flipped, max_flip_proj


def lsh_times(v, h):
    """The kernel's and the plain version's times on rows ``v`` under
    planes ``h``: grid, event and device-only times (the profiler must
    see the kernel alone, at most once a call, as it may drop records)
    beside the bound."""
    from repro_torch.kernels.common import lsh_grid, sm_count
    from repro_torch.kernels.lsh_hash import ops
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref
    from repro_torch.kernels.timing import kernel_ms, time_ms

    n, d = v.shape
    k = h.shape[1]
    ms = time_ms(lambda: ops.lsh_hash(v, h))
    plain_ms = time_ms(lambda: lsh_hash_ref(v, h), reps=5)
    n_words = -(-k // 32)
    bound_ms, bound_by = bound(4.0 * (n * d + d * k + n * n_words),
                               2.0 * n * d * k)
    # device-only: the kernel without the wrapper's host work
    launches = {}
    kernels = kernel_ms(lambda: ops.lsh_hash(v, h), launches=launches)
    device = sum(kernels.values())
    check(set(launches) == {"lsh_hash_kernel"} and
          0 < launches["lsh_hash_kernel"] <= 1,
          f"lsh_hash n={n}: kernel launches per call {launches}")
    return {"grid": lsh_grid(n, k, sm_count(v.device))._asdict(),
            "profiler_launches_per_call": launches,
            "kernel_ms": ms, "kernel_device_ms": kernels,
            "device_ms": device, "bound_share": bound_ms / ms,
            "device_bound_share": bound_ms / device if device else None,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def lsh_case(v, h, label):
    """The kernel against its plain version on rows ``v`` under planes
    ``h``: bits outside the flip band, one launch a call (the wrapper's
    count), and ``lsh_times``."""
    from repro_torch.kernels.lsh_hash import ops
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref

    n, d = v.shape
    k = h.shape[1]
    before = ops.launch_count()
    got = ops.lsh_hash(v, h)
    check(ops.launch_count() == before + 1,
          f"lsh_hash {label}: {ops.launch_count() - before} launches for "
          f"one call")
    # the plain version's zero-padded bits beyond k are already 0
    want = lsh_hash_ref(v, h)
    torch.cuda.synchronize()
    n_flipped, max_flip_proj = lsh_flips(got, want, v, h, label)
    return {"shape": {"n": n, "d": d, "k": k}, "launches_per_call": 1,
            "bits_flipped": n_flipped, "flip_band": LSH_FLIP_BAND,
            "max_abs_err": max_flip_proj, **lsh_times(v, h)}


def hash_packed_split(lsh, vectors, reps=20):
    """Host milliseconds (median of ``reps``) of one
    ``HyperplaneLSH.hash_packed`` call on the host array ``vectors``, and
    of its parts on their own: the rows' copy to the card, the kernel's
    call (to its end), and the codes' copy back."""
    from repro_torch.kernels.lsh_hash import ops

    def host_ms(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    v = torch.from_numpy(vectors).cuda()
    codes = ops.lsh_hash(v, lsh._planes)
    return {"shape": {"n": vectors.shape[0], "d": vectors.shape[1],
                      "k": lsh.k},
            "hash_packed_ms": host_ms(lambda: lsh.hash_packed(vectors)),
            "rows_to_card_ms": host_ms(
                lambda: torch.from_numpy(vectors).cuda()),
            "kernel_call_ms": host_ms(lambda: ops.lsh_hash(v, lsh._planes)),
            "codes_to_host_ms": host_ms(lambda: codes.cpu().numpy())}


def run_lsh(rag, n_init):
    # the main path's largest call: the initial build's chunk batch
    leaves = [nd.embedding for nd in rag.graph.nodes.values()
              if nd.layer == 0]
    v = torch.from_numpy(np.stack(leaves[:n_init])).cuda()
    h = torch.from_numpy(rag.graph.lsh.hyperplanes).cuda()
    main = lsh_case(v, h, "main path")
    # the same rows under 128 hyperplanes: two groups of 64 (a quantized
    # store with scan_bits=128)
    gen = torch.Generator(device="cuda").manual_seed(4)
    h128 = torch.randn(h.shape[0], 128, device="cuda", generator=gen)
    wide = lsh_case(v, h128, "k=128")
    del v
    # a growth round's chunk batch: the first round's new leaves
    n_round = rag.reports[1].n_new_chunks
    growth = lsh_case(torch.from_numpy(np.stack(
        leaves[n_init:n_init + n_round])).cuda(), h, "growth round")
    # the host side of one build-size call, split into its parts
    host = hash_packed_split(rag.graph.lsh, np.stack(leaves[:n_init]))
    host["kernel_device_ms"] = main["device_ms"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    v = torch.randn(N_DEPLOY, h.shape[0], device="cuda", generator=gen)
    v[0] = 0.0   # the embedder's empty-text row: every bit set
    deploy = lsh_case(v, h, "2^22")
    del v
    torch.cuda.empty_cache()
    emit("lsh_hash", main_path=main, k_128=wide, growth_round=growth,
         at_2_22=deploy, hash_packed=host)
    return main, deploy, wide, growth


# ---------------------------------------------------------------------------
# phase 4: mips_topk
# ---------------------------------------------------------------------------

def near_tie_check(vals, idx, pv, pi, k, label):
    """The kernel's top-k ``(vals, idx)`` against the plain version's
    top-(k + 1) ``(pv, pi)``: scores within ``SCORE_TOL``, and ids
    differing only where a plain neighbour score lies within it (a
    near-tie two summation orders may swap).  Returns the largest score
    error and the ids that differ."""
    max_err = float((vals - pv[:, :k]).abs().max())
    check(max_err <= SCORE_TOL,
          f"{label}: score error {max_err} > {SCORE_TOL}")
    near = torch.zeros_like(pv, dtype=torch.bool)
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= SCORE_TOL
    near[:, 1:] |= close
    near[:, :-1] |= close
    bad = (idx != pi[:, :k]) & ~near[:, :k]
    check(not bool(bad.any()),
          f"{label}: {int(bad.sum())} ids differ away from near-ties")
    return max_err, int((idx != pi[:, :k]).sum())


def mips_times(q_aug, db, k):
    """The kernel's, the plain version's and ``torch.topk(q @ db.T)``'s
    times on augmented queries ``q_aug`` over ``db``: event and
    device-only times (the scan and the merge, both recorded), the
    grid and the bound."""
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_topk_ref
    from repro_torch.kernels.timing import device_ms, kernel_ms, time_ms

    b = q_aug.shape[0]
    n, d = db.shape          # d counts the flag columns: the kernel's width
    ms = time_ms(lambda: ops.mips_topk(q_aug, db, k))
    plain_ms = time_ms(lambda: mips_topk_ref(q_aug, db, k), reps=5)
    library_ms = time_ms(lambda: torch.topk(q_aug @ db.T, k),
                         reps=5)
    flop = 2.0 * b * n * d
    bound_ms, bound_by = bound(4.0 * (n * d + b * d) + 8.0 * b * k, flop)
    # device-only: the scan and the merge (no host work of the wrapper),
    # both recorded
    kernels = kernel_ms(lambda: ops.mips_topk(q_aug, db, k),
                        expect=("mips_scan_kernel", "mips_merge_kernel"))
    check(set(kernels) == {"mips_scan_kernel", "mips_merge_kernel"},
          f"mips_topk b={b} n={n}: the profiler kept {sorted(kernels)}")
    kernel_device_ms = sum(kernels.values())
    tile, tile_rows, rows_per_range, n_ranges = ops.mips_scan_grid(
        b, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"scan_grid": {"query_tile": tile, "tile_rows": tile_rows,
                          "rows_per_range": rows_per_range,
                          "n_ranges": n_ranges},
            "kernel_ms": ms,
            "kernel_device_ms": kernels, "device_ms": kernel_device_ms,
            "tflop_per_s": flop / ms / 1e9,
            "device_tflop_per_s": flop / kernel_device_ms / 1e9
            if kernel_device_ms else None,
            "bound_share": bound_ms / ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_device_ms": device_ms(
                lambda: torch.topk(q_aug @ db.T, k)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def mips_case(q, db, k, bias, label):
    """``flagged_mips_topk`` against its plain version (near-ties aside),
    each query alone bitwise its batch row, and ``mips_times`` beside
    the flagged wrapper's own time (augmentation included)."""
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_topk_ref
    from repro_torch.kernels.timing import time_ms

    b = q.shape[0]
    n, d = db.shape
    q_aug = ops.augment_queries(q, bias).contiguous()
    vals, idx = ops.flagged_mips_topk(q, db, k, bias)
    # plain: one more candidate, to see near-ties at the k boundary
    pv, pi = mips_topk_ref(q_aug, db, min(k + 1, n))
    torch.cuda.synchronize()
    max_err, id_diffs = near_tie_check(vals, idx, pv, pi, k,
                                       f"mips_topk {label}")
    # batch invariance: each query alone gives the batch's row bitwise
    for j in range(b):
        v1, i1 = ops.flagged_mips_topk(q[j:j + 1].contiguous(), db, k,
                                       bias)
        check(torch.equal(v1, vals[j:j + 1]) and
              torch.equal(i1, idx[j:j + 1]),
              f"mips_topk {label}: b=1 differs from b={b} at row {j}")
    return {"shape": {"b": b, "n": n, "d": d, "k": k},
            "max_abs_err": max_err, "tolerance": SCORE_TOL,
            "ids_differing_at_near_ties": id_diffs,
            "batch_invariant": True,
            "flagged_wrapper_ms": time_ms(
                lambda: ops.flagged_mips_topk(q, db, k, bias)),
            **mips_times(q_aug, db, k)}


def run_mips(rag, questions):
    from repro_torch.core.store import _filter_bias

    store = rag.store
    q = torch.from_numpy(np.asarray(rag.embedder.encode(questions),
                                    np.float32)).cuda()
    main = mips_case(q, store._s.buf, rag.cfg.top_k,
                     _filter_bias(None), "main path")
    gen = torch.Generator(device="cuda").manual_seed(2)
    d = rag.cfg.embed_dim
    db = torch.zeros(N_DEPLOY, d + 3, device="cuda")
    db[:, :d] = torch.nn.functional.normalize(
        torch.randn(N_DEPLOY, d, device="cuda", generator=gen), dim=1)
    flag = torch.rand(N_DEPLOY, device="cuda", generator=gen)
    db[:, d] = (flag < 0.1).float()                  # dead
    db[:, d + 1] = (flag >= 0.7).float()             # summary
    db[:, d + 2] = (flag < 0.7).float()              # leaf
    db[1000:1004, :d] = db[999, :d]                  # exact duplicates
    qd = torch.nn.functional.normalize(
        torch.randn(64, d, device="cuda", generator=gen), dim=1)
    qd[0] = db[999, :d]
    deploy = {}
    for name, layer_filter in (("collapsed", None), ("leaf_only", "leaf")):
        deploy[name] = mips_case(qd, db, 8,
                                 _filter_bias(layer_filter),
                                 f"2^22 {name}")
    # one query: the byte-bound end of the scan (query 0, the duplicate)
    deploy["b1_collapsed"] = mips_case(qd[:1].contiguous(), db, 8,
                                       _filter_bias(None), "2^22 b=1")
    del db
    torch.cuda.empty_cache()
    emit("mips_topk", main_path=main, at_2_22=deploy)
    return main, deploy["collapsed"], deploy["b1_collapsed"]


# ---------------------------------------------------------------------------
# phase 5: the quantized path
# ---------------------------------------------------------------------------

FULL_COVERAGE = 10 ** 9     # coarse_mult that clamps C to the capacity


def _hits_key(hits):
    return [(h.node_id, h.score, h.layer, h.seq) for h in hits]


def run_quantized_path(corpus, exact, questions):
    """The main path again with ``quantized_scan=True``, held against
    the exact path ``exact`` (same corpus, rounds and questions)."""
    from dataclasses import replace

    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.store import _filter_bias
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.kernels.lsh_hash import ops as lsh_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.serving.rag_pipeline import RAGPipeline

    init, rounds = corpus.growth_rounds(0.5, 5)
    cfg = replace(ERARAG_DEFAULT, quantized_scan=True)
    modes = ("collapsed", "detailed", "summarized")

    lsh_ops.reset_launch_count()
    mips_ops.reset_launch_count()
    ham_ops.reset_launch_count()
    rag = EraRAG(cfg, HashingEmbedder(dim=256), device="cuda")
    t0 = time.perf_counter()
    for docs in [init] + rounds:
        rag.insert_docs(docs)
    rag.store.refresh()
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    batches_per_s, empty, rets_q = {}, {}, {}
    for mode in modes:
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            rets = rag.query_batch(questions, mode=mode)
        batches_per_s[mode] = reps / (time.perf_counter() - t0)
        empty[mode] = sum(1 for r in rets if not r.hits)
        rets_q[mode] = rets
    answers = [RAGPipeline(rag).answer(qa.question)
               for qa in corpus.qa[:5]]
    launches = {"lsh_hash": lsh_ops.launch_count(),
                "mips_topk": mips_ops.launch_count(),
                "hamming_topk": ham_ops.launch_count(),
                "mips_rescore": mips_ops.rescore_launch_count()}
    ham_routes = ham_ops.route_launch_counts()

    for name in ("lsh_hash", "hamming_topk", "mips_rescore"):
        check(launches[name] > 0,
              f"{name} kernel never launched on the quantized path")
    # the serving C (coarse_mult x top_k) is the list route's
    check(ham_routes == {"list": launches["hamming_topk"], "count": 0},
          f"quantized path: hamming_topk routes {ham_routes}")
    check(list(rag.graph.nodes) == list(exact.graph.nodes),
          "quantized path: the graph differs from the exact path's")
    stats = rag.store.stats
    check(stats.quantized_scans > 0 and
          stats.quantized_scans == stats.kernel_launches,
          f"quantized path: {stats.quantized_scans} quantized scans of "
          f"{stats.kernel_launches}")
    for mode, n in empty.items():
        check(n == 0, f"quantized {mode}: {n} queries returned no hits")
    check(all(a.hits > 0 for a in answers), "an answer had no hits")
    recall = {}
    for mode in modes:
        num = den = 0
        for a, b in zip(exact.query_batch(questions, mode=mode),
                        rets_q[mode]):
            want = {h.node_id for h in a.hits}
            den += len(want)
            num += len(want & {h.node_id for h in b.hits})
        recall[mode] = num / max(den, 1)

    # store level: scores, batch invariance, full coverage
    store, k = rag.store, cfg.top_k
    q_np = np.asarray(rag.embedder.encode(questions), np.float32)
    q = torch.from_numpy(q_np).cuda()
    n_scores = 0
    for filt in (None, "leaf", "summary"):
        hits_b = store.search_batch(q_np, k, filt)
        q_aug = mips_ops.augment_queries(q, _filter_bias(filt))
        for j, hits in enumerate(hits_b):
            check(bool(hits), f"quantized {filt}: query {j} has no hits")
            rows = [store._s.row_of[h.node_id] for h in hits]
            asc = torch.tensor(sorted(rows), device="cuda")
            ev, ei = mips_ops.mips_topk(q_aug[j:j + 1].contiguous(),
                                        store._s.buf[asc].contiguous(),
                                        len(rows))
            check(asc[ei[0].long()].tolist() == rows and torch.equal(
                ev[0].cpu(), torch.tensor([h.score for h in hits],
                                          dtype=torch.float32)),
                  f"quantized {filt}: query {j}'s scores are not the "
                  f"exact kernel's")
            n_scores += len(hits)
            one = store.search_batch(q_np[j:j + 1], k, filt)[0]
            check(_hits_key(one) == _hits_key(hits),
                  f"quantized {filt}: b=1 differs from b={len(q_np)} at "
                  f"row {j}")
    # store-level recall@8 against the exact scan as C grows
    want = exact.store.search_batch(q_np, k)
    recall_by_c = {}
    for mult in (4, 16, 64, 256, 1024):
        store.coarse_mult = mult
        num = 0
        for a, b in zip(want, store.search_batch(q_np, k)):
            num += len({h.node_id for h in a} & {h.node_id for h in b})
        recall_by_c[min(mult * k, store._group.capacity)] = \
            num / sum(len(a) for a in want)
    store.coarse_mult = FULL_COVERAGE
    for filt in (None, "leaf", "summary"):
        check([_hits_key(h) for h in store.search_batch(q_np, k, filt)]
              == [_hits_key(h)
                  for h in exact.store.search_batch(q_np, k, filt)],
              f"quantized {filt}: C = capacity differs from the exact "
              f"path")
    for a, b in zip(rag.query_batch(questions),
                    exact.query_batch(questions)):
        check(_hits_key(a.hits) == _hits_key(b.hits) and
              a.context == b.context,
              "quantized: C = capacity retrieval differs from exact")
    store.coarse_mult = cfg.coarse_mult

    # tombstones: every 50th document removed, none of its rows returns
    victims = sorted({n.doc_id for n in rag.graph.nodes.values()
                      if n.layer == 0})[::50]
    dead = {nid for nid, n in rag.graph.nodes.items()
            if n.layer == 0 and n.doc_id in set(victims)}
    rag.remove_docs(victims)
    for mode in modes:
        for r in rag.query_batch(questions, mode=mode):
            ids = {h.node_id for h in r.hits}
            check(bool(ids) and not ids & dead and
                  ids <= set(rag.graph.nodes),
                  f"quantized {mode}: a removed row returned")
    check(store.stats.rows_tombstoned > 0, "no row was tombstoned")

    emit("quantized_path", rows=store.size,
         capacity=store._group.capacity, code_words=store._group.quant.n_words,
         n_coarse=min(cfg.coarse_mult * k, store._group.capacity),
         update_s=update_s, query_batch=len(questions),
         batches_per_s=batches_per_s, recall_at_8_vs_exact=recall,
         collapsed_recall_at_8_by_c=recall_by_c,
         launches=launches, hamming_topk_routes=ham_routes,
         graph_equal=True,
         scores_bitwise_exact_kernel=n_scores,
         full_coverage_equal=True, batch_invariant=True,
         removed_docs=len(victims), removed_rows=len(dead),
         rows_tombstoned=store.stats.rows_tombstoned)
    return rag, launches


# ---------------------------------------------------------------------------
# phase 6: hamming_topk and the rescore
# ---------------------------------------------------------------------------

def quantized_codes_case(rag_q, q):
    """``lsh_hash`` at the quantized path's k (``scan_bits`` planes) on
    the store's own rows, and the codes that path made with it: the
    store's code plane (hashed at append, tombstoned in place) and the
    query codes of every filter, against the plain ``lsh_hash_ref`` plus
    the flag groups those rows and filters call for."""
    from repro_torch.core.store import _filter_bias
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref
    from repro_torch.kernels.quantized_scan import ops as quant_ops

    grp, n = rag_q.store._group, rag_q.store._s.count
    spec, planes, d = grp.quant, grp.planes, grp.dim
    cw, fw = spec.code_words, spec.flag_words
    v = grp.buf[:n, :d].contiguous()
    case = lsh_case(v, planes, "quantized main path")
    # the query encoding's hash: the 64 questions under the scan planes
    case["query_encoding"] = lsh_case(q, planes, "query encoding")
    # the code plane: real words within the flip band of the plain hash,
    # each flag group all ones exactly where the row's flag is set
    codes = grp.codes[:n]
    plane_flips, plane_proj = lsh_flips(codes[:, :cw],
                                        lsh_hash_ref(v, planes), v, planes,
                                        "code plane")
    for j in range(spec.n_flags):
        lo, hi = spec.flag_group(j)
        want = torch.where(grp.buf[:n, d + j] > 0, -1, 0) \
            .to(torch.int32)[:, None].expand(n, fw)
        check(torch.equal(codes[:, lo:hi], want),
              f"code plane: flag group {j} disagrees with the rows' flags")
    # the query codes: real words as above, flag groups from the bias
    query_flips = 0
    for filt in (None, "leaf", "summary"):
        bias = _filter_bias(filt)
        qc = quant_ops.encode_queries(q, planes, bias, spec)
        flips, proj = lsh_flips(qc[:, :cw], lsh_hash_ref(q, planes), q,
                                planes, f"query codes {filt}")
        query_flips += flips
        plane_proj = max(plane_proj, proj)
        for j, bj in enumerate(bias):
            lo, hi = spec.flag_group(j)
            word = 0 if bj != 0.0 else 0x55555555
            check(bool((qc[:, lo:hi] == word).all()),
                  f"query codes {filt}: flag group {j} is not {word:#x}")
    case.update(code_plane_rows=n, code_plane_bits_flipped=plane_flips,
                query_code_bits_flipped=query_flips,
                codes_max_flip_proj=plane_proj, flag_groups_equal=True)
    return case


def hamming_case(qc, dbc, c, label, ops_rate):
    from repro_torch.kernels.hamming_topk import ops
    from repro_torch.kernels.hamming_topk.ref import hamming_topk_ref
    from repro_torch.kernels.timing import kernel_ms, time_ms

    b, w = qc.shape
    n = dbc.shape[0]
    grid = ops.hamming_route(
        b, n, w, c, torch.cuda.get_device_properties(0).multi_processor_count)
    before = ops.route_launch_counts()
    dist, idx = ops.hamming_topk(qc, dbc, c)
    after = ops.route_launch_counts()
    check([r for r in ops.ROUTES if after[r] != before[r]] == [grid.route],
          f"hamming_topk {label}: launched {after} after {before}, not "
          f"the {grid.route} route")
    pd, pi = hamming_topk_ref(qc, dbc, c)
    torch.cuda.synchronize()
    check(torch.equal(dist, pd) and torch.equal(idx, pi),
          f"hamming_topk {label}: differs from the plain version")
    ties = int((dist[:, 1:] == dist[:, :-1]).sum())
    ms = time_ms(lambda: ops.hamming_topk(qc, dbc, c))
    plain_ms = time_ms(lambda: hamming_topk_ref(qc, dbc, c), reps=3,
                       warmup=1)
    bound_ms, bound_by = bound(4.0 * (n * w + b * w + 2 * b * c),
                               float(b * n * w), ops_rate)
    # device-only: each kernel of the call (no host work of the wrapper)
    kernels = kernel_ms(lambda: ops.hamming_topk(qc, dbc, c))
    kernel_device_ms = sum(kernels.values())
    return {"shape": {"b": b, "n": n, "w": w, "C": c},
            "kernel_route": grid.route, "grid": grid._asdict(),
            "max_abs_err": int((dist - pd).abs().max()),
            "bitwise_equal": True, "equal_distance_neighbours": ties,
            "kernel_ms": ms, "kernel_device_ms": kernels,
            "device_ms": kernel_device_ms,
            "bound_share": bound_ms / ms,
            "device_bound_share": bound_ms / kernel_device_ms
            if kernel_device_ms else None,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, dist, idx


def rescore_case(q_aug, db, cand, k, label, planted=()):
    """The rescore against its plain version and the exact scan; its
    launches (one a call by the wrapper's count; the profiler must see
    that kernel alone, at most once a call, as it may drop records),
    event, device-only and wrapper host times, and a composition of
    library calls as a yardstick.  ``planted``: rows that must lead
    query 0's list, in row order."""
    from repro_torch.kernels.common import rescore_grid
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_rescore_ref
    from repro_torch.kernels.timing import device_ms, kernel_ms, time_ms

    b, d = q_aug.shape
    c = cand.shape[1]
    before = ops.rescore_launch_count()
    vals, idx = ops.mips_rescore(q_aug, db, cand, k)
    check(ops.rescore_launch_count() == before + 1,
          f"mips_rescore {label}: {ops.rescore_launch_count() - before} "
          f"launches for one call")
    pv, pi = mips_rescore_ref(q_aug, db, cand, min(k + 1, c))
    torch.cuda.synchronize()
    max_err, id_diffs = near_tie_check(vals, idx, pv, pi, k,
                                       f"mips_rescore {label}")
    # each returned score is bitwise the exact kernel's for its row
    for j in range(b):
        rows = torch.sort(idx[j].long()).values
        ev, ei = ops.mips_topk(q_aug[j:j + 1].contiguous(),
                               db[rows].contiguous(), k)
        check(torch.equal(ev[0], vals[j]) and
              torch.equal(rows[ei[0].long()], idx[j].long()),
              f"mips_rescore {label}: query {j}'s scores are not the "
              f"exact kernel's")
    check(idx[0, :len(planted)].tolist() == list(planted),
          f"mips_rescore {label}: query 0 leads with "
          f"{idx[0, :len(planted)].tolist()}, not the planted rows "
          f"{list(planted)} in order")
    ms = time_ms(lambda: ops.mips_rescore(q_aug, db, cand, k))
    plain_ms = time_ms(lambda: mips_rescore_ref(q_aug, db, cand, k),
                       reps=5)
    # device-only, and the kernels the profiler saw per call
    launches = {}
    kernels = kernel_ms(lambda: ops.mips_rescore(q_aug, db, cand, k),
                        launches=launches)
    device = sum(kernels.values())
    check(set(launches) == {"mips_rescore_kernel"} and
          0 < launches["mips_rescore_kernel"] <= 1,
          f"mips_rescore {label}: kernel launches per call {launches}")
    # the wrapper's host time: a call's return after an idle card
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.mips_rescore(q_aug, db, cand, k)
        host.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    rows_read = int(torch.unique(cand).numel())
    bound_ms, bound_by = bound(
        4.0 * (rows_read * d + b * d + b * c) + 8.0 * b * k,
        2.0 * b * c * d)

    # a composition of library calls (gather, batched product, top-k),
    # timed as a yardstick only: the port never calls it
    def composition():
        rows = db[cand.long()]
        return torch.topk(torch.bmm(rows, q_aug[:, :, None])[:, :, 0], k)
    return {"shape": {"b": b, "C": c, "d": d, "k": k,
                      "distinct_rows": rows_read},
            "grid": rescore_grid(b, c, torch.cuda.get_device_properties(
                0).multi_processor_count)._asdict(),
            "max_abs_err": max_err, "tolerance": SCORE_TOL,
            "ids_differing_at_near_ties": id_diffs,
            "scores_bitwise_exact_kernel": True,
            "planted_rows_first": list(planted),
            "launches_per_call": 1,
            "profiler_launches_per_call": launches,
            "wrapper_host_us": statistics.median(host),
            "kernel_ms": ms, "kernel_device_ms": kernels,
            "device_ms": device, "bound_share": bound_ms / ms,
            "device_bound_share": bound_ms / device if device else None,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "composition": "torch.topk(torch.bmm(db[cand], q[:, :, None]))",
            "composition_ms": time_ms(composition),
            "composition_device_ms": device_ms(composition)}


def run_hamming(rag_q, questions):
    from repro_torch.core.store import _filter_bias
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.quantized_scan import ops as quant_ops
    from repro_torch.kernels.timing import time_ms

    rate = popc_per_s()
    grp = rag_q.store._group
    spec, planes = grp.quant, grp.planes
    bias = _filter_bias(None)
    k = rag_q.cfg.top_k
    q = torch.from_numpy(np.asarray(rag_q.embedder.encode(questions),
                                    np.float32)).cuda()
    c_main = min(rag_q.cfg.coarse_mult * k, grp.capacity)
    lsh_main = quantized_codes_case(rag_q, q)
    qc = quant_ops.encode_queries(q, planes, bias, spec)
    ham_main, _, cand = hamming_case(qc, grp.codes, c_main, "main path",
                                     rate)
    # the list route's largest C at the same shape
    ham_main_cmax, _, _ = hamming_case(qc, grp.codes, ham_ops.LIST_MAX_C,
                                       "main path C=LIST_MAX_C", rate)
    q_aug = mips_ops.augment_queries(q, bias).contiguous()
    res_main = rescore_case(q_aug, grp.buf, cand, k, "main path")
    # one batch's device work on the quantized main path, whole and its
    # query encoding alone, beside the exact scan's at the same shape
    scan_main = {
        "two_stage_ms": time_ms(lambda: quant_ops.quantized_flagged_topk(
            q, grp.buf, grp.codes, k, c_main, bias, planes, spec)),
        "encode_queries_ms": time_ms(
            lambda: quant_ops.encode_queries(q, planes, bias, spec)),
        "exact_flagged_mips_topk_ms": time_ms(
            lambda: mips_ops.flagged_mips_topk(q, grp.buf, k, bias))}

    # 2^22 rows: real codes of random unit rows, rows 1000..1003 copies
    # of row 999 (an alive leaf) and query 0 equal to it
    gen = torch.Generator(device="cuda").manual_seed(3)
    d = rag_q.cfg.embed_dim
    db = torch.zeros(N_DEPLOY, d + 3, device="cuda")
    db[:, :d] = torch.nn.functional.normalize(
        torch.randn(N_DEPLOY, d, device="cuda", generator=gen), dim=1)
    flag = torch.rand(N_DEPLOY, device="cuda", generator=gen)
    db[:, d] = (flag < 0.1).float()                  # dead
    db[:, d + 1] = (flag >= 0.7).float()             # summary
    db[:, d + 2] = (flag < 0.7).float()              # leaf
    db[999, d:] = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    db[1000:1004] = db[999]
    qd = torch.nn.functional.normalize(
        torch.randn(64, d, device="cuda", generator=gen), dim=1)
    qd[0] = db[999, :d]
    codes = quant_ops.encode_rows(db[:, :d], db[:, d:], planes, spec)
    qcd = quant_ops.encode_queries(qd, planes, bias, spec)
    qd_aug = mips_ops.augment_queries(qd, bias).contiguous()
    deploy = {}
    for c in (32, 4096):
        ham, dist, cand = hamming_case(qcd, codes, c, f"2^22 C={c}", rate)
        check(cand[0, :5].tolist() == list(range(999, 1004)),
              f"hamming_topk 2^22 C={c}: planted duplicates out of order")
        if c == 32:
            # one query (the duplicates' own): query 0 of the batch
            ham_b1, d1, i1 = hamming_case(qcd[:1].contiguous(), codes, c,
                                          "2^22 b=1 C=32", rate)
            check(torch.equal(d1, dist[:1]) and torch.equal(i1, cand[:1]),
                  "hamming_topk 2^22 C=32: b=1 differs from b=64")
            ham["b1"] = ham_b1
        # query 0 is row 999: it and its copies 1000..1003 lead, in order
        deploy[c] = {"hamming_topk": ham,
                     "mips_rescore": rescore_case(qd_aug, db, cand, k,
                                                  f"2^22 C={c}",
                                                  planted=range(999, 1004))}
        deploy[c]["two_stage_ms"] = time_ms(
            lambda: quant_ops.quantized_flagged_topk(
                qd, db, codes, k, c, bias, planes, spec))
    deploy["exact_flagged_mips_topk_ms"] = time_ms(
        lambda: mips_ops.flagged_mips_topk(qd, db, k, bias))
    del db, codes
    torch.cuda.empty_cache()
    emit("hamming_topk", popc_per_s=rate,
         main_path={"lsh_hash_quantized": lsh_main,
                    "hamming_topk": ham_main,
                    "hamming_topk_c_list_max": ham_main_cmax,
                    "mips_rescore": res_main,
                    **scan_main},
         at_2_22={f"C={c}": v for c, v in deploy.items()
                  if isinstance(c, int)},
         exact_flagged_mips_topk_ms_at_2_22=deploy[
             "exact_flagged_mips_topk_ms"])
    return lsh_main, ham_main, res_main, deploy[32], deploy[4096]


# ---------------------------------------------------------------------------
# phase 6b: the sharded store
# ---------------------------------------------------------------------------

MODES = ("collapsed", "detailed", "summarized")


def _bits_key(hits, seqs=True):
    """A hit list by node id, layer, sequence number (unless a fresh
    build numbered the rows anew) and the score's bits."""
    return [(h.node_id, h.layer, h.seq if seqs else None,
             int(np.float32(h.score).view(np.uint32))) for h in hits]


class KernelInputs:
    """While active, the inputs that the stores and the LSH hand their
    kernels: the exact scans (``flagged_mips_topk``, and ``mips_topk``
    on a shard's slot view), the hashes (``lsh_hash``, of chunks and of
    the quantized code plane and queries), and the quantized scan's
    ``hamming_topk`` and ``mips_rescore``: each call counted by shape,
    and the first call of each shape kept (its tensors copied on the
    device, with no wait for the host), so that every shape a path
    launched can afterwards be held against the plain version."""

    def __init__(self):
        from repro_torch.core import lsh, store
        from repro_torch.kernels.quantized_scan import ops as quant_ops
        self._slots = ((store, "flagged_mips_topk"), (store, "mips_topk"),
                       (lsh, "lsh_hash"), (quant_ops, "lsh_hash"),
                       (quant_ops, "hamming_topk"),
                       (quant_ops, "mips_rescore"))
        self._orig = [getattr(m, name) for m, name in self._slots]
        # shape -> [calls, inputs]; a scan's inputs are (queries, rows,
        # k, flag bias), the bias None where the queries came augmented
        self.mips, self.lsh, self.ham, self.rescore = {}, {}, {}, {}

        def keep(table, key, inputs):
            if key not in table:
                table[key] = [0, tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in inputs)]
            table[key][0] += 1

        def scan(q, db, k, bias, orig=self._orig[0]):
            keep(self.mips, (q.shape[0], db.shape[0], k, tuple(bias)),
                 (q, db, k, tuple(bias)))
            return orig(q, db, k, bias)

        def slot_scan(q_aug, db, k, orig=self._orig[1]):
            # the slot scans' flag bias lives in the queries' last three
            # columns on the card: kept by shape, as given
            keep(self.mips, (q_aug.shape[0], db.shape[0], k, None),
                 (q_aug, db, k, None))
            return orig(q_aug, db, k)

        def hash_(v, h, orig):
            keep(self.lsh, (v.shape[0], h.shape[1]), (v, h))
            return orig(v, h)

        def ham(qc, dbc, c, orig=self._orig[4]):
            keep(self.ham, (qc.shape[0], dbc.shape[0], qc.shape[1], c),
                 (qc, dbc, c))
            return orig(qc, dbc, c)

        def resc(q_aug, db, cand, k, orig=self._orig[5]):
            keep(self.rescore, (q_aug.shape[0], db.shape[0],
                                cand.shape[1], k), (q_aug, db, cand, k))
            return orig(q_aug, db, cand, k)

        self._seen = (scan, slot_scan,
                      lambda v, h: hash_(v, h, self._orig[2]),
                      lambda v, h: hash_(v, h, self._orig[3]), ham, resc)

    def __enter__(self):
        for (mod, name), fn in zip(self._slots, self._seen):
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self._slots, self._orig):
            setattr(mod, name, fn)

    def calls(self, name):
        return sum(c for c, _ in getattr(self, name).values())

    def held(self, phase):
        """Every shape kept, its kernel against the plain version on the
        inputs it was given (a scan's queries also one at a time, each
        bitwise its batch row), untimed: per kernel a list of
        ``{"shape", "calls", "max_abs_err", ...}``, each with its inputs
        under ``"inputs"``."""
        from repro_torch.kernels.hamming_topk import ops as ham_ops
        from repro_torch.kernels.hamming_topk.ref import hamming_topk_ref
        from repro_torch.kernels.lsh_hash import ops as lsh_ops
        from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref
        from repro_torch.kernels.mips_topk import ops as mips_ops
        from repro_torch.kernels.mips_topk.ref import mips_rescore_ref, \
            mips_topk_ref

        out = {"mips_topk": [], "lsh_hash": [], "hamming_topk": [],
               "mips_rescore": []}
        for calls, (q, db, k, bias) in self.mips.values():
            b = q.shape[0]
            label = f"{phase} mips_topk b={b} n={db.shape[0]}"
            q_aug = (q if bias is None else
                     mips_ops.augment_queries(q, bias)).contiguous()
            vals, idx = mips_ops.mips_topk(q_aug, db, k)
            pv, pi = mips_topk_ref(q_aug, db, min(k + 1, db.shape[0]))
            err, diffs = near_tie_check(vals, idx, pv, pi, k, label)
            for j in range(b):
                v1, i1 = mips_ops.mips_topk(q_aug[j:j + 1], db, k)
                check(torch.equal(v1, vals[j:j + 1]) and
                      torch.equal(i1, idx[j:j + 1]),
                      f"{label}: b=1 differs from b={b} at row {j}")
            out["mips_topk"].append({
                "shape": list(q_aug.shape) + [db.shape[0], k],
                "flag_bias": None if bias is None else list(bias),
                "calls": calls, "max_abs_err": err,
                "ids_differing_at_near_ties": diffs,
                "batch_invariant": True, "inputs": (q_aug, db, k)})
        for calls, (v, h) in self.lsh.values():
            flips, proj = lsh_flips(lsh_ops.lsh_hash(v, h),
                                    lsh_hash_ref(v, h), v, h,
                                    f"{phase} n={v.shape[0]}")
            out["lsh_hash"].append({
                "shape": list(v.shape) + [h.shape[1]], "calls": calls,
                "bits_flipped": flips, "max_abs_err": proj,
                "inputs": (v, h)})
        for calls, (qc, dbc, c) in self.ham.values():
            dist, idx = ham_ops.hamming_topk(qc, dbc, c)
            pd, pi = hamming_topk_ref(qc, dbc, c)
            check(torch.equal(dist, pd) and torch.equal(idx, pi),
                  f"{phase} hamming_topk b={qc.shape[0]} "
                  f"n={dbc.shape[0]}: differs from the plain version")
            out["hamming_topk"].append({
                "shape": list(qc.shape) + [dbc.shape[0], c],
                "calls": calls, "max_abs_err": 0})
        for calls, (q_aug, db, cand, k) in self.rescore.values():
            vals, idx = mips_ops.mips_rescore(q_aug, db, cand, k)
            pv, pi = mips_rescore_ref(q_aug, db, cand,
                                      min(k + 1, cand.shape[1]))
            err, diffs = near_tie_check(
                vals, idx, pv, pi, k,
                f"{phase} mips_rescore b={q_aug.shape[0]}")
            out["mips_rescore"].append({
                "shape": list(q_aug.shape) + [db.shape[0],
                                              cand.shape[1], k],
                "calls": calls, "max_abs_err": err,
                "ids_differing_at_near_ties": diffs})
        return out

    def cases(self, phase, timed=False):
        """``held`` for the JSON line; with ``timed``, each scan and hash
        shape also timed as the kernels' own phases time theirs
        (``mips_times``, ``lsh_times``)."""
        out = {}
        for name, cases in self.held(phase).items():
            for case in cases:
                inputs = case.pop("inputs", None)
                if timed and name == "mips_topk":
                    case.update(mips_times(*inputs))
                elif timed and name == "lsh_hash":
                    case.update(lsh_times(*inputs))
            if cases:
                out[name] = cases
        return out


class PathLaunches:
    """The kernels' launch counters over the steps of a path: set to 0
    when it starts, and only the steps run through ``drive`` count (the
    checks' own searches in between do not). With ``record``, ``inputs``
    keeps the shapes and inputs of the scans and hashes those steps
    launch (a ``KernelInputs``)."""

    def __init__(self, record=False):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.hamming_topk import ops as ham_ops
        from repro_torch.kernels.lsh_hash import ops as lsh_ops
        from repro_torch.kernels.mips_topk import ops as mips_ops

        def attention(pass_, route):
            return lambda: fa_ops.route_launch_counts()[pass_][route]

        self.read = {"lsh_hash": lsh_ops.launch_count,
                     "mips_topk": mips_ops.launch_count,
                     "hamming_topk": ham_ops.launch_count,
                     "mips_rescore": mips_ops.rescore_launch_count,
                     "merge_sharded_topk": mips_ops.merge_launch_count,
                     # by route: the bf16 tensor-core kernels, and the
                     # fp32 FMA kernels (suffix _fp32)
                     **{f"flash_attention_{pass_}{suffix}":
                        attention(pass_, route)
                        for pass_ in ("fwd", "bwd")
                        for suffix, route in (("", "tensor_core_bf16"),
                                              ("_fp32", "fma_fp32"))}}
        for ops in (lsh_ops, mips_ops, ham_ops, fa_ops):
            ops.reset_launch_count()
        self.counts = dict.fromkeys(self.read, 0)
        self.inputs = KernelInputs() if record else None

    def drive(self, fn):
        before = {k: f() for k, f in self.read.items()}
        if self.inputs is None:
            out = fn()
        else:
            with self.inputs:
                out = fn()
        for k, f in self.read.items():
            self.counts[k] += f() - before[k]
        return out


def _query_hits(rag, questions):
    return {mode: [_bits_key(r.hits)
                   for r in rag.query_batch(questions, mode=mode)]
            for mode in MODES}


def _batches_per_s_in_turns(rag, stores, questions, reps=10):
    """``{name: {mode: batches/s}}`` of ``rag.query_batch`` with each of
    ``stores`` (``{name: store}``, all synced to ``rag.graph``) swapped
    in, in turns (a b b a), each turn's median batch time; ``rag.store``
    is left as it was."""
    keep = rag.store
    times = {name: {mode: [] for mode in MODES} for name in stores}
    names = list(stores)
    for name in names + names[::-1]:
        rag.store = stores[name]
        for mode in MODES:
            rag.query_batch(questions, mode=mode)
            torch.cuda.synchronize()
            for _ in range(reps):
                t0 = time.perf_counter()
                rag.query_batch(questions, mode=mode)
                times[name][mode].append(time.perf_counter() - t0)
    rag.store = keep
    return {name: {mode: 1.0 / statistics.median(t)
                   for mode, t in by_mode.items()}
            for name, by_mode in times.items()}


def _same_store_hits(a, b, q, k, seqs, what):
    for filt in (None, "leaf", "summary"):
        got = a.search_batch(q, k, filt)
        want = b.search_batch(q, k, filt)
        check([_bits_key(h, seqs) for h in got]
              == [_bits_key(h, seqs) for h in want],
              f"sharded path: {what} ({filt}) differs")


def run_sharded_path(corpus, rag, rag_q, questions):
    """The main path's ``rag`` resharded in place: every hit bitwise the
    flat store's, through removal, re-insertion and reshards, and the
    quantized ``rag_q`` resharded, equal to the exact sharded store at
    C = capacity."""
    from repro_torch.core.store import ShardedVectorStore, VectorStore, \
        _filter_bias, slot_topk
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.timing import device_ms, time_ms

    k = rag.cfg.top_k
    q = np.asarray(rag.embedder.encode(questions), np.float32)
    flat_store = rag.store
    flat_hits = _query_hits(rag, questions)
    flat_launches = {}
    for mode in MODES:
        before = mips_ops.launch_count()
        rag.query_batch(questions, mode=mode)
        flat_launches[mode] = mips_ops.launch_count() - before

    path = PathLaunches()
    reshard_s = {}

    def reshard(n):
        t0 = time.perf_counter()
        path.drive(lambda: rag.reshard(n))
        torch.cuda.synchronize()
        reshard_s[str(n)] = time.perf_counter() - t0

    reshard(4)
    check(isinstance(rag.store, ShardedVectorStore) and
          rag.store.n_shards == 4, "sharded path: reshard(4)")
    check(path.drive(lambda: _query_hits(rag, questions)) == flat_hits,
          "sharded path: reshard(4) hits differ from the flat store's")
    # timed outside the path's count: the flat turns launch too
    bps = _batches_per_s_in_turns(
        rag, {"flat": flat_store, "sharded": rag.store}, questions)
    # the store layer alone: one search_batch (scan(s), merge, read-back,
    # hits), event ms in turns (flat, sharded, sharded, flat)
    search_ms = {"flat": [], "sharded": []}
    for name in ("flat", "sharded", "sharded", "flat"):
        st = flat_store if name == "flat" else rag.store
        search_ms[name].append(time_ms(lambda: st.search_batch(q, k),
                                       reps=20))
    del flat_store
    sharded_launches = {}
    for mode in MODES:
        before = (mips_ops.launch_count(), mips_ops.merge_launch_count())
        path.drive(lambda: rag.query_batch(questions, mode=mode))
        sharded_launches[mode] = {
            "mips_topk": mips_ops.launch_count() - before[0],
            "merge_sharded_topk": mips_ops.merge_launch_count() - before[1]}
    report_4 = rag.store.shard_report()
    # the merge alone, on this path's (4, 64, 8) candidates
    store = rag.store
    q_aug = mips_ops.augment_queries(torch.from_numpy(q).cuda(),
                                     _filter_bias(None)).contiguous()
    parts = [slot_topk(q_aug, sh.buf, store._group.seq_view(sh.slot), k)
             for sh in store._shards if sh.count]
    merge_in = (torch.stack([v for v, _ in parts]),
                torch.stack([i for _, i in parts]))
    merge_device_ms = device_ms(
        lambda: mips_ops.merge_sharded_topk(*merge_in, k))

    # the last growth round's documents out and back in, against a flat
    # store that tracks the same graph (a fresh build: its own numbers)
    tracker = VectorStore(rag.graph, device="cuda")
    _same_store_hits(store, tracker, q, k, False, "before removal")
    _, rounds = corpus.growth_rounds(0.5, 5)
    last = rounds[-1]
    t0 = time.perf_counter()
    path.drive(lambda: rag.remove_docs([doc for doc, _ in last]))
    remove_s = time.perf_counter() - t0
    _same_store_hits(store, tracker, q, k, False, "after removal")
    t0 = time.perf_counter()
    path.drive(lambda: rag.insert_docs(last))
    reinsert_s = time.perf_counter() - t0
    _same_store_hits(store, tracker, q, k, False, "after re-insertion")
    st = store.stats
    tombstoned, compacted = st.rows_tombstoned, st.compactions
    path.drive(store.compact)      # every shard's tombstones, inline
    _same_store_hits(store, tracker, q, k, False, "after compaction")
    compacted = {"rows_tombstoned": tombstoned,
                 "compactions_before": compacted,
                 "compactions": store.stats.compactions,
                 "compactions_skipped": store.stats.compactions_skipped}
    check(compacted["compactions"] > compacted["compactions_before"]
          and tombstoned > 0, f"sharded path: {store.stats}")
    reports = {"4": report_4}
    for n in (8, 1):
        before = _query_hits(rag, questions)
        reshard(n)
        check(_query_hits(rag, questions) == before,
              f"sharded path: reshard({n}) hits differ")
        _same_store_hits(rag.store, tracker, q, k, False,
                         f"after reshard({n})")
        if n > 1:
            reports[str(n)] = rag.store.shard_report()
    check(isinstance(rag.store, VectorStore), "reshard(1): not flat")
    launches = dict(path.counts)
    for name in ("lsh_hash", "mips_topk", "merge_sharded_topk"):
        check(launches[name] > 0,
              f"{name} never launched on the sharded path")

    # the quantized store resharded; C = capacity is the exact store
    path_q = PathLaunches()
    t0 = time.perf_counter()
    path_q.drive(lambda: rag_q.reshard(4))
    reshard_q_s = time.perf_counter() - t0
    qs = rag_q.store
    flat_q = VectorStore(rag_q.graph, device="cuda", quantized=True,
                         coarse_mult=rag_q.cfg.coarse_mult,
                         scan_bits=rag_q.cfg.scan_bits,
                         scan_seed=rag_q.cfg.seed)
    bps_q = _batches_per_s_in_turns(
        rag_q, {"flat": flat_q, "sharded": qs}, questions)
    del flat_q
    rets_q = path_q.drive(lambda: {m: rag_q.query_batch(questions, mode=m)
                                   for m in MODES})
    check(all(r.hits for rets in rets_q.values() for r in rets),
          "sharded quantized: a query returned no hits")
    launches_q = dict(path_q.counts)
    for name in ("lsh_hash", "hamming_topk", "mips_rescore",
                 "merge_sharded_topk"):
        check(launches_q[name] > 0,
              f"{name} never launched on the sharded quantized path")
    check(ham_ops.route_launch_counts()["count"] == 0,
          "sharded quantized: hamming_topk left the list route")
    exact = ShardedVectorStore(rag_q.graph, n_shards=4, device="cuda")
    qs.coarse_mult = FULL_COVERAGE
    _same_store_hits(qs, exact, q, k, False,
                     "quantized at C = capacity against exact")
    qs.coarse_mult = rag_q.cfg.coarse_mult
    route = store.stats      # the sharded store's own routing counters
    emit("sharded_path", rows=rag.store.size,
         batches_per_s_in_turns=bps, search_batch_ms_in_turns=search_ms,
         flat_launches_per_batch=flat_launches,
         sharded_launches_per_batch=sharded_launches,
         merge_device_ms=merge_device_ms,
         merge_shape=list(merge_in[0].shape),
         reshard_s=reshard_s, remove_s=remove_s, reinsert_s=reinsert_s,
         removed_docs=len(last),
         shard_report={n: [{key: r[key] for key in (
             "rows", "dead", "capacity", "device")} for r in rep]
             for n, rep in reports.items()},
         flat_capacity=tracker._group.capacity,
         routing={"route_hits": route.route_hits,
                  "route_misses": route.route_misses,
                  "bulk_routed": route.bulk_routed},
         sharded_stats=compacted,
         launches=launches, hits_bitwise_equal=True,
         quantized={"reshard_s": reshard_q_s,
                    "batches_per_s_in_turns": bps_q,
                    "launches": launches_q,
                    "shard_report": [{key: r[key] for key in (
                        "rows", "dead", "capacity")}
                        for r in qs.shard_report()],
                    "full_coverage_equals_exact": True})
    return launches, launches_q


# ---------------------------------------------------------------------------
# phases 6c-6f: the retrieval front without an LM
# ---------------------------------------------------------------------------

# the baselines that rebuild everything on the host every round run on
# this cut of the main path's corpus (same schedule): GraphRAG's label
# propagation is pure Python over every pair of chunks that share an
# entity, and RAPTOR re-embeds, re-clusters and re-summarizes the whole
# corpus each round
BASELINE_CUT_DOCS = 500
N_ONE_AT_A_TIME = 64


def baseline_scan_case(q, embs, k, label):
    """``mips_topk`` at b = 1 on a baseline's embedding matrix against
    its plain version and ``torch.topk(q @ db.T)``."""
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_topk_ref
    from repro_torch.kernels.timing import device_ms, kernel_ms, time_ms

    b, d = q.shape
    n = embs.shape[0]
    vals, idx = ops.mips_topk(q, embs, k)
    pv, pi = mips_topk_ref(q, embs, min(k + 1, n))
    torch.cuda.synchronize()
    max_err = float((vals - pv[:, :k]).abs().max())
    check(max_err <= SCORE_TOL,
          f"{label}: score error {max_err} > {SCORE_TOL}")
    ms = time_ms(lambda: ops.mips_topk(q, embs, k), reps=20)
    plain_ms = time_ms(lambda: mips_topk_ref(q, embs, k), reps=10)
    library_ms = time_ms(lambda: torch.topk(q @ embs.T, k), reps=20)
    kernels = kernel_ms(lambda: ops.mips_topk(q, embs, k))
    bound_ms, bound_by = bound(4.0 * (n * d + b * d) + 8.0 * b * k,
                               2.0 * b * n * d)
    return {"shape": {"b": b, "n": n, "d": d, "k": k},
            "max_abs_err": max_err, "kernel_ms": ms,
            "kernel_device_ms": kernels,
            "device_ms": sum(kernels.values()),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": device_ms(
                lambda: torch.topk(q @ embs.T, k)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def _one_at_a_time(system, questions):
    """ms per question of ``system.query`` asked one at a time, and the
    ``mips_topk`` launches of those questions."""
    from repro_torch.kernels.mips_topk import ops as mips_ops
    before = mips_ops.launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets = [system.query(q) for q in questions]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(questions) * 1e3
    return rets, ms, mips_ops.launch_count() - before


def _scans_against_plain(system, rets, questions, label):
    """Each question's card scan (``mips_topk`` at b = 1, the one its
    hits came from) against the plain scan of the same device
    embeddings: ids and order equal, except where a plain neighbour
    score lies within ``SCORE_TOL`` (a near-tie the two summation
    orders may swap); every hit is a row of its scan, in scan order.
    Returns (max score error, ids that differ at near-ties)."""
    from repro_torch.kernels.mips_topk.ref import mips_topk_ref
    embs = system._embs
    k = min(system.cfg.top_k, embs.shape[0])
    ids = [c.chunk_id for c in system.chunks] \
        if hasattr(system, "chunks") else system.ids
    q = torch.from_numpy(np.asarray(system.embedder.encode(questions),
                                    np.float32)).cuda()
    pv, pi = mips_topk_ref(q, embs, min(k + 1, embs.shape[0]))
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    max_err, near_diffs = 0.0, 0
    for j, (text, r) in enumerate(zip(questions, rets)):
        vals, idx = system._scan(text, k)
        max_err = max(max_err, float(np.abs(vals - pv[j, :k]).max()))
        for t in np.nonzero(idx != pi[j, :k])[0]:
            near = any(abs(pv[j, t] - pv[j, u]) <= SCORE_TOL
                       for u in (t - 1, t + 1) if 0 <= u < pv.shape[1])
            check(near, f"{label}: question {j} row {t} differs from the "
                        f"plain scan away from a near-tie")
            near_diffs += 1
        scan_ids = iter(ids[int(i)] for i in idx)
        check(all(h.node_id in scan_ids for h in r.hits),
              f"{label}: question {j}'s hits are not its scan's rows")
    check(max_err <= SCORE_TOL, f"{label}: score error {max_err}")
    return max_err, near_diffs


def _flagged_scans_against_plain(rag, rets, questions, label):
    """An ``EraRAG``'s questions asked one at a time: ``mips_case`` holds
    the flagged scan of all of them against the plain scan and each
    b = 1 scan bitwise against its batch row; each question's hits are
    rows of its scan, in scan order."""
    from repro_torch.core.store import _filter_bias
    from repro_torch.kernels.mips_topk import ops

    store, k = rag.store, rag.cfg.top_k
    q = torch.from_numpy(np.asarray(rag.embedder.encode(questions),
                                    np.float32)).cuda()
    case = mips_case(q, store._s.buf, k, _filter_bias(None), label)
    _, idx = ops.flagged_mips_topk(q, store._s.buf, k, _filter_bias(None))
    for j, (row, r) in enumerate(zip(idx.cpu().tolist(), rets)):
        scan_ids = iter(store._s.row_ids[i] for i in row)
        check(all(h.node_id in scan_ids for h in r.hits),
              f"{label}: question {j}'s hits are not its scan's rows")
    return case


def run_baselines(corpus, path_launches):
    """The paper's comparison systems on the card: ``VanillaRAG`` on the
    main path's corpus and schedule, the others and an ``EraRAG`` on
    the cut corpus; seconds and tokens per round, 64 questions one at a
    time, and the b = 1 scan at the vanilla shape."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core import baselines
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder

    t_phase = time.perf_counter()
    cut = SyntheticCorpus.generate(n_docs=BASELINE_CUT_DOCS, n_topics=64,
                                   seed=0)
    schedules = {"main": corpus, "cut": cut}
    plan = (("VanillaRAG", "main"), ("BM25", "cut"), ("RaptorLike", "cut"),
            ("GraphRAGLike", "cut"), ("EraRAG", "cut"))
    out = {}
    vanilla = None
    for name, which in plan:
        src = schedules[which]
        init, rounds = src.growth_rounds(0.5, 5)
        questions = [qa.question for qa in src.qa[:N_ONE_AT_A_TIME]]
        cls = EraRAG if name == "EraRAG" else getattr(baselines, name)
        system = cls(ERARAG_DEFAULT, HashingEmbedder(dim=256),
                     device="cuda")
        round_s, round_tokens = [], []
        for docs in [init] + rounds:
            t0 = time.perf_counter()
            rep = path_launches.drive(lambda: system.insert_docs(docs))
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            round_tokens.append(rep.tokens_total)
        system.query(questions[0])                      # warm-up
        rets, q_ms, launches = path_launches.drive(
            lambda: _one_at_a_time(system, questions))
        check(all(r.hits for r in rets), f"baselines {name}: no hits")
        row = {"corpus_docs": len(src.docs), "round_s": round_s,
               "round_tokens": round_tokens,
               "ms_per_question": q_ms, "mips_topk_launches": launches}
        want_launches = 0 if name == "BM25" else len(questions)
        check(launches == want_launches,
              f"baselines {name}: {launches} mips_topk launches for "
              f"{len(questions)} questions")
        if name in ("VanillaRAG", "RaptorLike", "GraphRAGLike"):
            err, near = _scans_against_plain(system, rets, questions,
                                             f"baselines {name}")
            row.update(rows=int(system._embs.shape[0]),
                       max_abs_err_vs_plain=err,
                       ids_differing_at_near_ties=near)
        elif name == "EraRAG":
            case = _flagged_scans_against_plain(system, rets, questions,
                                                "baselines EraRAG")
            row.update(rows=case["shape"]["n"],
                       max_abs_err_vs_plain=case["max_abs_err"],
                       ids_differing_at_near_ties=case[
                           "ids_differing_at_near_ties"],
                       # the batch of its questions; each b = 1 row
                       # is held bitwise against it
                       scan_b64={k: case[k] for k in (
                           "shape", "kernel_ms", "device_ms", "bound_ms",
                           "bound_by", "plain_ms", "library_ms")})
        if name == "VanillaRAG":
            vanilla = system
        else:
            del system
        out[name] = row
    q = torch.from_numpy(np.asarray(vanilla.embedder.encode(
        [corpus.qa[0].question]), np.float32)).cuda()
    scan = baseline_scan_case(q, vanilla._embs, vanilla.cfg.top_k,
                              "baselines b=1 scan")
    del vanilla
    torch.cuda.empty_cache()
    emit("baselines", systems=out, b1_scan_at_vanilla_shape=scan,
         reduced={"cut_corpus_docs": BASELINE_CUT_DOCS,
                  "systems": ["BM25", "RaptorLike", "GraphRAGLike",
                              "EraRAG"],
                  "why": "these rebuild on the host every round "
                         "(GraphRAG's label propagation is pure Python "
                         "over every pair of chunks sharing an entity)"},
         seconds=time.perf_counter() - t_phase)
    return scan


CACHE_REPS = 10   # cold and warm batches timed per mode


def _rate_spread(seconds):
    """Batches/s of a list of batch times: the median's, and the
    quartiles' (slowest quartile first)."""
    q1, _, q3 = statistics.quantiles(seconds, n=4)
    return {"median": 1.0 / statistics.median(seconds),
            "q3_q1": [1.0 / q3, 1.0 / q1]}


def _cache_off_hits(rag, store, questions, mode, seqs):
    """``rag``'s batch served by ``store`` with the cache switched off."""
    keep = rag.store, rag.query_cache
    rag.store, rag.query_cache = store, None
    try:
        return [_bits_key(r.hits, seqs)
                for r in rag.query_batch(questions, mode=mode)]
    finally:
        rag.store, rag.query_cache = keep


def run_query_cache(corpus, rag, questions, path):
    """The main path's index restored with ``query_cache=True``: cold
    batches equal the cache-off store, warm batches launch nothing, a
    half-new batch sweeps its misses once, an insert burst moves the
    token."""
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.store import VectorStore, _filter_bias
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder

    def encode(qs):
        return torch.from_numpy(np.asarray(rag.embedder.encode(qs),
                                           np.float32)).cuda()

    t_phase = time.perf_counter()
    state = rag.state_dict(include_store=True)
    state["cfg"] = dict(state["cfg"], query_cache=True)
    t0 = time.perf_counter()
    rag_c = EraRAG.from_state(state, HashingEmbedder(dim=256),
                              device="cuda")
    restore_s = time.perf_counter() - t0
    check(rag_c.store.size == rag.store.size, "query cache: restore")

    def timed_batch(qs, mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rets = path.drive(lambda: rag_c.query_batch(qs, mode=mode))
        torch.cuda.synchronize()
        return rets, time.perf_counter() - t0

    # each mode: CACHE_REPS cold batches (the cache cleared before each)
    # then CACHE_REPS warm ones; the batch times are their medians
    cold, warm = {}, {}
    warm_launches = 0
    for mode in MODES:
        want = [_bits_key(r.hits)
                for r in rag.query_batch(questions, mode=mode)]
        cold[mode], warm[mode] = [], []
        for _ in range(CACHE_REPS):
            rag_c.query_cache.clear()
            rets, s = timed_batch(questions, mode)
            cold[mode].append(s)
            check([_bits_key(r.hits) for r in rets] == want,
                  f"query cache: cold {mode} batch differs from the "
                  f"cache-off store")
        for _ in range(CACHE_REPS):
            before = dict(path.counts)
            rounds = rag_c.stats["retrieval_rounds"]
            rets, s = timed_batch(questions, mode)
            warm[mode].append(s)
            check([_bits_key(r.hits) for r in rets] == want,
                  f"query cache: warm {mode} batch differs")
            warm_launches += sum(path.counts.values()) - \
                sum(before.values())
            check(rag_c.stats["retrieval_rounds"] == rounds and
                  path.counts == before,
                  f"query cache: the warm {mode} batch launched a kernel")
    # the cold batches above cleared each mode's entries; fill the
    # collapsed ones again, then 32 repeats and 32 new questions: one
    # sweep of the 32 misses
    path.drive(lambda: rag_c.query_batch(questions, mode="collapsed"))
    seen = set(questions)
    new_qs = list(dict.fromkeys(qa.question for qa in corpus.qa[64:]
                                if qa.question not in seen))[:32]
    half = questions[:32] + new_qs
    stats = rag_c.query_cache.stats
    before = (dict(path.counts), rag_c.stats["retrieval_rounds"],
              stats.misses, stats.hits_exact)
    rets, half_s = timed_batch(half, "collapsed")
    check(rag_c.stats["retrieval_rounds"] == before[1] + 1 and
          path.counts["mips_topk"] == before[0]["mips_topk"] + 1 and
          stats.misses == before[2] + 32 and
          stats.hits_exact == before[3] + 32,
          "query cache: a half-new batch is not one sweep of its misses")
    check([_bits_key(r.hits) for r in rets] ==
          [_bits_key(r.hits)
           for r in rag.query_batch(half, mode="collapsed")],
          "query cache: half-new batch differs")
    # the sweep's scan at its shape (b = 32, the new questions' rows)
    # against the plain scan
    half_scan = mips_case(encode(new_qs), rag_c.store._s.buf,
                          rag_c.cfg.top_k, _filter_bias(None),
                          "query cache half-new sweep")
    # an insert burst: the token moves, the next batch misses entirely
    burst = SyntheticCorpus.generate(n_docs=50, n_topics=64, seed=3).docs
    burst = [(f"qc-{d}", text) for d, text in burst]
    token = rag_c.store.cache_token
    t0 = time.perf_counter()
    path.drive(lambda: rag_c.insert_docs(burst))
    burst_s = time.perf_counter() - t0
    check(rag_c.store.cache_token != token, "query cache: token stuck")
    misses = stats.misses
    rets, after_s = timed_batch(questions, "collapsed")
    check(stats.misses == misses + len(questions) and
          stats.invalidations >= 1,
          "query cache: the batch after the burst hit a stale entry")
    tracker = VectorStore(rag_c.graph, device="cuda")
    check([_bits_key(r.hits, False) for r in rets] ==
          _cache_off_hits(rag_c, tracker, questions, "collapsed", False),
          "query cache: after the burst, hits differ from a cache-off "
          "store on the same graph")
    after_scan = mips_case(encode(questions), rag_c.store._s.buf,
                           rag_c.cfg.top_k, _filter_bias(None),
                           "query cache after the burst")
    del tracker, rag_c
    torch.cuda.empty_cache()
    scan_keys = ("shape", "max_abs_err", "ids_differing_at_near_ties",
                 "batch_invariant", "kernel_ms", "device_ms", "plain_ms",
                 "library_ms", "bound_ms", "bound_by")
    emit("query_cache", restore_s=restore_s, query_batch=len(questions),
         reps=CACHE_REPS,
         cold_batches_per_s={m: _rate_spread(t) for m, t in cold.items()},
         warm_batches_per_s={m: _rate_spread(t) for m, t in warm.items()},
         warm_over_cold={m: statistics.median(cold[m]) /
                         statistics.median(warm[m]) for m in MODES},
         warm_launches=warm_launches, half_new_batch_s=half_s,
         half_new_sweep_scan={k: half_scan[k] for k in scan_keys},
         after_burst_scan={k: after_scan[k] for k in scan_keys},
         burst_docs=len(burst), burst_insert_s=burst_s,
         after_burst_batch_s=after_s, cache_stats=stats.to_dict(),
         launches=dict(path.counts), hits_bitwise_equal=True,
         seconds=time.perf_counter() - t_phase)
    return dict(path.counts)


def run_ingest(rag, questions, path):
    """Two indexes at the main path's final state: a fresh burst and a
    removal through ``IngestService`` (ticks between query batches)
    against the same through ``insert_docs``/``remove_docs``."""
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.ingest import IngestService
    from repro_torch.kernels.lsh_hash import ops as lsh_ops
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref
    from repro_torch.serving.rag_pipeline import RAGPipeline

    t_phase = time.perf_counter()
    state = rag.state_dict(include_store=True)
    live = EraRAG.from_state(state, HashingEmbedder(dim=256),
                             device="cuda")
    twin = EraRAG.from_state(state, HashingEmbedder(dim=256),
                             device="cuda")
    burst = SyntheticCorpus.generate(n_docs=500, n_topics=64, seed=1).docs
    burst = [(f"s1-{d}", text) for d, text in burst]
    victim = burst[7][0]

    def batch_ms(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.query_batch(questions)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the same batch with the queue empty, on the index the ticks start
    # from, before any tick runs
    idle_before_ms = [batch_ms(live) for _ in range(20)]
    svc = IngestService(live)
    pipe = RAGPipeline(live, ingest=svc)
    svc.submit_many(burst)
    svc.remove([victim])

    # after each tick: one batch, then the same batch again with no tick
    # in between (a pair on the same index)
    tick_ms, per_embed_tick, tick_rows = {}, [], []
    between_ms, back_to_back_ms = [], []
    while not svc.idle:
        before = lsh_ops.launch_count()
        op = svc._ops[0]
        n_pre = len(getattr(op, "pre", ()))
        t0 = time.perf_counter()
        stage = path.drive(svc.tick)
        torch.cuda.synchronize()
        tick_ms.setdefault(stage, []).append(
            (time.perf_counter() - t0) * 1e3)
        if stage == "embed":
            per_embed_tick.append(lsh_ops.launch_count() - before)
            tick_rows.append(list(op.pre.values())[n_pre:])
        between_ms.append(path.drive(lambda: batch_ms(live)))
        back_to_back_ms.append(path.drive(lambda: batch_ms(live)))
    check(per_embed_tick and set(per_embed_tick) == {1},
          f"ingest: lsh_hash launches per embed tick {set(per_embed_tick)}")
    check(path.counts["lsh_hash"] > 0, "ingest: lsh_hash never launched")
    # the kernel at the embed ticks' shapes (a full tick and the last,
    # shorter one; k = 12) against its plain version on the rows those
    # ticks hashed, and the keys the ticks kept against the plain codes
    h = torch.from_numpy(live.graph.lsh.hyperplanes).cuda()
    tick_cases = {}
    for rows in (tick_rows[0], tick_rows[-1]):
        v = torch.from_numpy(np.stack([e for e, _ in rows])).cuda()
        kept = np.array([key for _, key in rows], np.uint64)
        kept = torch.from_numpy(kept.astype(np.uint32).view(np.int32)
                                .reshape(-1, 1)).cuda()
        label = f"ingest embed tick n={v.shape[0]}"
        flips, _ = lsh_flips(kept, lsh_hash_ref(v, h), v, h, label)
        tick_cases[v.shape[0]] = dict(lsh_case(v, h, label),
                                      kept_keys_bits_flipped=flips)
    check([k for k, _ in svc.committed_ops] == ["insert", "remove"],
          f"ingest: committed ops {svc.committed_ops[:2]}")
    t0 = time.perf_counter()
    twin.insert_docs(burst)
    twin.store.refresh()
    twin.remove_docs([victim])
    twin.store.refresh()
    twin_s = time.perf_counter() - t0
    check(list(live.graph.nodes) == list(twin.graph.nodes),
          "ingest: node ids differ from the synchronous twin")
    a = live.store.state_dict()["shard"]
    b = twin.store.state_dict()["shard"]
    check(np.asarray(a["buf"]).tobytes() == np.asarray(b["buf"]).tobytes()
          and a["row_ids"] == b["row_ids"]
          and np.array_equal(a["row_seq"], b["row_seq"]),
          "ingest: store rows differ from the synchronous twin")
    for mode in MODES:
        check([_bits_key(r.hits)
               for r in live.query_batch(questions, mode=mode)] ==
              [_bits_key(r.hits)
               for r in twin.query_batch(questions, mode=mode)],
              f"ingest: {mode} hits differ from the synchronous twin")
    idle_after_ms = [batch_ms(live) for _ in range(20)]
    del twin
    per_tick = sorted(set(per_embed_tick))
    scan_keys = ("shape", "grid", "bits_flipped", "max_abs_err",
                 "kept_keys_bits_flipped", "kernel_ms", "device_ms",
                 "plain_ms", "bound_ms", "bound_by")
    emit("ingest", burst_docs=len(burst), removed=[victim],
         ticks={s: len(t) for s, t in tick_ms.items()},
         lsh_hash_launches_per_embed_tick=per_tick,
         embed_tick_lsh_hash={n: {k: c[k] for k in scan_keys}
                              for n, c in tick_cases.items()},
         tick_ms={s: {"median": statistics.median(t), "max": max(t)}
                  for s, t in tick_ms.items()},
         query_batch_ms={
             name: _ms_spread(t) for name, t in (
                 ("after_a_tick", between_ms),
                 ("back_to_back", back_to_back_ms),
                 ("idle_before", idle_before_ms),
                 ("idle_after", idle_after_ms))},
         after_tick_over_back_to_back_median=statistics.median(
             a / b for a, b in zip(between_ms, back_to_back_ms)),
         sync_twin_s=twin_s, service=svc.report(),
         launches=dict(path.counts), bitwise_equal_sync=True,
         seconds=time.perf_counter() - t_phase)
    return pipe, dict(path.counts), per_tick


def _ms_spread(ms):
    q1, q2, q3 = statistics.quantiles(ms, n=4)
    return {"median": q2, "q1_q3": [q1, q3], "max": max(ms), "n": len(ms)}


def run_index_report(pipe):
    """The ingest phase's pipeline's ``index_report``: its sections,
    key counts and Prometheus text, its numbers against the live
    objects."""
    from repro_torch.lifecycle.report import ShardLoadReport
    from repro_torch.obs.schema import flatten_numeric, undeclared

    t_phase = time.perf_counter()
    rag = pipe.rag
    rep = pipe.index_report()
    prom = rag.obs.registry.to_prometheus()
    check(undeclared(rep) == [], f"index_report: undeclared "
                                 f"{undeclared(rep)}")
    live = {"size": rag.store.size, "epoch": rag.store.epoch,
            "retrieval_rounds": rag.stats["retrieval_rounds"]}
    check({k: rep[k] for k in live} == live, "index_report: scalars")
    check(rep["launches"]["retrieval_rounds"] ==
          rag.stats["retrieval_rounds"] and
          rep["stats"]["kernel_launches"] ==
          rag.store.stats.kernel_launches and
          rep["launches"]["embedder"] == rag.graph.embedder.stats and
          rep["launches"]["summarizer"] == rag.graph.stats and
          rep["ingest"]["service"] == pipe.ingest.report() and
          rep["load"] == ShardLoadReport.from_store(rag.store).to_dict(),
          "index_report: a section differs from its live object")
    flat = flatten_numeric(rep)
    emit("index_report",
         sections={k: len(flatten_numeric(v)) if isinstance(v, dict)
                   else 1 for k, v in rep.items()},
         numeric_keys=len(flat), prometheus_chars=len(prom),
         prometheus_lines=prom.count("\n"),
         store_size=rep["size"], kernel_launches=rep["stats"][
             "kernel_launches"],
         ingest_service=rep["ingest"]["service"],
         values_match_live_objects=True,
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phases 6g-6j: LM serving
# ---------------------------------------------------------------------------
SERVING_REF_TOL = 1e-4      # card vs CPU logits, fp32 tiny engine
# decode_step at position 300 against prefill of the 301 tokens, bf16
# through 32 layers in other GEMM shapes: |difference| within this
# share of the largest |logit|. On the H100 the sound decode read
# 0.0625 (1.1 %) and a planted off-by-one cache_len 0.125 (2.2 %) of
# 5.59; the limit lies between, and each run checks both sides
DECODE_REL_TOL = 1.6e-2
SERVE_MAX_BATCH = 8
SERVE_MAX_SEQ = 4096
SERVE_NEW_TOKENS = 32
# token lengths (BOS and EOS included) of the serving_engine prompts:
# buckets 128, 256 (two of the same length), 512, 1024, 2048 and 4096
# (two, one over 2048)
SERVE_PROMPT_LENGTHS = (120, 200, 200, 480, 900, 1800, 2600, 3000)


class TokenLog:
    """The logits each token of a run was chosen from, by (prompt,
    occurrence): the engine's ``_pick`` wrapped to read them, and its
    ``submit`` so request ids map back to prompts."""

    def __init__(self, engine):
        self.rows, self._key, self._seen = {}, {}, {}
        submit, pick = engine.submit, engine._pick

        def tracked(prompt, max_new_tokens=None, prefix=None):
            rid = submit(prompt, max_new_tokens, prefix)
            n = self._seen.get(prompt, 0)
            self._seen[prompt] = n + 1
            self._key[rid] = (prompt, n)
            return rid

        def observed(logits, rows, keys):
            for row, (rid, step) in zip(rows, keys):
                seen = self.rows.setdefault(self._key[rid], [])
                assert step == len(seen)
                seen.append(logits[row].detach().clone())
            return pick(logits, rows, keys)

        engine.submit, engine._pick = tracked, observed

    def stop(self, engine):
        del engine.submit, engine._pick


def _top2_margin(logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def margin_rule(a: TokenLog, b: TokenLog, what: str, keys=None) -> dict:
    """Two runs of the same prompts: at every step before they part the
    tokens are equal, and where they part the smaller top-1 over top-2
    margin must lie within the largest logit difference at that step.
    Returns the largest difference over the steps compared and each
    part."""
    keys = keys if keys is not None else [k for k in a.rows if k in b.rows]
    check(keys, f"{what}: no prompt in both runs")
    worst, parts, steps = 0.0, [], 0
    for key in keys:
        for step, (la, lb) in enumerate(zip(a.rows[key], b.rows[key])):
            la, lb = la.float(), lb.to(la.device).float()
            diff = float((la - lb).abs().max())
            worst = max(worst, diff)
            steps += 1
            if int(la.argmax()) != int(lb.argmax()):
                margin = min(_top2_margin(la), _top2_margin(lb))
                parts.append({"prompt_tokens": len(key[0].split()),
                              "step": step, "margin": margin,
                              "logit_diff": diff})
                check(margin <= diff,
                      f"{what}: tokens part at step {step} with a margin "
                      f"{margin} over the largest logit difference {diff}")
                break
    return {"max_logit_diff": worst, "steps_compared": steps,
            "parts": parts, "tokens_equal": not parts}


def _phase_start():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _phase_end(t0):
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def run_serving_reference():
    """The tiny ``make_test_engine`` recipe on the card and on the CPU,
    the weights drawn once on the CPU: tokens under the margin rule,
    stats equal, per-step logits within SERVING_REF_TOL; and prefix
    hits against the cold path on both devices."""
    from repro_torch.serving.testing import make_test_engine

    t0 = _phase_start()
    prompts = ["alpha beta", "tell me about alpha beta",
               "gamma delta question about the river",
               "a considerably longer question that lands in a larger "
               "padded bucket than the short prompts do, with more words",
               "epsilon zeta words", "eta theta iota kappa lambda mu"]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = make_test_engine(max_batch=6, max_seq_len=64, device=dev)
        log = TokenLog(eng)
        out = eng.generate_batch(prompts)
        runs[dev] = (eng, log, out)
    buckets = {runs["cpu"][0]._bucket_len(len(runs["cpu"][0].tok.encode(
        p, add_special=True))) for p in prompts}
    check(len(buckets) >= 2, f"serving_reference: buckets {buckets}")
    cold_cmp = margin_rule(runs["cpu"][1], runs["cuda"][1],
                           "serving_reference card vs CPU")
    check(cold_cmp["max_logit_diff"] <= SERVING_REF_TOL,
          f"serving_reference: logits differ by "
          f"{cold_cmp['max_logit_diff']}")
    check(runs["cpu"][0].stats == runs["cuda"][0].stats,
          f"serving_reference: stats {runs['cpu'][0].stats} vs "
          f"{runs['cuda'][0].stats}")
    ctx = "The capital of France is Paris and the river is Seine . "
    prefix = f"Context:\n{ctx}\n\n"
    pp = [prefix + f"Question: q{i} capital\nAnswer:" for i in range(5)]
    hits = {}
    for dev in ("cpu", "cuda"):
        cold = make_test_engine(max_batch=2, device=dev)
        warm = make_test_engine(max_batch=2, prefix_cache_entries=4,
                                device=dev)
        cl, wl = TokenLog(cold), TokenLog(warm)
        cold.generate_batch(pp)
        warm.generate_batch(pp, prefixes=[prefix] * len(pp))
        check(warm.stats["prefix_hits"] == 3,
              f"serving_reference {dev}: prefix hits {warm.stats}")
        hits[dev] = (margin_rule(cl, wl, f"serving_reference {dev} hit "
                                         f"vs cold"), wl)
    warm_cmp = margin_rule(hits["cpu"][1], hits["cuda"][1],
                           "serving_reference hits card vs CPU")
    check(warm_cmp["max_logit_diff"] <= SERVING_REF_TOL,
          f"serving_reference: hit logits differ by "
          f"{warm_cmp['max_logit_diff']}")
    emit("serving_reference", recipe="make_test_engine (2 layers, d 64, "
         "4 q / 2 kv heads, d_ff 128, vocab 512, fp32)",
         prompts=len(prompts), buckets=sorted(buckets),
         card_vs_cpu=cold_cmp, stats=runs["cuda"][0].stats,
         tolerance=SERVING_REF_TOL,
         hit_vs_cold={d: h[0] for d, h in hits.items()},
         hits_card_vs_cpu=warm_cmp, **_phase_end(t0))


class LaunchTimer:
    """Host-clock milliseconds of each engine launch of one kind (the
    card synchronized around it), with what it served."""

    def __init__(self, engine, name, info):
        self.records = []
        fn = getattr(engine, name)

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.records.append(dict(info(engine, *args),
                                     ms=(time.perf_counter() - t) * 1e3))
            return out

        setattr(engine, name, timed)


def _decode_profile(model, cfg, eng, length):
    """One ``decode_step`` of all 8 slots at ``length``: CUDA-event ms,
    the kernels it launches and their device ms, from the profiler."""
    from repro_torch.kernels.timing import kernel_ms, time_ms
    from repro_torch.models import transformer as T

    tok = torch.full((SERVE_MAX_BATCH, 1), 5, dtype=torch.int64,
                     device="cuda")
    rows = list(range(SERVE_MAX_BATCH))

    def step():
        with torch.inference_mode():
            T.decode_step(model, tok, eng.caches, length, cfg,
                          compute_dtype=torch.bfloat16, rows=rows)

    event_ms = time_ms(step, reps=10, warmup=2)
    launches = {}
    by_kernel = kernel_ms(step, reps=2, pattern=r"^(.+)$",
                          launches=launches)
    device = sum(by_kernel.values())
    # the launch counts also hold the host's runtime calls (no device
    # time): only the kernels are counted
    kinds = {}
    for name, ms in by_kernel.items():
        kind = _kernel_kind(name)
        ms_n = kinds.setdefault(kind, [0.0, 0.0])
        ms_n[0] += ms
        ms_n[1] += launches.get(name, 0)
    return {"length": length, "event_ms": event_ms, "device_ms": device,
            "kernels_per_step": sum(n for _, n in kinds.values()),
            "distinct_kernels": len(by_kernel),
            "host_share": (event_ms - device) / event_ms,
            "by_kind": {k: {"device_ms": v[0], "kernels": v[1]}
                        for k, v in sorted(kinds.items())}}


def _kernel_kind(name: str) -> str:
    """A profiler kernel name's kind: a cuBLAS product (fp32 or not),
    a copy (casts and gathers), an index write, a reduction, or another
    elementwise kernel."""
    if any(t in name for t in ("gemm", "nvjet", "xmma", "gemv", "cutlass")):
        return "gemm_fp32" if ("f32f32" in name or "<float" in name or
                               "sgemm" in name) else "gemm"
    if "copy" in name:
        return "copy"
    if "index" in name or "scatter" in name:
        return "index"
    if "reduce" in name:
        return "reduce"
    return "elementwise"


def run_serving_engine(corpus):
    """llama3-8b at all 32 layers, bf16, random weights from a seeded
    generator, behind an ``Engine`` of 8 slots x 4096 positions."""
    from repro_torch.configs.llama3_8b import llama3_8b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig

    t0 = _phase_start()
    cfg = llama3_8b()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
                        max_new_tokens=SERVE_NEW_TOKENS,
                        compute_dtype=torch.bfloat16,
                        prefix_cache_entries=64)
    eng = Engine(cfg, model, ecfg)
    check(eng.model is model, "serving_engine: the engine copied the model")
    fa_before = (fa_ops.launch_count(), fa_ops.bwd_launch_count())
    # corpus text as engine tokens; a prompt of n tokens (BOS and EOS
    # included) is n - 2 of them joined by spaces
    words = eng.tok.tokenize(" ".join(t for _, t in corpus.docs[:400]))
    prompts = [" ".join(words[i * 4000:i * 4000 + n - 2])
               for i, n in enumerate(SERVE_PROMPT_LENGTHS)]
    lengths = [len(eng.tok.encode(p, add_special=True)) for p in prompts]
    check(lengths == list(SERVE_PROMPT_LENGTHS),
          f"serving_engine: prompt lengths {lengths}")
    buckets = [eng._bucket_len(n) for n in lengths]

    prefill_t = LaunchTimer(eng, "_prefill_bucket", lambda e, t, l, s: {
        "bucket": int(t.shape[1]), "prompts": len(s),
        "tokens": int(np.sum(l))})
    decode_t = LaunchTimer(eng, "_decode_step", lambda e, t, n, rows: {
        "live_slots": sum(s.active for s in e.slots), "length": int(n)})
    batched_log = TokenLog(eng)
    before = dict(eng.stats)
    batched = eng.generate_batch(prompts)
    stats = {k: eng.stats[k] - before[k] for k in before}
    batched_log.stop(eng)
    seq_log = TokenLog(eng)
    sequential = [eng.generate(p) for p in prompts]
    seq_log.stop(eng)
    seq_cmp = margin_rule(batched_log, seq_log,
                          "serving_engine batched vs sequential")
    check(stats["prefill_launches"] < stats["prefill_prompts"],
          f"serving_engine: prefill launches {stats}")
    check(stats["decode_launches"] < stats["slot_steps"],
          f"serving_engine: decode launches {stats}")
    # every cold launch of the batched and sequential runs, by bucket
    # (the batched run's first launch of a bucket includes cuBLAS's
    # one-time choice of kernels)
    per_bucket = {}
    for r in prefill_t.records:
        b = per_bucket.setdefault(r["bucket"], {"ms": [], "tokens": []})
        b["ms"].append(r["ms"])
        b["tokens"].append(r["tokens"])
    for blen, b in per_bucket.items():
        med = statistics.median(b["ms"])
        b["median_ms"] = med
        b["tokens_per_s"] = [t / ms * 1e3 for t, ms in
                             zip(b["tokens"], b["ms"])]
        b["padded_tokens_per_s"] = SERVE_MAX_BATCH * blen / med * 1e3
    full = [r["ms"] for r in decode_t.records
            if r["live_slots"] == SERVE_MAX_BATCH]

    # prefix reuse: 2 prompts declare 2 contexts, then 8 prompts over
    # them are hits; their tokens against an engine without the cache
    ctxs = [" ".join(words[50000:51400]), " ".join(words[60000:60800])]
    pre = [f"Context:\n{c}\n\n" for c in ctxs]
    first = [pre[i] + "Question: what comes first?\nAnswer:"
             for i in range(2)]
    hit_prompts = [pre[i % 2] + f"Question: what is said of item {i}?"
                   f"\nAnswer:" for i in range(8)]
    hit_prefixes = [pre[i % 2] for i in range(8)]
    eng.generate_batch(first, prefixes=pre)
    hits_before = eng.stats["prefix_hits"]
    hit_log = TokenLog(eng)
    hit_out = eng.generate_batch(hit_prompts, prefixes=hit_prefixes)
    hit_log.stop(eng)
    check(eng.stats["prefix_hits"] - hits_before == 8,
          f"serving_engine: prefix hits {eng.stats['prefix_hits']} - "
          f"{hits_before}")
    off = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW_TOKENS, compute_dtype=torch.bfloat16))
    cold_log = TokenLog(off)
    cold_out = off.generate_batch(hit_prompts, prefixes=hit_prefixes)
    check(off.stats["prefix_hits"] == 0, "serving_engine: the cache-off "
                                         "engine hit")
    hit_cmp = margin_rule(hit_log, cold_log, "serving_engine hit vs cold")
    del off, cold_log

    # decode_step at position n against prefill of the n + 1 tokens
    ids = eng.tok.encode(prompts[3], add_special=True)[:301]
    ids = torch.from_numpy(ids.astype(np.int64))[None].cuda()
    with torch.inference_mode():
        _, cache = T.prefill(model, ids[:, :300], cfg, max_len=301,
                             compute_dtype=torch.bfloat16)
        dec, _ = T.decode_step(model, ids[:, 300:], cache, 300, cfg,
                               compute_dtype=torch.bfloat16)
        # a planted off-by-one: the same token decoded at cache_len 299
        # (its K/V over position 299's, rotated as 299, 300 positions
        # read), the fault the tolerance must tell apart
        off, _ = T.decode_step(model, ids[:, 300:], cache, 299, cfg,
                               compute_dtype=torch.bfloat16)
        ref, _ = T.prefill(model, ids, cfg, compute_dtype=torch.bfloat16)
    del cache
    dec_diff = float((dec.float() - ref.float()).abs().max())
    off_diff = float((off.float() - ref.float()).abs().max())
    dec_scale = float(ref.float().abs().max())
    check(bool(torch.isfinite(dec.float()).all()) and
          dec_diff <= DECODE_REL_TOL * dec_scale,
          f"serving_engine: decode vs prefill differ by {dec_diff} "
          f"(largest |logit| {dec_scale})")
    check(off_diff > DECODE_REL_TOL * dec_scale,
          f"serving_engine: an off-by-one cache_len moves the logits by "
          f"{off_diff}, within the tolerance {DECODE_REL_TOL * dec_scale}")

    profile = _decode_profile(model, cfg, eng, 3000)
    kv_bytes = sum(c.numel() * c.element_size() for c in eng.caches.values())
    weight_bytes = (cfg.param_count() - cfg.vocab_size * cfg.d_model) * 2
    bound_ms = (weight_bytes + kv_bytes) / MEM_BYTES_PER_S * 1e3
    live_kv = kv_bytes * 3001 / SERVE_MAX_SEQ
    # each timed 8-live step against the bytes it reads: the weights and
    # the first length + 1 positions of every slot's K/V
    full_recs = [r for r in decode_t.records
                 if r["live_slots"] == SERVE_MAX_BATCH]
    live_shares = [(weight_bytes + kv_bytes * (r["length"] + 1) /
                    SERVE_MAX_SEQ) / MEM_BYTES_PER_S * 1e3 / r["ms"]
                   for r in full_recs]
    check(fa_before == (fa_ops.launch_count(), fa_ops.bwd_launch_count()),
          "serving_engine: flash_attention launched on the serving path")
    median_decode = statistics.median(full) if full else None
    emit("serving_engine", model="llama3-8b", n_layers=cfg.n_layers,
         params=cfg.param_count(), compute_dtype="bfloat16",
         init_s=init_s, engine={"max_batch": SERVE_MAX_BATCH,
                                "max_seq_len": SERVE_MAX_SEQ,
                                "max_new_tokens": SERVE_NEW_TOKENS,
                                "prefix_cache_entries": 64},
         prompt_tokens=lengths, buckets=buckets, batched_stats=stats,
         batched_vs_sequential=seq_cmp,
         answers_equal=batched == sequential,
         prefix_hits=eng.stats["prefix_hits"], hit_vs_cold=hit_cmp,
         hit_answers_equal=hit_out == cold_out,
         decode_vs_prefill={"position": 300, "max_abs_diff": dec_diff,
                            "off_by_one_max_abs_diff": off_diff,
                            "max_abs_logit": dec_scale,
                            "tolerance": DECODE_REL_TOL * dec_scale},
         prefill_per_bucket=per_bucket,
         decode_step_ms_8_live={"median": median_decode, "n": len(full)},
         decode_step_bound_ms=bound_ms,
         decode_step_bound_by="bytes (bf16 weights without the embedding "
                              "table + K/V at max_seq_len)",
         decode_step_bound_share=bound_ms / median_decode
         if median_decode else None,
         decode_step_bound_ms_at_live_length=(weight_bytes + live_kv) /
         MEM_BYTES_PER_S * 1e3,
         decode_step_bound_share_at_live_length={
             "median": statistics.median(live_shares) if live_shares
             else None,
             "lengths": [min(r["length"] for r in full_recs),
                         max(r["length"] for r in full_recs)]
             if full_recs else None},
         decode_profile=profile, kv_cache_bytes=kv_bytes,
         flash_attention_launches=0, **_phase_end(t0))
    del eng
    return model, cfg


def _path_kernel_cases(path, phase, timed=False):
    """Every kernel shape that ``path``'s steps launched, held against
    the plain versions on the inputs they were given (``KernelInputs
    .cases``); the calls seen by shape must account for every launch
    counted."""
    rec = path.inputs
    for name, seen in (("mips_topk", "mips"), ("lsh_hash", "lsh"),
                       ("hamming_topk", "ham"),
                       ("mips_rescore", "rescore")):
        check(rec.calls(seen) == path.counts[name],
              f"{phase}: {rec.calls(seen)} {name} calls seen for "
              f"{path.counts[name]} launches")
    return rec.cases(phase, timed=timed)


def run_serving_rag(rag, corpus, model, cfg):
    """``RAGPipeline(rag, engine=...)`` over the main path's index: 16
    questions twice (the second pass all prefix hits), 4 through
    ``answer``, 8 multihop questions in two ``generate_batch`` calls."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.rag_pipeline import RAGPipeline

    t0 = _phase_start()
    path = PathLaunches(record=True)
    eng = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
        max_new_tokens=16, compute_dtype=torch.bfloat16,
        prefix_cache_entries=64))
    pipe = RAGPipeline(rag, engine=eng)
    questions = [qa.question for qa in corpus.qa
                 if qa.kind == "detailed"][:16]
    first_log = TokenLog(eng)
    t = time.perf_counter()
    first = path.drive(lambda: pipe.answer_batch(questions))
    first_s = time.perf_counter() - t
    first_log.stop(eng)
    hits0 = eng.stats["prefix_hits"]
    second_log = TokenLog(eng)
    t = time.perf_counter()
    second = path.drive(lambda: pipe.answer_batch(questions))
    second_s = time.perf_counter() - t
    second_log.stop(eng)
    check(eng.stats["prefix_hits"] - hits0 == len(questions),
          f"serving_rag: second pass hits "
          f"{eng.stats['prefix_hits'] - hits0}")
    check([a.context for a in first] == [a.context for a in second],
          "serving_rag: contexts differ between passes")
    pass_cmp = margin_rule(first_log, second_log,
                           "serving_rag second pass vs first")
    one_log = TokenLog(eng)
    singles = [path.drive(lambda q=q: pipe.answer(q))
               for q in questions[:4]]
    one_log.stop(eng)
    one_cmp = margin_rule(second_log, one_log,
                          "serving_rag answer vs answer_batch",
                          keys=list(one_log.rows))
    # 8 multihop questions, those whose round-1 retrieval finds a bridge
    # first (only they take a bridge-extraction launch)
    hop = [qa.question for qa in corpus.qa if qa.kind == "multihop"]
    rets = rag.query_batch(hop[:256], mode="multihop")
    bridged = [q for q, r in zip(hop, rets) if r.hops == 2]
    check(bridged, "serving_rag: no multihop question finds its bridge")
    hop = (bridged + [q for q in hop if q not in bridged])[:8]
    gb = eng.stats["generate_batches"]
    t = time.perf_counter()
    hop_answers = path.drive(
        lambda: pipe.answer_batch(hop, mode="multihop"))
    hop_s = time.perf_counter() - t
    check(eng.stats["generate_batches"] - gb == 2,
          f"serving_rag: multihop generate_batches "
          f"{eng.stats['generate_batches'] - gb}")
    check(all(a.answer.startswith("tok") for a in
              first + second + singles + hop_answers),
          "serving_rag: an empty answer")
    check(path.counts["mips_topk"] > 0,
          "serving_rag: mips_topk never launched")
    rep = pipe.index_report()
    check(rep["prefix_cache"]["hits"] == eng.stats["prefix_hits"] and
          rep["launches"]["engine"]["generate_batches"] ==
          eng.stats["generate_batches"], "serving_rag: index_report "
                                         "differs from the engine")
    scans = _path_kernel_cases(path, "serving_rag", timed=True)
    emit("serving_rag", questions=len(questions),
         context_tokens=[a.n_context_tokens for a in first[:4]],
         first_pass_s=first_s, second_pass_s=second_s,
         answers_per_s={"first_pass": len(questions) / first_s,
                        "second_pass": len(questions) / second_s,
                        "multihop": len(hop) / hop_s},
         second_pass_vs_first=pass_cmp,
         answer_vs_answer_batch=one_cmp,
         multihop={"questions": len(hop), "generate_batches": 2,
                   "bridged": min(len(bridged), 8), "seconds": hop_s},
         prefix_cache=rep["prefix_cache"],
         launches_engine=rep["launches"]["engine"],
         launches=dict(path.counts), kernel_cases=scans, **_phase_end(t0))
    del eng, pipe
    return dict(path.counts)


def run_serving_summarizer(model, cfg):
    """``EraRAG`` with an ``LMSummarizer`` on llama3-8b, batched and
    serial summaries, no prefix cache: the same graph."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.summarize import LMSummarizer
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving import Engine, EngineConfig

    t0 = _phase_start()
    path = PathLaunches(record=True)
    docs = SyntheticCorpus.generate(n_docs=32, n_topics=8, seed=0).docs
    runs = {}
    for batched in (True, False):
        eng = Engine(cfg, model, EngineConfig(
            max_batch=SERVE_MAX_BATCH, max_seq_len=1024, max_new_tokens=16,
            compute_dtype=torch.bfloat16, prefix_cache_entries=0))
        log = TokenLog(eng)
        rag = EraRAG(replace(ERARAG_DEFAULT, batch_summaries=batched),
                     HashingEmbedder(dim=256),
                     summarizer=LMSummarizer(eng, max_tokens=16),
                     device="cuda")
        t = time.perf_counter()
        path.drive(lambda: rag.insert_docs(docs[:24]))
        path.drive(lambda: rag.insert_docs(docs[24:]))
        runs[batched] = {"rag": rag, "log": log, "engine": eng,
                         "s": time.perf_counter() - t}
    cmp = margin_rule(runs[True]["log"], runs[False]["log"],
                      "serving_summarizer batched vs serial")
    b, s = runs[True], runs[False]
    same_ids = list(b["rag"].graph.nodes) == list(s["rag"].graph.nodes)
    tokens = {k: [(r.tokens_in, r.tokens_out) for r in v["rag"].reports]
              for k, v in runs.items()}
    if cmp["tokens_equal"]:
        check(same_ids and tokens[True] == tokens[False],
              "serving_summarizer: equal summaries, different graphs")
    segments = s["rag"].graph.stats["segments_summarized"]
    check(s["engine"].stats["generate_batches"] == segments,
          f"serving_summarizer: serial generate_batches "
          f"{s['engine'].stats['generate_batches']} for {segments} "
          f"segments")
    check(b["engine"].stats["generate_batches"] <= segments // 2,
          f"serving_summarizer: batched generate_batches "
          f"{b['engine'].stats['generate_batches']} for {segments}")
    check(path.counts["lsh_hash"] > 0,
          "serving_summarizer: lsh_hash never launched")
    scans = _path_kernel_cases(path, "serving_summarizer", timed=True)
    emit("serving_summarizer", corpus="SyntheticCorpus(n_docs=32, "
         "n_topics=8, seed=0): 24 built, 8 grown",
         reduced={"docs": [5000, 32]}, max_tokens=16,
         segments=segments, node_ids_equal=same_ids,
         update_tokens=tokens[True],
         update_tokens_equal=tokens[True] == tokens[False],
         batched_vs_serial=cmp,
         generate_batches={"batched": b["engine"].stats["generate_batches"],
                           "serial": s["engine"].stats["generate_batches"]},
         engine_launches={"batched": b["engine"].launches,
                          "serial": s["engine"].launches},
         seconds_by_run={"batched": b["s"], "serial": s["s"]},
         launches=dict(path.counts), kernel_cases=scans, **_phase_end(t0))
    del runs
    return dict(path.counts)


def run_sharded_deploy():
    """2^22 rows hash-routed into 4 slots of one stacked buffer: the
    per-slot scans plus the merge against ``flagged_mips_topk`` over the
    same rows, with each row's sequence number its flat index."""
    from repro_torch.core.store import _bulk_route, _filter_bias, \
        slot_topk
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.timing import device_ms, kernel_ms, time_ms

    n_slots, k, d = 4, 8, 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    db = torch.zeros(N_DEPLOY, d + 3, device="cuda")
    db[:, :d] = torch.nn.functional.normalize(
        torch.randn(N_DEPLOY, d, device="cuda", generator=gen), dim=1)
    flag = torch.rand(N_DEPLOY, device="cuda", generator=gen)
    db[:, d] = (flag < 0.1).float()                  # dead
    db[:, d + 1] = (flag >= 0.7).float()             # summary
    db[:, d + 2] = (flag < 0.7).float()              # leaf
    # rows 1000..1003 copies of row 999, an alive leaf, and query 0
    # equal to it: exact ties across the slots
    db[999, d:] = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    db[1000:1004] = db[999]
    qd = torch.nn.functional.normalize(
        torch.randn(64, d, device="cuda", generator=gen), dim=1)
    qd[0] = db[999, :d]
    t0 = time.perf_counter()
    owners = torch.from_numpy(_bulk_route(
        [f"row{i}" for i in range(N_DEPLOY)], n_slots)).cuda()
    route_s = time.perf_counter() - t0
    counts = torch.bincount(owners, minlength=n_slots).tolist()
    cap = max(counts)
    stack = torch.zeros(n_slots, cap, d + 3, device="cuda")
    stack[..., d] = 1.0                               # padding: dead
    seq = torch.full((n_slots, cap), mips_ops.SEQ_PAD, dtype=torch.int32,
                     device="cuda")
    for s in range(n_slots):
        rows = torch.nonzero(owners == s).flatten()   # ascending
        stack[s, :len(rows)] = db[rows]
        seq[s, :len(rows)] = rows.int()
    del owners
    bias = _filter_bias(None)
    q_aug = mips_ops.augment_queries(qd, bias).contiguous()

    def sharded():
        parts = [slot_topk(q_aug, stack[s], seq[s], k)
                 for s in range(n_slots)]
        return mips_ops.merge_sharded_topk(
            torch.stack([v for v, _ in parts]),
            torch.stack([i for _, i in parts]), k)

    def flat():
        return mips_ops.flagged_mips_topk(qd, db, k, bias)

    sv, ss = sharded()
    fv, fi = flat()
    torch.cuda.synchronize()
    check(torch.equal(sv, fv) and torch.equal(ss, fi),
          "sharded 2^22: the 4-slot loop + merge differs from the flat "
          "scan")
    check(ss[0, :5].tolist() == list(range(999, 1004)),
          "sharded 2^22: the planted duplicates out of order")
    sharded_ms = time_ms(sharded)
    flat_ms = time_ms(flat)
    launches = {}
    sharded_kernels = kernel_ms(sharded, launches=launches)
    sharded_all_device_ms = device_ms(sharded)
    flat_kernels = kernel_ms(flat)
    parts = [slot_topk(q_aug, stack[s], seq[s], k) for s in range(n_slots)]
    merge_in = (torch.stack([v for v, _ in parts]),
                torch.stack([i for _, i in parts]))
    merge_ms = time_ms(lambda: mips_ops.merge_sharded_topk(*merge_in, k))
    merge_dev = device_ms(lambda: mips_ops.merge_sharded_topk(*merge_in, k))
    # where the slots' extra device time goes: the same four scans over
    # the flat buffer's aligned quarters (smaller scans, no slot view)
    quarter = N_DEPLOY // n_slots
    quarters = [db[i * quarter:(i + 1) * quarter] for i in range(n_slots)]
    quarter_kernels = kernel_ms(
        lambda: [mips_ops.mips_topk(q_aug, part, k) for part in quarters])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"shape": {"b": 64, "n": N_DEPLOY, "d": d + 3, "k": k,
                     "slots": n_slots, "slot_rows": counts,
                     "capacity": cap},
           "stack_bytes": stack.numel() * 4, "route_s": route_s,
           "bitwise_equal_flat": True, "sharded_ms": sharded_ms,
           "flat_ms": flat_ms, "sharded_over_flat": sharded_ms / flat_ms,
           "sharded_kernel_device_ms": sharded_kernels,
           "sharded_device_ms": sum(sharded_kernels.values()),
           "sharded_all_device_ms": sharded_all_device_ms,
           "flat_kernel_device_ms": flat_kernels,
           "flat_device_ms": sum(flat_kernels.values()),
           "sharded_launches_per_call": launches,
           "merge_ms": merge_ms, "merge_device_ms": merge_dev,
           "quarters_kernel_device_ms": quarter_kernels,
           "scan_grid": {"slot": mips_ops.mips_scan_grid(64, cap, sms),
                         "quarter": mips_ops.mips_scan_grid(64, quarter,
                                                            sms),
                         "flat": mips_ops.mips_scan_grid(64, N_DEPLOY,
                                                         sms)}}
    del db, stack, seq
    torch.cuda.empty_cache()
    emit("sharded_2_22", **out)
    return out


# ---------------------------------------------------------------------------
# phases 6k-6l: the index lifecycle and the live-serving day
# ---------------------------------------------------------------------------

# the main path's corpus cut from 5000 to 2000 documents: at 5000 the
# schedule's growth phase queues more documents than the ingest queue's
# default bound (1024 pending) at any burst count (``_peak_pending_docs``)
LIVE_DOCS = 2000
LIVE_BURSTS = (2, 4, 8)     # burst counts walked at 5000 documents
LIVE_SHARDS = 4             # the day's store (its migration goes to 8)
LIVE_QUERY_BATCH = 64
LIFECYCLE_SHARDS = 8        # the quantized store's migration: 4 -> 8
LIFECYCLE_STOP = 2          # target shards built before the snapshot


def _scratch_dir(prefix):
    """A temporary directory under the checkout's git-ignored build/."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(prefix=prefix, dir=ROOT / "build")


class ManagerTimes:
    """While active, the seconds of every ``LifecycleManager.snapshot``
    (to its write on disk) and ``restore`` call, and the bytes each
    snapshot wrote."""

    def __init__(self):
        from repro_torch.lifecycle.manager import LifecycleManager
        self.cls = LifecycleManager
        self._orig = (LifecycleManager.snapshot, LifecycleManager.restore)
        self.snapshots, self.restores = [], []

    def __enter__(self):
        snap, rest = self._orig

        def snapshot(mgr, block=False):
            t0 = time.perf_counter()
            step = snap(mgr, block=block)
            mgr.wait()
            dt = time.perf_counter() - t0
            files = (mgr.ckpt.path / f"step-{step:08d}").iterdir()
            self.snapshots.append({"seconds": dt, "bytes": sum(
                f.stat().st_size for f in files)})
            return step

        def restore(mgr, graph, **kw):
            t0 = time.perf_counter()
            out = rest(mgr, graph, **kw)
            torch.cuda.synchronize()
            self.restores.append({"seconds": time.perf_counter() - t0})
            return out

        self.cls.snapshot, self.cls.restore = snapshot, restore
        return self

    def __exit__(self, *exc):
        self.cls.snapshot, self.cls.restore = self._orig


def _peak_pending_docs(sched, cfg):
    """The most documents the live day's ``IngestService`` holds queued,
    walked without running it: the harness ticks the service once after
    each event and drains it at a snapshot, a restore and the migration.
    A burst joins the insert op at the queue's tail; a tick on the head
    op chunks ``ingest_docs_per_tick`` documents, else embeds
    ``ingest_embed_batch`` chunks, else commits it; a removal takes one
    tick."""
    from repro_torch.data.chunker import chunk_text
    from repro_torch.data.tokenizer import HashTokenizer

    tok = HashTokenizer()
    # an insert op: [chunks of each document, documents chunked, chunks
    # found, chunks embedded]; a removal: None
    ops, peak = [], 0
    for ev in (ev for ph in sched.phases for ev in ph.events):
        if ev[0] == "insert":
            sizes = [len(chunk_text(d, t, tok, cfg.chunk_tokens))
                     for d, t in ev[1]]
            if ops and ops[-1] is not None:
                ops[-1][0] += sizes
            else:
                ops.append([sizes, 0, 0, 0])
        elif ev[0] == "remove":
            ops.append(None)
        elif ev[0] in ("snapshot", "restore", "migrate"):
            ops.clear()
        peak = max(peak, sum(len(op[0]) for op in ops if op))
        op = ops[0] if ops else None
        if op is None:
            ops[:1] = []
        elif op[1] < len(op[0]):
            take = op[0][op[1]:op[1] + cfg.ingest_docs_per_tick]
            op[1] += len(take)
            op[2] += sum(take)
        elif op[3] < op[2]:
            op[3] += min(cfg.ingest_embed_batch, op[2] - op[3])
        else:
            ops.pop(0)
    return peak


def _search_bits(store, q, k, seqs=True):
    return [_bits_key(h, seqs) for filt in (None, "leaf", "summary")
            for h in store.search_batch(q, k, filt)]


def run_lifecycle(corpus, rag_q, questions):
    """The quantized main-path index that ``sharded_path`` resharded to
    4: a policy-triggered migration 4 -> 8 stopped by a
    ``LifecycleManager`` snapshot after 2 of its 8 target shards,
    restored twice (resumed from the staged shards, and replayed), each
    finished by ``refresh()`` turns; then a tombstone-triggered
    same-width replay.  Every hit, score bits included, equal to the
    unbroken migration's and a fresh 8-shard build's."""
    from repro_torch.core.store import ShardedVectorStore
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.lifecycle import LifecycleManager, LifecyclePolicy

    t0 = _phase_start()
    store = rag_q.store
    check(isinstance(store, ShardedVectorStore) and store.n_shards == 4
          and store.quantized, "lifecycle: not the 4-shard quantized store")
    cfg, k = rag_q.cfg, rag_q.cfg.top_k
    q = np.asarray(rag_q.embedder.encode(questions), np.float32)
    # the scan settings, passed explicitly: a snapshot holds no "quant"
    # entry, so a restore is exact unless asked (as in the JAX package)
    scan_kw = dict(quantized=True, coarse_mult=cfg.coarse_mult,
                   scan_bits=cfg.scan_bits, scan_seed=cfg.seed)
    policy = LifecyclePolicy.from_config(replace(
        cfg, reshard_skew_threshold=1e-6, reshard_min_rows=1,
        reshard_max_shards=LIFECYCLE_SHARDS))
    path = PathLaunches(record=True)
    old = _search_bits(store, q, k)
    old_epoch = store.epoch
    with _scratch_dir("lifecycle_") as snap_dir, ManagerTimes() as times:
        mgr = LifecycleManager(store, snap_dir, policy=policy)
        path.drive(store.refresh)              # the policy stages 4 -> 8
        mig = store.migration
        check(mig is not None and mig.plan.n_to == LIFECYCLE_SHARDS,
              f"lifecycle: the policy staged {mig and mig.describe()}")
        while len(store.migration.built) < LIFECYCLE_STOP:
            path.drive(store.refresh)
        check(_search_bits(store, q, k) == old and
              store.epoch == old_epoch,
              "lifecycle: mid-migration hits left the old epoch")
        mgr.snapshot(block=True)
        restored = {}
        for resume in (True, False):
            st = path.drive(lambda: mgr.restore(
                rag_q.graph, device="cuda", resume=resume, **scan_kw))
            check(st.quantized and st.migration is not None and
                  len(st.migration.built) ==
                  (LIFECYCLE_STOP if resume else 0),
                  f"lifecycle: restore(resume={resume}) staged "
                  f"{st.migration and st.migration.describe()}")
            restored["resumed" if resume else "replayed"] = st
    stores = {"unbroken": store, **restored}
    turns, hits = {}, {}
    for name, st in stores.items():
        turns[name] = 0
        while st.migration is not None:
            path.drive(st.refresh)
            turns[name] += 1
        check(st.epoch == old_epoch + 1 and
              st.n_shards == LIFECYCLE_SHARDS,
              f"lifecycle: {name} ended at epoch {st.epoch}, "
              f"{st.n_shards} shards")
        hits[name] = path.drive(lambda: _search_bits(st, q, k))
    left = LIFECYCLE_SHARDS - LIFECYCLE_STOP
    check(turns == {"unbroken": left, "resumed": left,
                    "replayed": LIFECYCLE_SHARDS},
          f"lifecycle: refresh turns {turns}")
    fresh = ShardedVectorStore(rag_q.graph, n_shards=LIFECYCLE_SHARDS,
                               device="cuda", **scan_kw)
    fresh.rebuild()
    for name in ("resumed", "replayed"):
        check(hits[name] == hits["unbroken"],
              f"lifecycle: {name} hits differ from the unbroken "
              f"migration's")
    check(_search_bits(store, q, k, seqs=False) ==
          _search_bits(fresh, q, k, seqs=False),
          "lifecycle: the migration's hits differ from a fresh 8-shard "
          "build's")
    del restored, stores
    # the tombstone trigger: the last growth round's documents removed
    # with per-shard compaction off, then replayed at the same width
    store.attach_lifecycle(LifecyclePolicy.from_config(replace(
        cfg, reshard_tombstone_threshold=1e-6, reshard_min_rows=1)))
    store._compact_threshold = 1.0
    _, rounds = corpus.growth_rounds(0.5, 5)
    path.drive(lambda: rag_q.remove_docs([doc for doc, _ in rounds[-1]]))
    epoch = store.epoch
    path.drive(store.refresh)      # the tombstones, then the trigger
    dead = sum(sh.n_dead for sh in store._shards)
    tomb_turns = 0
    check(store.migration is not None and
          store.migration.plan.n_to == LIFECYCLE_SHARDS,
          f"lifecycle: the tombstone trigger staged "
          f"{store.migration and store.migration.describe()}")
    while store.epoch == epoch:
        path.drive(store.refresh)
        tomb_turns += 1
    store.attach_lifecycle(None)
    check(sum(sh.n_dead for sh in store._shards) == 0 and
          store.n_shards == LIFECYCLE_SHARDS,
          "lifecycle: the tombstone replay left dead rows")
    fresh = ShardedVectorStore(rag_q.graph, n_shards=LIFECYCLE_SHARDS,
                               device="cuda", **scan_kw)
    fresh.rebuild()
    check(path.drive(lambda: _search_bits(store, q, k, seqs=False)) ==
          _search_bits(fresh, q, k, seqs=False),
          "lifecycle: the tombstone replay's hits differ from a fresh "
          "build's")
    del fresh
    launches = dict(path.counts)
    for name in ("lsh_hash", "hamming_topk", "mips_rescore"):
        check(launches[name] > 0,
              f"{name} never launched on the lifecycle path")
    check(ham_ops.route_launch_counts()["count"] == 0,
          "lifecycle: hamming_topk left the list route")
    cases = _path_kernel_cases(path, "lifecycle")
    emit("lifecycle", rows=store.size, shards=[4, LIFECYCLE_SHARDS],
         plan=mig.plan.to_dict(), stopped_after=LIFECYCLE_STOP,
         refresh_turns=turns, epochs=[old_epoch, old_epoch + 1],
         snapshots=times.snapshots, restores=times.restores,
         hits_bitwise_unbroken=True, hits_bitwise_fresh_build=True,
         tombstone_replay={"dead_rows": dead, "turns": tomb_turns,
                           "epoch": store.epoch},
         store_stats={key: getattr(store.stats, key) for key in (
             "reshards", "reshard_steps", "rows_tombstoned",
             "compactions")},
         launches=launches, kernel_cases=cases, **_phase_end(t0))
    return launches


def run_live_day(corpus):
    """``LiveHarness`` on the paper's defaults at 4 shards with the query
    cache, over the main path's corpus: the seeded schedule's ingest
    bursts, removals, Zipf query batches, a snapshot and restore
    mid-stream and one policy-triggered migration to 8 shards, gated
    inside ``run()`` (old-epoch availability, completion, bitwise parity
    with the synchronous replay of ``committed_ops``)."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving.live_harness import LiveHarness, \
        make_schedule

    t0 = _phase_start()
    cfg = replace(ERARAG_DEFAULT, index_shards=LIVE_SHARDS,
                  query_cache=True)
    # why the corpus is cut: at the main path's 5000 documents the queue
    # would overflow its bound whatever the number of growth bursts
    peak_at_main = {bursts: _peak_pending_docs(make_schedule(
        corpus, seed=0, query_batch=LIVE_QUERY_BATCH, queries_per_phase=4,
        bursts=bursts), cfg) for bursts in LIVE_BURSTS}
    check(min(peak_at_main.values()) > cfg.ingest_max_pending_docs,
          f"live_day: {len(corpus.docs)} documents queue at most "
          f"{peak_at_main} under the bound; no cut is needed")
    corpus = SyntheticCorpus.generate(n_docs=LIVE_DOCS, n_topics=64,
                                      seed=0)
    sched = make_schedule(corpus, seed=0, query_batch=LIVE_QUERY_BATCH,
                          queries_per_phase=4)
    peak = _peak_pending_docs(sched, cfg)
    check(peak <= cfg.ingest_max_pending_docs,
          f"live_day: {peak} documents queued over the bound")
    path = PathLaunches(record=True)
    with _scratch_dir("live_day_") as snap_dir, ManagerTimes() as times:
        harness = LiveHarness(cfg, lambda: HashingEmbedder(dim=256), sched,
                              snap_dir, compact_threshold=0.15,
                              device="cuda")
        report = path.drive(harness.run)
    mig = report["migration"]
    counters = report["store_counters"]
    check(report["parity"]["bitwise"] and mig["availability"] == 1.0 and
          mig["completed"] and mig["post_matches_ref"],
          f"live_day: gates {report['parity']}, {mig}")
    check((mig["old_shards"], mig["new_shards"]) ==
          (LIVE_SHARDS, 2 * LIVE_SHARDS) and
          mig["new_epoch"] == mig["old_epoch"] + 1,
          f"live_day: migration {mig}")
    check(counters["compactions"] >= 1 and
          counters["reshard_steps"] == 2 * LIVE_SHARDS,
          f"live_day: store counters {counters}")
    check(len(times.snapshots) == 1 and len(times.restores) == 1,
          f"live_day: {times.snapshots}, {times.restores}")
    check(report["service"]["max_queue_depth"] == peak,
          f"live_day: the queue held {report['service']['max_queue_depth']}"
          f" documents at most, the walk says {peak}")
    launches = dict(path.counts)
    for name in ("lsh_hash", "mips_topk", "merge_sharded_topk"):
        check(launches[name] > 0,
              f"{name} never launched on the live day")
    check(launches["hamming_topk"] == launches["mips_rescore"] == 0,
          "live_day: the exact store ran the quantized scan")
    cases = _path_kernel_cases(path, "live_day")
    emit("live_day", reduced={
        "reader": "extractive (the LM reader runs in serving_rag; at "
                  "1.2-1.5 answers/s it would stretch the day to tens "
                  "of minutes)",
        "n_docs": [5000, LIVE_DOCS],
        "why_n_docs": "at 5000 the growth phase queues more documents "
                      "than the ingest queue's bound at any burst count",
        "peak_pending_docs_at_5000_by_bursts": peak_at_main,
        "peak_pending_docs": peak,
        "max_pending_docs": cfg.ingest_max_pending_docs},
         docs=len(corpus.docs), base_docs=len(sched.base_docs),
         query_batch=LIVE_QUERY_BATCH, compact_threshold=0.15,
         phases=[{key: ph.get(key) for key in (
             "name", "events", "query_batches", "answers", "p50_ms",
             "p99_ms", "obs")} for ph in report["phases"]],
         migration=mig, parity=report["parity"], store_counters=counters,
         service=report["service"], final_epoch=report["final_epoch"],
         final_shards=report["final_shards"],
         index_size=report["index_size"], snapshot=times.snapshots[0],
         restore=times.restores[0], launches=launches,
         kernel_cases=cases, **_phase_end(t0))
    return launches


# ---------------------------------------------------------------------------
# phase 7: flash attention, forward and backward
# ---------------------------------------------------------------------------

def _attn_inputs(b, hq, hkv, lq, lk, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for shape in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d),
                          (b, hq, lq, d))]


def _rel_fro(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) /
                 torch.linalg.norm(want).clamp_min(1e-30))


def attention_case(b, hq, hkv, lq, lk, d, causal, dtype, seed,
                   timed=False):
    """The kernels against the plain version on one shape; with
    ``timed``, CUDA-event medians of kernels, plain and SDPA too."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        attention_grads_ref, attention_lse_ref, attention_ref
    from repro_torch.kernels.timing import kernel_ms, time_ms

    q, k, v, do = _attn_inputs(b, hq, hkv, lq, lk, d, dtype, seed)
    tname = str(dtype).split(".")[1]
    tol = FA_TOL[tname]
    label = f"{(b, hq, hkv, lq, lk, d)} {tname} causal={causal}"
    o, lse = ops.flash_attention_fwd_cuda(q, k, v, causal)
    want = attention_ref(q, k, v, causal=causal).float()
    out_diff = (o.float() - want).abs()
    out_err = float(out_diff.max())
    # beyond the rounding step: the fp32 sums' own difference
    out_excess = max(0.0, float(
        (out_diff - tol["out_rel"] * want.abs()).max()))
    out_ok = out_excess <= tol["out_abs"]
    del out_diff
    lse_err = float((lse - attention_lse_ref(q, k, causal=causal))
                    .abs().max())
    del want
    grads = ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = ops.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(grads, again)),
          f"flash_attention {label}: two backward runs differ")
    del again
    plain = attention_grads_ref(q, k, v, do, causal=causal)
    grad_rel = {n: _rel_fro(g, p) for n, g, p in zip(("dq", "dk", "dv"),
                                                     grads, plain)}
    grad_abs = max(float((g.float() - p.float()).abs().max())
                   for g, p in zip(grads, plain))
    del plain, grads
    check(out_ok, f"flash_attention {label}: output error {out_err}, "
          f"{out_excess} beyond out_rel * |out|, tolerance {tol}")
    check(lse_err <= tol["lse"], f"flash_attention {label}: lse error "
          f"{lse_err} > {tol['lse']}")
    for n, e in grad_rel.items():
        check(e <= tol["grad_rel"], f"flash_attention {label}: {n} "
              f"relative error {e} > {tol['grad_rel']}")
    case = {"shape": {"b": b, "hq": hq, "hkv": hkv, "lq": lq, "lk": lk,
                      "d": d, "dtype": tname, "causal": causal},
            "out_max_abs_err": out_err,
            "out_max_err_beyond_rel_step": out_excess,
            "lse_max_abs_err": lse_err,
            "grad_max_abs_err": grad_abs, "grad_rel_fro_err": grad_rel,
            "tolerance": tol, "backward_bitwise_repeatable": True}
    if not timed:
        return case
    # the least work: visible (query, key) pairs; forward 2 products of
    # 2 FLOP per pair and feature, backward 5 (S again, dP, dV, dK, dQ)
    pairs = sum(min(lk, i + 1 + lk - lq) for i in range(lq)) if causal \
        else lq * lk
    flop = 2.0 * b * hq * pairs * d
    es = q.element_size()
    qo_bytes = es * b * hq * lq * d
    kv_bytes = es * b * hkv * lk * d
    lse_bytes = 4.0 * b * hq * lq
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    fwd_bound = bound(2 * qo_bytes + 2 * kv_bytes + lse_bytes, 2 * flop,
                      peak)
    bwd_bound = bound(5 * qo_bytes + 4 * kv_bytes + lse_bytes, 5 * flop,
                      peak)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
    fwd_ms = time_ms(lambda: ops.flash_attention_fwd_cuda(q, k, v, causal))
    bwd_ms = time_ms(lambda: ops.flash_attention_bwd_cuda(q, k, v, o, lse,
                                                          do, causal))
    # products the kernels issue: the bf16 route splits P (forward) and
    # P and dS (backward) into two bf16 halves, and its backward computes
    # S and dP in both the dK/dV and the dQ kernel
    issued = (3, 10) if dtype == torch.bfloat16 else (2, 7)
    case["timing"] = {
        "kernel_route": ops.ROUTES[dtype],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_tflop_per_s": 2 * flop / fwd_ms / 1e9,
        "bwd_tflop_per_s": 5 * flop / bwd_ms / 1e9,
        "fwd_issued_tflop_per_s": issued[0] * flop / fwd_ms / 1e9,
        "bwd_issued_tflop_per_s": issued[1] * flop / bwd_ms / 1e9,
        "fwd_bound_share": fwd_bound[0] / fwd_ms,
        "bwd_bound_share": bwd_bound[0] / bwd_ms,
        # which kernels ran, and the backward's split between them
        "fwd_kernel_ms": kernel_ms(lambda: ops.flash_attention_fwd_cuda(
            q, k, v, causal)),
        "bwd_kernel_ms": kernel_ms(lambda: ops.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal)),
        "fwd_plain_ms": time_ms(lambda: attention_ref(q, k, v,
                                                      causal=causal),
                                reps=5),
        "bwd_plain_ms": time_ms(lambda: attention_grads_ref(
            q, k, v, do, causal=causal), reps=5),
        "fwd_library_ms": time_ms(lambda: sdpa(
            q, k, v, is_causal=causal, enable_gqa=True)),
        "bwd_library_ms": time_ms(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), do, retain_graph=True)),
        "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
        "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
        "visible_pairs_per_head": pairs, "fwd_flop": 2 * flop,
        "bwd_flop": 5 * flop}
    del lib_out
    torch.cuda.empty_cache()
    return case


SMALL_ATTENTION_SHAPES = (              # b, hq, hkv, lq, lk, d, causal
    (1, 4, 4, 37, 37, 16, True),           # group 1, odd l
    (2, 8, 2, 65, 130, 32, True),          # lq < lk, causal
    (2, 8, 1, 100, 77, 64, False),         # group 8, lq > lk
    (1, 4, 1, 129, 129, 128, True),        # group 4
    (1, 8, 8, 63, 200, 128, False))        # not causal
SMALL_BF16_ONLY = (
    (1, 1, 1, 1, 1, 16, True),             # a single row
    (1, 8, 1, 1, 33, 128, True),           # a single row, group 8
    (1, 4, 2, 200, 200, 64, True),         # d 64 over several tiles
    (2, 4, 4, 77, 77, 32, False))          # d 32, odd, not causal


def run_flash_attention():
    """bf16 (the tensor-core kernels) and fp32 (the FMA kernels), each at
    the training shape, timed, and at small shapes."""
    ts = TRAIN_SHAPE
    main = {dtype: attention_case(ts["b"], ts["hq"], ts["hkv"], ts["l"],
                                  ts["l"], ts["d"], True, dtype, seed=11,
                                  timed=True)
            for dtype in (torch.bfloat16, torch.float32)}
    small = {dtype: [attention_case(*shape, dtype, seed=20 + i)
                     for i, shape in enumerate(shapes)]
             for dtype, shapes in (
                 (torch.float32, SMALL_ATTENTION_SHAPES),
                 (torch.bfloat16, SMALL_ATTENTION_SHAPES + SMALL_BF16_ONLY))}
    emit("flash_attention", training_shape=main[torch.bfloat16],
         training_shape_fp32=main[torch.float32],
         small_fp32=small[torch.float32], small_bf16=small[torch.bfloat16])
    return main


# ---------------------------------------------------------------------------
# phase 8: the LM training step at full width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4            # depth cut of llama3-8b's 32 layers
TRAIN_STEPS = 5


def _matmul_params(cfg) -> int:
    """Parameters that enter a product per token: all but the embedding
    table (a gather) and the norms."""
    d = cfg.d_model
    return cfg.param_count() - cfg.vocab_size * d - \
        cfg.n_layers * 2 * d - d


def run_train_path():
    from dataclasses import replace

    from repro_torch.configs.llama3_8b import llama3_8b
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.kernels.timing import time_ms

    cfg = replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    b, l = TRAIN_SHAPE["b"], cfg.shape("train_4k").seq_len
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "train_path: parameter count")
    batch = synthetic_lm_batches(cfg.vocab_size, b, l, seed=0)(0)
    loop = LoopConfig(max_steps=TRAIN_STEPS, n_microbatches=2, log_every=0)

    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launch_count()
    fa_ref.reset_call_count()
    res = run_training(lambda m, bt: loss_fn(m, bt, cfg), model,
                       lambda step: batch, loop)
    launches = {"flash_attention_fwd": fa_ops.launch_count(),
                "flash_attention_bwd": fa_ops.bwd_launch_count(),
                "attention_ref": fa_ref.call_count()}
    routes = fa_ops.route_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    # attention's share of a step: the kernels at the microbatch's shape
    # (b = 1), times their launches per step
    q, k, v, do = _attn_inputs(b // loop.n_microbatches, cfg.n_heads,
                               cfg.n_kv_heads, l, l, cfg.d_head,
                               torch.bfloat16, seed=12)
    o, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, True)
    mb_fwd_ms = time_ms(lambda: fa_ops.flash_attention_fwd_cuda(q, k, v,
                                                                True))
    mb_bwd_ms = time_ms(lambda: fa_ops.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, True))
    del q, k, v, do, o, lse

    check(all(np.isfinite(res.losses)), f"train_path: losses {res.losses}")
    check(res.losses[-1] < res.losses[0],
          f"train_path: loss did not fall: {res.losses}")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] > 0, f"{name} never launched on the training "
                                  f"path")
    check(launches["attention_ref"] == 0,
          "train_path: the plain attention ran on the card")
    for pass_ in ("fwd", "bwd"):
        check(routes[pass_]["tensor_core_bf16"] ==
              launches[f"flash_attention_{pass_}"] and
              routes[pass_]["fma_fp32"] == 0,
              f"train_path: {pass_} launches by route {routes[pass_]}: the "
              f"bf16 step must run the tensor-core kernels only")
    tokens = b * l
    step_s = statistics.median(res.step_s[1:])
    pairs = l * (l + 1) // 2
    model_flop = 3.0 * (2.0 * _matmul_params(cfg) * tokens +
                        4.0 * b * cfg.n_heads * cfg.d_head * pairs *
                        cfg.n_layers)
    attn_s = (launches["flash_attention_fwd"] * mb_fwd_ms +
              launches["flash_attention_bwd"] * mb_bwd_ms) / TRAIN_STEPS / 1e3
    emit("train_path", model="llama3-8b", reduced={"n_layers": [32, 4]},
         params=n_params, d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
         vocab_size=cfg.vocab_size, batch=b, seq_len=l,
         n_microbatches=loop.n_microbatches, optimizer="adamw",
         base_lr=loop.base_lr, compute_dtype="bfloat16",
         steps=TRAIN_STEPS, init_s=init_s, losses=res.losses,
         step_s=res.step_s, median_step_s_after_first=step_s,
         tokens_per_s=tokens / step_s, model_flop_per_step=model_flop,
         model_flop_per_s=model_flop / step_s,
         max_memory_allocated_bytes=peak, launches=launches,
         launches_by_route=routes,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         microbatch_attention_ms={"fwd": mb_fwd_ms, "bwd": mb_bwd_ms},
         attention_s_per_step=attn_s,
         attention_share_of_step=attn_s / step_s,
         straggler_steps=res.straggler_steps)
    return launches


def run_train_reference():
    """llama3-8b at ``reduced()``: the same seeded weights trained 3 steps
    on the card and on the CPU, fp32 compute."""
    from repro_torch.configs.llama3_8b import llama3_8b
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.optimizer import cosine_schedule, \
        make_train_step, opt_init

    cfg = llama3_8b().reduced()
    tree = params_to_numpy(init_params(cfg, torch.Generator()
                                       .manual_seed(0)))
    make = synthetic_lm_batches(cfg.vocab_size, 4, 64, seed=1)
    step = make_train_step(
        lambda m, bt: loss_fn(m, bt, cfg, compute_dtype=torch.float32),
        lr_schedule=cosine_schedule(1e-2, 1, 3), n_microbatches=2)
    fa_ops.reset_launch_count()
    out = {}
    for dev in ("cuda", "cpu"):
        model = params_from_numpy(tree, cfg, device=dev)
        opt = opt_init(model)
        losses = []
        for i in range(3):
            model, opt, m = step(model, opt, make(i))
            losses.append(float(m["loss"]))
        out[dev] = losses, params_to_numpy(model)
    card_launches = fa_ops.launch_count()
    check(card_launches > 0, "train_reference: the card ran no kernel")
    routes = fa_ops.route_launch_counts()
    check(all(routes[p]["fma_fp32"] > 0 and routes[p]["tensor_core_bf16"]
              == 0 for p in routes),
          f"train_reference: fp32 launches by route {routes}: the fp32 "
          f"steps must run the FMA kernels only")
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    check(loss_err <= TRAIN_LOSS_RTOL,
          f"train_reference: losses {lg} vs {lc}")

    def leaves(t):
        layer = t["layers"][0]
        yield "embed", t["embed"]
        yield "lm_head", t["lm_head"]
        yield "final_norm", t["final_norm"]
        for sub in ("attn", "ffn"):
            for n, a in layer[sub].items():
                yield n, a
        yield "ln1", layer["ln1"]
        yield "ln2", layer["ln2"]

    start = dict(leaves(tree))
    worst = 0.0
    for (n, a), (_, c) in zip(leaves(pg), leaves(pc)):
        moved = c.astype(np.float64) - start[n]
        check(np.linalg.norm(moved) > 0, f"train_reference: {n} not moved")
        err = float(np.linalg.norm(a - c) / np.linalg.norm(moved))
        worst = max(worst, err)
        check(err <= TRAIN_UPDATE_RTOL,
              f"train_reference: {n} update error {err}")
    emit("train_reference", model="llama3-8b reduced", steps=3,
         compute_dtype="float32", n_microbatches=2, card_losses=lg,
         cpu_losses=lc, max_loss_rel_err=loss_err,
         loss_tolerance=TRAIN_LOSS_RTOL, max_update_rel_err=worst,
         update_tolerance=TRAIN_UPDATE_RTOL,
         card_flash_attention_fwd_launches=card_launches,
         card_launches_by_route=routes)
    return {f"flash_attention_{p}": routes[p]["fma_fp32"] for p in routes}


RESUME_STEPS, RESUME_STOP = 6, 3     # the run, and where it is stopped


def run_train_resume():
    """llama3-8b at ``reduced()`` in bf16 through ``run_training``: 6
    steps unbroken against 3 steps with ``ckpt_dir`` and a resume to 6
    in a fresh model; losses, every weight and both AdamW moments (the
    runs' final checkpoints) equal bitwise, the resume on the bf16
    attention kernels."""
    import copy

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.llama3_8b import llama3_8b
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.loop import LoopConfig, run_training

    t0 = _phase_start()
    cfg = llama3_8b().reduced()
    b, l, n_mb = 4, 64, 2
    make = synthetic_lm_batches(cfg.vocab_size, b, l, seed=2)
    init = init_params(cfg, torch.Generator().manual_seed(0))

    def train(ckpt_dir, max_steps, every=100, resume=False):
        loop = LoopConfig(max_steps=max_steps, ckpt_every=every,
                          ckpt_dir=ckpt_dir, base_lr=1e-2,
                          n_microbatches=n_mb, log_every=0)
        return run_training(lambda m, bt: loss_fn(m, bt, cfg),
                            copy.deepcopy(init).to("cuda"), make, loop,
                            resume=resume)

    with _scratch_dir("train_resume_") as d:
        full = train(f"{d}/full", RESUME_STEPS)
        first = train(f"{d}/cut", RESUME_STOP, every=RESUME_STOP)
        path = PathLaunches()        # every kernel's count set to 0
        fa_ref.reset_call_count()
        t_resume = time.perf_counter()
        resumed = path.drive(lambda: train(f"{d}/cut", RESUME_STEPS,
                                           resume=True))
        resume_s = time.perf_counter() - t_resume
        launches = dict(path.counts, attention_ref=fa_ref.call_count())
        totals = {"fwd": fa_ops.launch_count(),
                  "bwd": fa_ops.bwd_launch_count()}
        _, want, want_extra = load_checkpoint(f"{d}/full")
        _, got, got_extra = load_checkpoint(f"{d}/cut")
    check(resumed.final_step == RESUME_STEPS and
          len(resumed.losses) == RESUME_STEPS - RESUME_STOP,
          f"train_resume: resumed to {resumed.final_step}")
    check(first.losses + resumed.losses == full.losses,
          f"train_resume: losses {first.losses} + {resumed.losses} "
          f"against {full.losses}")
    check(want_extra == got_extra == {"step": RESUME_STEPS} and
          list(got) == list(want),
          f"train_resume: checkpoints {got_extra}, {want_extra}")
    differ = [key for key in want if not np.array_equal(got[key],
                                                        want[key])]
    check(not differ, f"train_resume: {differ[:5]} differ")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] > 0,
              f"{name} never launched on the resumed run")
    check(launches["attention_ref"] == 0,
          "train_resume: the plain attention ran on the card")
    for pass_ in ("fwd", "bwd"):
        check(launches[f"flash_attention_{pass_}"] == totals[pass_] and
              launches[f"flash_attention_{pass_}_fp32"] == 0,
              f"train_resume: {pass_} launches by route {launches}, "
              f"{totals[pass_]} in all")
    # the resumed run's attention shape against the plain version
    case = attention_case(b // n_mb, cfg.n_heads, cfg.n_kv_heads, l, l,
                          cfg.d_head, True, torch.bfloat16, seed=31)
    n_moments = sum(1 for key in want if key.startswith("['opt']/.mu"))
    emit("train_resume", model="llama3-8b reduced", compute_dtype="bfloat16",
         batch=b, seq_len=l, n_microbatches=n_mb, steps=RESUME_STEPS,
         stopped_at=RESUME_STOP, losses=full.losses,
         resumed_losses=resumed.losses, resume_s=resume_s,
         checkpoint_arrays=len(want), moments_per_kind=n_moments,
         bitwise_equal=True, launches=launches, attention_case=case, **_phase_end(t0))
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels.common import build_kernels
    from repro_torch.kernels.timing import card

    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = build_kernels(["lsh_hash", "mips_topk", "hamming_topk",
                            "flash_attention"], force=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=builds,
         build_wall_s=time.perf_counter() - t0)

    corpus, rag, questions, n_init, launches = run_main_path()
    run_reference_check()
    lsh_main, lsh_deploy, lsh_wide, lsh_growth = run_lsh(rag, n_init)
    mips_main, mips_deploy, mips_b1 = run_mips(rag, questions)
    rag_q, q_launches = run_quantized_path(corpus, rag, questions)
    run_reference_check(quantized_scan=True)
    lsh_quant, ham_main, res_main, quant_c32, quant_deploy = run_hamming(
        rag_q, questions)
    sh_launches, sh_q_launches = run_sharded_path(corpus, rag, rag_q,
                                                  questions)
    life_launches = run_lifecycle(corpus, rag_q, questions)
    del rag_q
    base_path = PathLaunches()
    b1_scan = run_baselines(corpus, base_path)
    base_launches = dict(base_path.counts)
    for name in ("lsh_hash", "mips_topk"):
        check(base_launches[name] > 0,
              f"{name} never launched on the baselines path")
    qc_launches = run_query_cache(corpus, rag, questions, PathLaunches())
    check(qc_launches["mips_topk"] > 0,
          "mips_topk never launched on the query cache path")
    pipe, ingest_launches, per_embed_tick = run_ingest(rag, questions,
                                                       PathLaunches())
    run_index_report(pipe)
    del pipe
    live_launches = run_live_day(corpus)
    torch.cuda.empty_cache()
    run_serving_reference()
    model, lm_cfg = run_serving_engine(corpus)
    rag_launches = run_serving_rag(rag, corpus, model, lm_cfg)
    sum_launches = run_serving_summarizer(model, lm_cfg)
    serving_launches = {k: rag_launches[k] + sum_launches[k]
                        for k in rag_launches}
    del rag, model
    torch.cuda.empty_cache()
    sh_deploy = run_sharded_deploy()
    run_reference_check(index_shards=4)
    run_reference_check(quantized_scan=True, index_shards=4)
    fa_main = run_flash_attention()
    train_launches = run_train_path()
    fp32_launches = run_train_reference()
    resume_launches = run_train_resume()

    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")

    mips_keys = keys + ("tflop_per_s", "bound_share", "device_ms",
                        "kernel_device_ms", "library_device_ms")
    ham_keys = ("kernel_route", "grid", "kernel_device_ms", "device_ms",
                "bound_share", "device_bound_share")
    lsh_keys = ("grid", "launches_per_call", "kernel_device_ms",
                "device_ms", "bound_share", "device_bound_share")
    rescore_keys = ("grid", "launches_per_call", "wrapper_host_us",
                    "kernel_device_ms", "device_ms", "bound_share",
                    "device_bound_share",
                    "composition", "composition_ms",
                    "composition_device_ms")

    def later(name):
        """The launches of the lifecycle, live-day and train_resume
        phases, each read by its ``PathLaunches``."""
        return {"live": {"launches": live_launches[name]},
                "lifecycle": {"launches": life_launches[name]},
                "train_resume": {"launches": resume_launches[name]}}

    def entry(name, replaces, main_case, deploy_case, n_launches,
              source=None, extra=(), **more):
        main = {k: main_case[k] for k in keys + extra}
        return {"name": name, "route": "cuda",
                "source": source or f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n_launches,
                "ms": main.pop("kernel_ms"), **main,
                "at_2_22": {k: deploy_case[k] for k in keys + extra},
                **later(name), **more}

    def fa_entry(case, n_launches, pass_, suffix=""):
        t = case["timing"]
        err = case["out_max_abs_err"] if pass_ == "fwd" \
            else case["grad_max_abs_err"]
        return {"name": f"flash_attention_{pass_}{suffix}", "route": "cuda",
                "kernel_route": t["kernel_route"],
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
                "launches": n_launches[f"flash_attention_{pass_}"],
                "max_abs_err": err, "ms": t[f"{pass_}_ms"],
                "plain_ms": t[f"{pass_}_plain_ms"],
                "bound_ms": t[f"{pass_}_bound_ms"],
                "bound_by": t[f"{pass_}_bound_by"],
                "library_ms": t[f"{pass_}_library_ms"],
                "tflop_per_s": t[f"{pass_}_tflop_per_s"],
                "bound_share": t[f"{pass_}_bound_share"],
                "shape": case["shape"],
                **later(f"flash_attention_{pass_}{suffix}")}

    print(json.dumps({"kernels": [
        # launches: the exact main path's; the quantized path's beside
        entry("lsh_hash", "src/repro/kernels/lsh_hash/kernel.py:51",
              lsh_main, lsh_deploy, launches["lsh_hash"], extra=lsh_keys,
              sharded_path={"launches": sh_launches["lsh_hash"],
                            "quantized_launches":
                                sh_q_launches["lsh_hash"]},
              baselines={"launches": base_launches["lsh_hash"]},
              query_cache={"launches": qc_launches["lsh_hash"]},
              ingest={"launches": ingest_launches["lsh_hash"],
                      "per_embed_tick": per_embed_tick},
              serving={"launches": serving_launches["lsh_hash"],
                       "summarizer": sum_launches["lsh_hash"]},
              k_128={k: lsh_wide[k] for k in keys + lsh_keys},
              growth_round={k: lsh_growth[k] for k in keys + lsh_keys},
              quantized_path={
                  "launches": q_launches["lsh_hash"],
                  **{k: lsh_quant[k] for k in keys + lsh_keys},
                  **{k: lsh_quant[k] for k in (
                      "bits_flipped", "code_plane_rows",
                      "code_plane_bits_flipped",
                      "query_code_bits_flipped")},
                  "query_encoding": {
                      k: lsh_quant["query_encoding"][k]
                      for k in keys + lsh_keys}}),
        entry("mips_topk", "src/repro/kernels/mips_topk/kernel.py:98",
              mips_main, mips_deploy, launches["mips_topk"],
              extra=mips_keys[len(keys):],
              at_2_22_b1={k: mips_b1[k] for k in mips_keys},
              sharded_path={"launches": sh_launches["mips_topk"],
                            "merge_launches":
                                sh_launches["merge_sharded_topk"]},
              # one b = 1 launch a question; the scan at VanillaRAG's
              # shape (its 25015 chunk rows, d = 256)
              baselines={"launches": base_launches["mips_topk"],
                         "b1_vanilla_shape": b1_scan},
              query_cache={"launches": qc_launches["mips_topk"]},
              ingest={"launches": ingest_launches["mips_topk"]},
              serving={"launches": serving_launches["mips_topk"],
                       "lm_reader": rag_launches["mips_topk"]},
              sharded_4_slots_at_2_22={
                  key: sh_deploy[key] for key in (
                      "sharded_ms", "flat_ms", "sharded_device_ms",
                      "flat_device_ms", "sharded_launches_per_call",
                      "merge_device_ms", "bitwise_equal_flat")}),
        # main path and at_2_22_c32: the list route (C = 32); at_2_22:
        # the counting route (C = 4096)
        entry("hamming_topk", "src/repro/kernels/hamming_topk/kernel.py:57",
              ham_main, quant_deploy["hamming_topk"],
              q_launches["hamming_topk"], extra=ham_keys,
              at_2_22_c32={k: quant_c32["hamming_topk"][k]
                           for k in keys + ham_keys},
              at_2_22_c32_b1={k: quant_c32["hamming_topk"]["b1"][k]
                              for k in keys + ham_keys},
              sharded_path={"launches": sh_q_launches["hamming_topk"]}),
        # the exact rescore, XLA (not Pallas) in the JAX package; main
        # path and at_2_22_c32: C = 32, at_2_22: C = 4096
        entry("mips_rescore", "src/repro/kernels/quantized_scan/ops.py:229",
              res_main, quant_deploy["mips_rescore"],
              q_launches["mips_rescore"],
              source="src/repro_torch/csrc/mips_topk.cu",
              extra=rescore_keys,
              at_2_22_c32={k: quant_c32["mips_rescore"][k]
                           for k in keys + rescore_keys},
              sharded_path={"launches": sh_q_launches["mips_rescore"]}),
        # launches: the bf16 training path's (5 steps), on the tensor
        # cores; the fp32 FMA kernels' from train_reference's card steps
        *(fa_entry(fa_main[torch.bfloat16], train_launches, pass_)
          for pass_ in ("fwd", "bwd")),
        *(fa_entry(fa_main[torch.float32], fp32_launches, pass_, "_fp32")
          for pass_ in ("fwd", "bwd")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
