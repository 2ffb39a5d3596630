#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    PYTHONPATH=src python3 chip_smoke.py

Run from the repository root.  It imports nothing of JAX or of the JAX
package.  Phases, each printing one JSON line:

1. ``device``    the card, torch and CUDA versions; builds every kernel
                 of the main path from ``src/repro_torch/csrc`` (one nvcc
                 per source, started together) into ``build/``: the
                 main path waits for ``lsh_hash`` and ``mips_topk``, and
                 ``hamming_topk`` and ``flash_attention`` build beside it
                 (the line is printed after the main path's).
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
                 count over every profiled call; the profiler's records
                 reported, each placed against the kept window), event
                 and device-only time and bound share; and the host
                 time of one
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
                 through ``EraRAG`` on ``ERARAG_QUANTIZED`` (checked
                 equal to the default with ``quantized_scan=True``), the
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
                 path's index: 8 questions twice (the second pass all
                 prefix hits, under the margin rule), 4 through
                 ``answer`` against their batch rows, 4 multihop
                 questions in exactly 2 ``generate_batch`` calls; the
                 report's ``prefix_cache`` and ``launches.engine``.
6j. ``serving_summarizer`` ``EraRAG`` with an ``LMSummarizer`` on the
                 same weights (8 documents: 6 built, 2 grown), batched
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
6l. ``live_day`` ``LiveHarness`` on ``ERARAG_STREAMING`` with 4 shards
                 and the query cache over the main path's 5000
                 documents (``make_schedule(seed=0, query_batch=64,
                 queries_per_phase=4)``, compaction threshold 0.15, the
                 extractive reader; a walk of the schedule, checked
                 against the service's deepest queue, keeps the queue
                 under the profile's bound of 4096, and the same walk
                 under ``ERARAG_DEFAULT`` at 2, 4 and 8 bursts, over its
                 bound of 1024, is why the day takes the streaming
                 profile): ingest bursts, removals, Zipf query
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
                 and the merge's.
    ``collective`` two ranks on the card in one gloo group
                 (``launch/mesh.run_ranks``; the kernels are built
                 already, the ranks load them).  At 2^22 each rank holds
                 2 of those 4 slots (2.27 GB) and runs
                 ``sharded_mips_topk`` and ``sharded_quantized_topk``
                 (C = 32): the exact ids and scores bitwise the flat
                 ``flagged_mips_topk``, both routes bitwise the loop
                 over the same slots, 2 slot launches of each kernel a
                 call; each rank's event ms of the call, of its scans
                 and of the gather and merge.  Then ``EraRAG(
                 ERARAG_DEFAULT, index_shards=4, group=...)`` over a
                 500-document corpus that both ranks build (a 50 % build
                 and 5 growth rounds): 64 questions in three modes
                 through the collective bitwise the loop and (sequence
                 numbers aside) a flat store, exact and quantized, the
                 launches counted and each route's batch ms; a reshard
                 to 8 under the group; the snapshot taken under the
                 group restored without one, bitwise.  The ranks' hits
                 must agree; a rank's failure stops both and the script.
    ``examples`` each ``examples/*_torch.py``'s ``main`` on the card
                 against a CPU run: quickstart, live_ingest and
                 rag_serve print the same lines; train_lm at 120 steps
                 (its default 300 cut), then its last checkpoint removed
                 and ``--resume`` from step 100, the resumed losses
                 bitwise the unbroken run's, each run's launches counted
                 (attention on the tensor-core route only, 32 forward
                 and 16 backward launches a step, the plain version
                 never), and a 3-step CPU run's model line the same;
                 its first 3 steps from the same weights on the card
                 (bf16) and the CPU (fp32), losses within 1e-3, and the
                 card's step split by the profiler; the attention
                 kernels at its shape (4, 8, 4, 128, 128, 64) held and
                 timed; distributed_retrieval at 2 ranks
                 (card and CPU print the same lines) and at 1 (the
                 collective off).  The host's runs of train_lm and
                 distributed_retrieval and the one-rank run go in child
                 processes beside the card's.  Seconds per example.  The
                 ``reference`` phase then runs again with
                 ``index_shards=4``, exact and quantized.
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
11. ``moe_serving`` deepseek-moe-16b at all 28 layers in bf16 (random
                 weights, seed 0) behind an ``Engine`` of 8 slots x 4096
                 positions: the 8 serving prompts as one batch; prefill ms
                 by bucket, the decode step's median ms at 8 live slots
                 against its byte bound (every expert's weights: the
                 dispatch runs them all; + K/V), its kernels, device ms by
                 kind and host share; the share of routed assignments
                 capacity dropped, prefill and decode (capacity 1 an
                 expert in decode).  ``moe_summarizer``: an
                 ``LMSummarizer`` on it over 8 documents, every
                 ``lsh_hash`` shape held.  ``moe_serving_rag``: the
                 ``serving_rag`` phase run with it as the LM reader (its
                 comparisons reported under the margin rule, not held:
                 MoE rows share capacity, in the reference too).
    ``moe_maverick_block`` one [dense, moe] block of llama4-maverick at
                 full width (2 of its 48 layers, bf16): ``prefill_padded``
                 of 4 rows in a 512 bucket and 4 ``decode_step``s, finite
                 logits, times beside the weights' byte bound.
    ``moe_reference`` reduced deepseek-moe-16b and llama4-maverick
                 engines (weights drawn once on the CPU) on the card and
                 on the CPU in fp32: tokens under the margin rule, stats
                 equal, logits within SERVING_REF_TOL; a bf16 ``moe_fwd``
                 at deepseek's full width twice, bitwise.
    ``moe_train`` deepseek-moe-16b at full width, 4 layers: 5 Adafactor
                 steps of 2 x 4096 tokens in 2 microbatches, gradients
                 summed and the update run in bf16, on one fixed batch;
                 the loss must fall, attention on the tensor-core route
                 only; the attention kernels at its shape (hq = hkv = 16,
                 d = 128) held against the plain version and timed.
12. ``families_start`` the card memory in use as the next phases
                 begin (after a garbage collection).
    ``recsys``   each of dcn-v2, deepfm, dien and mind at its full
                 config through ``get_api(get_arch(name))`` (fused fp32
                 tables of 13,130,240 x 16, 14,313,216 x 10 + the
                 first-order column, 1,000,192 x 18 and 1,000,192 x
                 64), in its 4 shapes: ``serve_p99`` (b = 512) and
                 ``serve_bulk`` (b = 262144), ms a batch and rows/s;
                 ``retrieval_cand`` (mind: 1 user x 1M candidates,
                 top-100; the others score the 1M-row slab as serve
                 batches, dien in 4 slices of 262,144); ``train_batch``
                 (b = 65536): 5 AdamW steps on one fixed batch, step s,
                 peak memory, the loss falling, and whether a backward
                 repeats bitwise (reported); AdamW at the reference's
                 3e-4, dcn-v2 at 1e-4 (``RECSYS_LR``).  Each shape's
                 first rows (mind: the whole top-100) against the same
                 weights on the CPU, within 1e-5 of the CPU's largest
                 magnitude; the loss of the first rows and each of its
                 gradient leaves too.
    ``gnn``      gatedgcn (16 layers, d = 70, 47 classes) through
                 ``get_api`` on ``full_graph_sm``, ``molecule`` and
                 ``minibatch_lg`` (a ``NeighborSampler`` subgraph of 1024
                 seeds at fanout (15, 10) from a 232,965-node host graph
                 with a tenth of its edges, padded to 169,984 nodes and
                 168,960 edges): two forwards bitwise, the 4-layer
                 checkpoint groups bitwise no checkpoint (loss and
                 grads), 5 AdamW steps with the loss falling;
                 ``full_graph_sm`` against the CPU.
    ``phi3_serving`` phi3-medium-14b at all 40 layers in bf16 behind an
                 ``Engine`` of 8 slots x 4096 positions: the 8 serving
                 prompts, 16 new tokens; decode against prefill; prefill
                 ms by bucket, the decode step's median ms at 8 live
                 slots against its byte bound, its kernels and host
                 share.  These phases launch no kernel of the port
                 (checked).
    ``phi3_train`` phi3-medium-14b at full width, 4 layers, l = 4096:
                 5 AdamW steps of 2 sequences in 2 microbatches, bf16;
                 attention on the tensor-core route only, and its
                 kernels at (1, 40, 10, 4096, 128) held against the
                 plain version and timed.
    ``dryrun``   the dry run (``repro_torch.launch.dryrun``) on a
                 one-device (1, 1) mesh, in a child process started
                 with the script (it runs on the host alone, beside the
                 phases; the ``collective`` phase owns a real group), at
                 the exact
                 config, depth, batch and policy of seven setups the
                 phases above ran and measured: ``train_path``,
                 ``moe_train`` (Adafactor, bf16 accumulation; the MoE
                 dispatch and combine take their dry-run ops),
                 ``phi3_train`` (GQA groups of 4), dcn-v2 and deepfm
                 ``train_batch``, deepfm ``serve_bulk`` (fp32 weights,
                 as the phase holds them) and gatedgcn
                 ``full_graph_sm``.  One line a setup: the predicted
                 peak bytes against the phase's
                 ``torch.cuda.max_memory_allocated`` less what was
                 allocated before the setup made its weights (the ratio
                 must lie in ``DRYRUN_PEAK_BAND``), the roofline's bound time
                 against the measured step (the step's roofline share),
                 and the predicted flops by dtype at the card's peaks.
    ``timeline`` the wall seconds of each step of the script.
10. ``kernels``  one line listing every kernel with its numbers (the
                 ``lsh_hash`` and ``mips_topk`` entries with the
                 launches of phases 6c-6e and 6g-6j beside the main
                 path's, and every entry with the launches of
                 ``live_day``, ``lifecycle``, ``train_resume``, the
                 MoE phases and ``phi3_train``, and ``mips_topk``,
                 ``hamming_topk`` and the rescore with the
                 ``collective`` ranks' launches; the bf16 attention
                 entries with the MoE and phi3 training shapes' cases
                 as ``moe_train_shape`` and ``phi3_train_shape``, and
                 the train_lm example's as ``train_lm_example_shape``
                 beside its runs' launches, ``examples_train_lm``).

Times are CUDA-event medians after a warm-up.  Any failed check raises,
and the script exits non-zero; the last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MEASURED = {}               # the dryrun setups' peaks and step times
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
    planes ``h``: grid, event and device-only times beside the bound.
    The wrapper launches its kernel once a call, by its own count, over
    every profiled call; the profiler must see that kernel alone.  Its
    records per call are reported, not held: it drops records, and has
    held one more than the calls in a window of 10, so each record's
    place against the kept window is reported too."""
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
    calls = [0]

    def call():
        calls[0] += 1
        return ops.lsh_hash(v, h)
    launches, trace = {}, {}
    before = ops.launch_count()
    kernels = kernel_ms(call, launches=launches, trace=trace,
                        expect=("lsh_hash_kernel",))
    wrapper = ops.launch_count() - before
    check(wrapper == calls[0],
          f"lsh_hash n={n}: {wrapper} launches for {calls[0]} calls")
    check(set(launches) == {"lsh_hash_kernel"},
          f"lsh_hash n={n}: the profiler saw {launches}")
    device = sum(kernels.values())
    outside = [r for r in trace["records"] if not r["in_window"]]
    return {"grid": lsh_grid(n, k, sm_count(v.device))._asdict(),
            "profiled_calls": calls[0],
            "profiled_wrapper_launches": wrapper,
            "profiler_launches_per_call": launches,
            "profiler_records": len(trace["records"]),
            "profiler_window_us": trace["window_us"],
            "profiler_records_outside_window": outside,
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
    """The main path again on the quantized serving profile, held against
    the exact path ``exact`` (same corpus, rounds and questions)."""
    from dataclasses import replace

    from repro_torch.configs.erarag import ERARAG_DEFAULT, \
        ERARAG_QUANTIZED
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.store import _filter_bias
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.kernels.lsh_hash import ops as lsh_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.serving.rag_pipeline import RAGPipeline

    init, rounds = corpus.growth_rounds(0.5, 5)
    cfg = ERARAG_QUANTIZED
    # the profile is the default with the scan switched on, so its
    # numbers compare with every earlier quantized path's
    check(cfg == replace(ERARAG_DEFAULT, quantized_scan=True),
          f"quantized path: ERARAG_QUANTIZED is not the default with "
          f"quantized_scan=True: {cfg}")
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

    emit("quantized_path", profile="ERARAG_QUANTIZED", rows=store.size,
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
# tokens a request generates (cut from 32; the LM reader's and the
# summarizer's cut from 16): host-bound decode launches are most of the
# serving phases' time
SERVE_NEW_TOKENS = 16
RAG_NEW_TOKENS = 8
SUMMARY_TOKENS = 8
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


def margin_rule(a: TokenLog, b: TokenLog, what: str, keys=None,
                enforce: bool = True) -> dict:
    """Two runs of the same prompts: at every step before they part the
    tokens are equal, and where they part the smaller top-1 over top-2
    margin must lie within the largest logit difference at that step.
    Returns the largest difference over the steps compared and each
    part.  ``enforce=False`` reports without checking: an MoE model's
    rows share expert capacity, so two runs that batch the same prompts
    differently (alone, as prefix hits) route them differently in the
    reference too."""
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
                check(margin <= diff or not enforce,
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


def _serve_prompts(eng, corpus, phase):
    """(words, prompts, their token lengths): the corpus text as engine
    tokens, a prompt of n tokens (BOS and EOS included) n - 2 of them
    joined by spaces, one of each of SERVE_PROMPT_LENGTHS."""
    words = eng.tok.tokenize(" ".join(t for _, t in corpus.docs[:400]))
    prompts = [" ".join(words[i * 4000:i * 4000 + n - 2])
               for i, n in enumerate(SERVE_PROMPT_LENGTHS)]
    lengths = [len(eng.tok.encode(p, add_special=True)) for p in prompts]
    check(lengths == list(SERVE_PROMPT_LENGTHS),
          f"{phase}: prompt lengths {lengths}")
    return words, prompts, lengths


def _launch_timers(eng):
    """``LaunchTimer``s of the engine's cold prefill launches (bucket,
    prompts, tokens) and decode launches (live slots, length)."""
    return (LaunchTimer(eng, "_prefill_bucket", lambda e, t, l, s: {
                "bucket": int(t.shape[1]), "prompts": len(s),
                "tokens": int(np.sum(l))}),
            LaunchTimer(eng, "_decode_step", lambda e, t, n, rows: {
                "live_slots": sum(s.active for s in e.slots),
                "length": int(n)}))


def _per_bucket(records):
    """Prefill launch records by bucket: their ms and tokens, the median
    ms, tokens/s each, and padded tokens/s at the median."""
    per_bucket = {}
    for r in records:
        b = per_bucket.setdefault(r["bucket"], {"ms": [], "tokens": []})
        b["ms"].append(r["ms"])
        b["tokens"].append(r["tokens"])
    for blen, b in per_bucket.items():
        med = statistics.median(b["ms"])
        b["median_ms"] = med
        b["tokens_per_s"] = [t / ms * 1e3 for t, ms in
                             zip(b["tokens"], b["ms"])]
        b["padded_tokens_per_s"] = SERVE_MAX_BATCH * blen / med * 1e3
    return per_bucket


def _weight_bytes(model):
    """Bytes of the weights a decode step reads (each in its own dtype),
    the embedding table (a gather) left out."""
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters() if n != "embed")


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
    words, prompts, lengths = _serve_prompts(eng, corpus, "serving_engine")
    buckets = [eng._bucket_len(n) for n in lengths]
    prefill_t, decode_t = _launch_timers(eng)
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
    per_bucket = _per_bucket(prefill_t.records)
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
    weight_bytes = _weight_bytes(model)
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


# the reader's questions a pass, cut from 16 (two batches) to one
# batch, and its multihop questions, cut from 8
RAG_QUESTIONS = SERVE_MAX_BATCH
RAG_MULTIHOP = 4


def run_serving_rag(rag, corpus, model, cfg, phase="serving_rag"):
    """``RAGPipeline(rag, engine=...)`` over the main path's index:
    ``RAG_QUESTIONS`` questions twice (the second pass all prefix hits;
    one full batch of the engine's slots), 4 through
    ``answer``, ``RAG_MULTIHOP`` multihop questions in two
    ``generate_batch`` calls.
    For an MoE model the passes are compared under the margin rule but
    not held to it (``margin_rule(enforce=False)``)."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.rag_pipeline import RAGPipeline

    t0 = _phase_start()
    path = PathLaunches(record=True)
    eng = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
        max_new_tokens=RAG_NEW_TOKENS, compute_dtype=torch.bfloat16,
        prefix_cache_entries=64))
    pipe = RAGPipeline(rag, engine=eng)
    questions = [qa.question for qa in corpus.qa
                 if qa.kind == "detailed"][:RAG_QUESTIONS]
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
          f"{phase}: second pass hits "
          f"{eng.stats['prefix_hits'] - hits0}")
    check([a.context for a in first] == [a.context for a in second],
          f"{phase}: contexts differ between passes")
    coupled = cfg.is_moe
    pass_cmp = margin_rule(first_log, second_log,
                           f"{phase} second pass vs first",
                           enforce=not coupled)
    one_log = TokenLog(eng)
    singles = [path.drive(lambda q=q: pipe.answer(q))
               for q in questions[:4]]
    one_log.stop(eng)
    one_cmp = margin_rule(second_log, one_log,
                          f"{phase} answer vs answer_batch",
                          keys=list(one_log.rows), enforce=not coupled)
    # the multihop questions, those whose round-1 retrieval finds a bridge
    # first (only they take a bridge-extraction launch)
    hop = [qa.question for qa in corpus.qa if qa.kind == "multihop"]
    rets = rag.query_batch(hop[:256], mode="multihop")
    bridged = [q for q, r in zip(hop, rets) if r.hops == 2]
    check(bridged, f"{phase}: no multihop question finds its bridge")
    hop = (bridged + [q for q in hop if q not in bridged])[:RAG_MULTIHOP]
    gb = eng.stats["generate_batches"]
    t = time.perf_counter()
    hop_answers = path.drive(
        lambda: pipe.answer_batch(hop, mode="multihop"))
    hop_s = time.perf_counter() - t
    check(eng.stats["generate_batches"] - gb == 2,
          f"{phase}: multihop generate_batches "
          f"{eng.stats['generate_batches'] - gb}")
    check(all(a.answer.startswith("tok") for a in
              first + second + singles + hop_answers),
          f"{phase}: an empty answer")
    check(path.counts["mips_topk"] > 0,
          f"{phase}: mips_topk never launched")
    rep = pipe.index_report()
    check(rep["prefix_cache"]["hits"] == eng.stats["prefix_hits"] and
          rep["launches"]["engine"]["generate_batches"] ==
          eng.stats["generate_batches"],
          f"{phase}: index_report differs from the engine")
    scans = _path_kernel_cases(path, phase, timed=True)
    emit(phase, model=cfg.name, n_layers=cfg.n_layers,
         margin_rule_enforced=not coupled, questions=len(questions),
         context_tokens=[a.n_context_tokens for a in first[:4]],
         first_pass_s=first_s, second_pass_s=second_s,
         answers_per_s={"first_pass": len(questions) / first_s,
                        "second_pass": len(questions) / second_s,
                        "multihop": len(hop) / hop_s},
         second_pass_vs_first=pass_cmp,
         answer_vs_answer_batch=one_cmp,
         multihop={"questions": len(hop), "generate_batches": 2,
                   "bridged": min(len(bridged), RAG_MULTIHOP),
                   "seconds": hop_s},
         prefix_cache=rep["prefix_cache"],
         launches_engine=rep["launches"]["engine"],
         launches=dict(path.counts), kernel_cases=scans, **_phase_end(t0))
    del eng, pipe
    return dict(path.counts)


# the LM summarizers' corpus (cut from 32 documents, then 16, to keep
# the whole script well inside its time limit); 3/4 built, 1/4 grown
SUMMARY_DOCS = 8
SUMMARY_BUILT = SUMMARY_DOCS * 3 // 4


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
    docs = SyntheticCorpus.generate(n_docs=SUMMARY_DOCS, n_topics=8,
                                    seed=0).docs
    runs = {}
    for batched in (True, False):
        eng = Engine(cfg, model, EngineConfig(
            max_batch=SERVE_MAX_BATCH, max_seq_len=1024,
            max_new_tokens=SUMMARY_TOKENS, compute_dtype=torch.bfloat16,
            prefix_cache_entries=0))
        log = TokenLog(eng)
        rag = EraRAG(replace(ERARAG_DEFAULT, batch_summaries=batched),
                     HashingEmbedder(dim=256),
                     summarizer=LMSummarizer(eng,
                                             max_tokens=SUMMARY_TOKENS),
                     device="cuda")
        t = time.perf_counter()
        path.drive(lambda: rag.insert_docs(docs[:SUMMARY_BUILT]))
        path.drive(lambda: rag.insert_docs(docs[SUMMARY_BUILT:]))
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
    emit("serving_summarizer", corpus=f"SyntheticCorpus(n_docs="
         f"{SUMMARY_DOCS}, n_topics=8, seed=0): {SUMMARY_BUILT} built, "
         f"{SUMMARY_DOCS - SUMMARY_BUILT} grown",
         reduced={"docs": [5000, SUMMARY_DOCS]}, max_tokens=SUMMARY_TOKENS,
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


DEPLOY_SLOTS = 4            # the 2^22 rows' slots (sharded_2_22, collective)
DEPLOY_K = 8
DEPLOY_D = 256


def _deploy_rows():
    """The 2^22 seeded rows (d = 256 + 3 flags: 10 % dead, 30 % summary)
    and 64 unit queries of the deployment-size sharded checks, rows
    1000..1003 copies of row 999 and query 0 equal to it, so that exact
    ties cross the slots."""
    d = DEPLOY_D
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
    return db, qd


def _deploy_owners():
    """Each 2^22 row's slot (the store's blake2b routing of ``row<i>``)
    on the card, and the slots' row counts."""
    from repro_torch.core.store import _bulk_route
    owners = torch.from_numpy(_bulk_route(
        [f"row{i}" for i in range(N_DEPLOY)], DEPLOY_SLOTS)).cuda()
    return owners, torch.bincount(owners, minlength=DEPLOY_SLOTS).tolist()


def _deploy_slots(db, owners, slots, cap):
    """The stacked rows of ``slots`` (each slot's rows in their flat
    order, padding rows dead) and their sequence plane, each row's
    sequence number its flat index."""
    from repro_torch.kernels.mips_topk import ops as mips_ops
    d = DEPLOY_D
    stack = torch.zeros(len(slots), cap, d + 3, device="cuda")
    stack[..., d] = 1.0                               # padding: dead
    seq = torch.full((len(slots), cap), mips_ops.SEQ_PAD,
                     dtype=torch.int32, device="cuda")
    for j, s in enumerate(slots):
        rows = torch.nonzero(owners == s).flatten()   # ascending
        stack[j, :len(rows)] = db[rows]
        seq[j, :len(rows)] = rows.int()
    return stack, seq


def run_sharded_deploy():
    """2^22 rows hash-routed into 4 slots of one stacked buffer: the
    per-slot scans plus the merge against ``flagged_mips_topk`` over the
    same rows, with each row's sequence number its flat index."""
    from repro_torch.core.store import _filter_bias, slot_topk
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.timing import device_ms, kernel_ms, time_ms

    n_slots, k, d = DEPLOY_SLOTS, DEPLOY_K, DEPLOY_D
    db, qd = _deploy_rows()
    t0 = time.perf_counter()
    owners, counts = _deploy_owners()
    route_s = time.perf_counter() - t0
    cap = max(counts)
    stack, seq = _deploy_slots(db, owners, range(n_slots), cap)
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
# the collective query over a process group (two ranks on the card)
# ---------------------------------------------------------------------------

COLLECTIVE_RANKS = 2
COLLECTIVE_C = 32           # the quantized collective's coarse width
COLLECTIVE_DOCS = 500       # the store-level check's corpus
COLLECTIVE_REPS = 5         # timed query batches a route


def _collective_deploy(group):
    """One rank's share of the 2^22 rows (2 of the 4 slots): the
    collective exact and quantized scans against the flat scan and the
    loop route over the same slots, bitwise, with this rank's times."""
    from repro_torch.common.sharding import stacked_slot_range
    from repro_torch.core.store import N_FLAGS, _filter_bias, slot_topk
    from repro_torch.kernels.hamming_topk import ops as ham_ops
    from repro_torch.kernels.lsh_hash import ops as lsh_ops
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.quantized_scan import ops as quant_ops
    from repro_torch.kernels.timing import time_ms

    k, d, c = DEPLOY_K, DEPLOY_D, COLLECTIVE_C
    t0 = time.perf_counter()
    db, qd = _deploy_rows()
    owners, counts = _deploy_owners()
    local = stacked_slot_range(DEPLOY_SLOTS, group.world_size, group.rank)
    stack, seq = _deploy_slots(db, owners, local, max(counts))
    bias = _filter_bias(None)
    flat_v, flat_i = mips_ops.flagged_mips_topk(qd, db, k, bias)
    spec = quant_ops.QuantSpec(dim=d, n_bits=64, n_flags=N_FLAGS, seed=0)
    planes = torch.from_numpy(quant_ops.hyperplanes(spec)).cuda()
    codes = torch.stack([quant_ops.encode_rows(rows[:, :d], rows[:, d:],
                                               planes, spec)
                         for rows in stack])
    del db, owners
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    q_aug = mips_ops.augment_queries(qd, bias).contiguous()
    qq_aug, q_codes = quant_ops.prepare_queries(qd, bias, planes, spec)

    def exact():
        return mips_ops.sharded_mips_topk(qd, stack, seq, k, k, bias,
                                          group=group)

    def quantized():
        return quant_ops.sharded_quantized_topk(
            qd, stack, codes, seq, planes, k, k, c, bias, spec,
            group=group)

    def loop(qa, **quant):
        parts = [slot_topk(qa, stack[j], seq[j], k,
                           codes=codes[j] if quant else None, **quant)
                 for j in range(len(local))]
        return mips_ops.gather_merge_topk(
            torch.stack([v for v, _ in parts]),
            torch.stack([s for _, s in parts]), k, group)

    counters = {"mips_topk": mips_ops.launch_count,
                "hamming_topk": ham_ops.launch_count,
                "mips_rescore": mips_ops.rescore_launch_count,
                "lsh_hash": lsh_ops.launch_count,
                "collective": mips_ops.collective_launch_count}

    def one_call(fn):
        before = {n: f() for n, f in counters.items()}
        out = fn()
        return out, {n: f() - before[n] for n, f in counters.items()}

    (ev, es), exact_launches = one_call(exact)
    (qv, qs), quant_launches = one_call(quantized)
    lv, ls = loop(q_aug)
    qlv, qls = loop(qq_aug, q_codes=q_codes, n_coarse=c)
    torch.cuda.synchronize()
    check(torch.equal(ev, flat_v) and torch.equal(es, flat_i),
          f"collective 2^22 (rank {group.rank}): the exact collective "
          f"differs from the flat scan")
    check(es[0, :5].tolist() == list(range(999, 1004)),
          "collective 2^22: the planted duplicates out of order")
    check(torch.equal(ev, lv) and torch.equal(es, ls),
          "collective 2^22: the exact collective differs from the loop")
    check(torch.equal(qv, qlv) and torch.equal(qs, qls),
          "collective 2^22: the quantized collective differs from the "
          "loop")
    check(exact_launches["mips_topk"] == len(local) and
          quant_launches["hamming_topk"] == len(local) and
          quant_launches["mips_rescore"] == len(local),
          f"collective 2^22: launches {exact_launches} {quant_launches}")
    # this rank's times (the other rank shares the card meanwhile)
    cand = mips_ops.local_slot_scans(q_aug, stack, seq, k)
    times = {
        "exact_ms": time_ms(exact),
        "exact_scans_ms": time_ms(
            lambda: mips_ops.local_slot_scans(q_aug, stack, seq, k)),
        "gather_merge_ms": time_ms(
            lambda: mips_ops.gather_merge_topk(*cand, k, group)),
        "quantized_ms": time_ms(quantized)}
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(
        qs.tolist(), es.tolist())]))
    return {"shape": {"b": 64, "n": N_DEPLOY, "d": d + 3, "k": k,
                      "slots": DEPLOY_SLOTS, "local_slots": list(local),
                      "slot_rows": counts, "capacity": max(counts),
                      "c": c},
            "local_bytes": stack.numel() * 4 + seq.numel() * 4 +
            codes.numel() * 4,
            "setup_s": setup_s, "bitwise_equal_flat": True,
            "bitwise_equal_loop": True, "quantized_recall_at_8": recall,
            "launches_per_call": {"exact": exact_launches,
                                  "quantized": quant_launches},
            **times}


def _collective_store(group):
    """``EraRAG`` on the group at 4 shards over a 500-document corpus,
    built by every rank: 64-question batches in three modes through the
    collective against the loop and a flat store, exact and quantized;
    a reshard to 8 under the group; the snapshot taken under the group
    restored without one."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.store import VectorStore
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder

    corpus = SyntheticCorpus.generate(n_docs=COLLECTIVE_DOCS, n_topics=64,
                                      seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)
    questions = [qa.question for qa in corpus.qa[:64]]
    cfg = replace(ERARAG_DEFAULT, index_shards=4)
    rag = EraRAG(cfg, HashingEmbedder(dim=256), group=group)
    t0 = time.perf_counter()
    for docs in [init] + rounds:
        rag.insert_docs(docs)
    rag.store.refresh()
    build_s = time.perf_counter() - t0

    def hits(seqs=True):
        return {mode: [_bits_key(r.hits, seqs)
                       for r in rag.query_batch(questions, mode=mode)]
                for mode in MODES}

    def batch_ms(store, collective):
        store.collective = collective
        out = []
        for _ in range(COLLECTIVE_REPS):
            t = time.perf_counter()
            rag.query_batch(questions)
            out.append((time.perf_counter() - t) * 1e3)
        store.collective = True
        return statistics.median(out)

    def routes(what):
        """The collective's hits (its launches counted), the loop's,
        and each route's batch ms."""
        store = rag.store
        check(store.collective_active, f"collective {what}: not active")
        path = PathLaunches()
        coll = path.drive(hits)
        store.collective = False
        loop = hits()
        store.collective = True
        check(coll == loop, f"collective {what}: the collective's hits "
                            f"differ from the loop's")
        return coll, path.counts, {
            "collective_batch_ms": batch_ms(store, True),
            "loop_batch_ms": batch_ms(store, False),
            "local_slots": store._group.buf.shape[0]}

    exact, exact_launches, exact_ms = routes("exact")
    sharded = rag.store
    rag.store = VectorStore(rag.graph, device=group.device)
    flat = hits(seqs=False)
    rag.store = sharded
    check(hits(seqs=False) == flat,
          "collective exact: the hits differ from a flat store's")
    state = rag.state_dict()
    state["cfg"] = {**state["cfg"], "quantized_scan": True}
    qrag, rag = rag, EraRAG.from_state(state, HashingEmbedder(dim=256),
                                       group=group)
    quant, quant_launches, quant_ms = routes("quantized")
    rag = qrag
    t0 = time.perf_counter()
    rag.reshard(8)
    reshard_s = time.perf_counter() - t0
    check(rag.store.collective_active and rag.store.n_shards == 8,
          "collective: the reshard to 8 left the collective")
    check(hits(seqs=False) == flat,
          "collective: the hits after the reshard to 8 differ")
    resharded = hits()
    back = EraRAG.from_state(rag.state_dict(include_store=True),
                             HashingEmbedder(dim=256), device=group.device)
    # (restored at the graph's config: 4 shards, replayed from 8)
    check(back.store.group is None,
          "collective: the snapshot restored onto a group")
    rag = back
    check(hits() == resharded, "collective: the snapshot taken under the "
                               "group restores other hits without one")
    return {"docs": COLLECTIVE_DOCS, "rows": sharded.size,
            "build_s": build_s, "reshard_8_s": reshard_s,
            "exact": exact_ms, "quantized": quant_ms,
            "launches": {"exact": exact_launches,
                         "quantized": quant_launches},
            "digest": hashlib.blake2b(repr((exact, quant, resharded))
                                      .encode()).hexdigest()}


def _collective_rank(group):
    out = {"rank": group.rank, "backend": group.backend,
           "device": str(group.device),
           "deploy": _collective_deploy(group)}
    torch.cuda.empty_cache()
    out["store"] = _collective_store(group)
    return out


def run_collective():
    """Two ranks on the card in one gloo group (``run_ranks``), each
    holding half the slots: the 2^22 rows' collective scans and the
    store-level collective, every check inside the ranks (a rank's
    failure stops both and fails the script); the ranks' hits must
    agree.  The kernels are built already: the ranks load them."""
    from repro_torch.launch.mesh import local_data_group, run_ranks

    check(local_data_group(min_devices=2, device="cuda") is None,
          "collective: a group of 2 from one process")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_collective_rank, COLLECTIVE_RANKS, device="cuda",
                      timeout_s=600)
    wall_s = time.perf_counter() - t0
    check(len({r["store"]["digest"] for r in ranks}) == 1,
          "collective: the ranks' hits differ")
    launches = {name: sum(r["store"]["launches"][route][name]
                          for r in ranks for route in ("exact",
                                                       "quantized"))
                for name in ("lsh_hash", "mips_topk", "hamming_topk",
                             "mips_rescore")}
    for name in ("mips_topk", "hamming_topk", "mips_rescore"):
        check(launches[name] > 0,
              f"collective: {name} never launched in the ranks' queries")
    for r in ranks:
        r["store"].pop("digest")
    emit("collective", ranks=COLLECTIVE_RANKS, wall_s=wall_s,
         backend=ranks[0]["backend"], devices=[r["device"] for r in ranks],
         launches=launches,
         by_rank=[{k: r[k] for k in ("rank", "deploy", "store")}
                  for r in ranks],
         against_sharded_2_22="sharded_ms: the 4-slot loop + merge "
                              "in one process")
    return {"launches": launches,
            "by_rank": [{"exact_ms": r["deploy"]["exact_ms"],
                         "exact_scans_ms": r["deploy"]["exact_scans_ms"],
                         "gather_merge_ms": r["deploy"]["gather_merge_ms"],
                         "quantized_ms": r["deploy"]["quantized_ms"],
                         "launches_per_call":
                             r["deploy"]["launches_per_call"]}
                        for r in ranks]}


# ---------------------------------------------------------------------------
# the port's examples on the card, against their CPU runs
# ---------------------------------------------------------------------------

def _example(name):
    import importlib
    return importlib.import_module(f"{name}_torch")


def _example_child(name, argv):
    """``examples/<name>_torch.py argv`` in a child process (a session of
    its own, with the ranks it spawns), started beside the card's runs:
    (the process, a thread reading its output and timing it to its end,
    what the thread read); ``_child_lines`` waits for it."""
    import os
    import threading
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT, start_new_session=True)
    t0, done = time.perf_counter(), {}

    def read():
        done["out"], done["err"] = proc.communicate()
        done["seconds"] = time.perf_counter() - t0

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, reader, done


def _stop_child(proc):
    """Kill ``proc``'s session if it is still running."""
    import os
    import signal
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _child_lines(child, what):
    """A child's printed lines and its seconds, once it has ended."""
    proc, reader, done = child
    reader.join(timeout=600)
    if reader.is_alive():
        _stop_child(proc)
        reader.join()
        raise CheckFailed(f"examples: {what} ran over 600 s")
    check(proc.returncode == 0,
          f"examples: {what} exited {proc.returncode}: "
          f"{done['err'][-2000:]}")
    return done["out"].splitlines(), done["seconds"]


def _example_run(main, argv):
    """``main(argv)``'s printed lines, its result and its seconds."""
    import contextlib
    import io
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue().splitlines(), result, time.perf_counter() - t0


# the train_lm example's 2 microbatches a step (its LoopConfig)
TRAIN_LM_MICROBATCHES = 2
# its steps, cut from its default 300 to keep the script well inside
# its time limit: a checkpoint at 100 (its ckpt_every) and at the end
TRAIN_LM_STEPS = 120
TRAIN_LM_CKPT = 100
# card (bf16 compute, the tensor-core attention kernels) against CPU
# (fp32, the plain versions) over the example's first steps: relative
# error of each loss (the bf16 losses' tolerance of
# tests/test_torch_adafactor.py; the CPU's own bf16 and fp32 losses of
# these steps differ by 2e-5 relative)
TRAIN_LM_REF_STEPS = 3
TRAIN_LM_LOSS_RTOL = 1e-3


def _train_lm_against_cpu(mod):
    """The train_lm example's model (``mod.small_lm()``), batches (8 x
    128 tokens in 2 microbatches) and AdamW schedule from the same
    seeded weights: 3 steps on the card in bf16, the example's compute,
    and on the CPU in fp32 (bf16 there takes about 15 s a step), each
    loss within ``TRAIN_LM_LOSS_RTOL``.  Then the card's step split by
    the profiler: CUDA-event ms, device ms by kind of kernel, the
    kernels a step, the host's share and the costliest kernels."""
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.timing import kernel_ms, time_ms
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from repro_torch.train.optimizer import cosine_schedule, \
        make_train_step, opt_init

    cfg = mod.small_lm()
    tree = params_to_numpy(T.init_params(cfg, torch.Generator()
                                         .manual_seed(0)))
    make = synthetic_lm_batches(cfg.vocab_size, 8, 128, seed=0)
    losses, card = {}, None
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        step = make_train_step(
            lambda m, bt, dt=dtype: T.loss_fn(m, bt, cfg, compute_dtype=dt),
            n_microbatches=TRAIN_LM_MICROBATCHES,
            lr_schedule=cosine_schedule(3e-4, warmup=20,
                                        total=TRAIN_LM_STEPS))
        model = params_from_numpy(tree, cfg, device=dev)
        opt = opt_init(model)
        losses[dev] = []
        for i in range(TRAIN_LM_REF_STEPS):
            model, opt, m = step(model, opt, make(i))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            card = [step, model, opt]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(err <= TRAIN_LM_LOSS_RTOL,
          f"examples: train_lm's card losses {losses['cuda']} vs the "
          f"CPU's {losses['cpu']}")
    step, batch = card[0], make(TRAIN_LM_REF_STEPS)

    def one():
        card[1], card[2], _ = step(card[1], card[2], batch)

    event_ms = time_ms(one, reps=5, warmup=1)
    launches = {}
    by_kernel = kernel_ms(one, reps=2, pattern=r"^(.+)$",
                          launches=launches)
    device = sum(by_kernel.values())
    kinds = {}
    for name, ms in by_kernel.items():
        ms_n = kinds.setdefault(_kernel_kind(name), [0.0, 0.0])
        ms_n[0] += ms
        ms_n[1] += launches.get(name, 0)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": TRAIN_LM_REF_STEPS, "card_compute": "bfloat16",
            "cpu_compute": "float32", "card_losses": losses["cuda"],
            "cpu_losses": losses["cpu"], "max_loss_rel_err": err,
            "loss_tolerance": TRAIN_LM_LOSS_RTOL,
            "step_split": {
                "event_ms": event_ms, "device_ms": device,
                "host_share": (event_ms - device) / event_ms,
                "kernels_per_step": sum(n for _, n in kinds.values()),
                "by_kind": {k: {"device_ms": v[0], "kernels": v[1]}
                            for k, v in sorted(kinds.items())},
                "costliest": [{"kernel": n[:80], "device_ms": ms,
                               "launches": launches.get(n, 0)}
                              for n, ms in top]}}


def run_examples():
    """Each ``examples/*_torch.py``'s ``main`` on the card (its own
    asserts included) against a CPU run of the same example: every
    printed line equal where the example is deterministic.
    ``train_lm_torch`` at ``TRAIN_LM_STEPS`` then, its last checkpoint
    removed, ``--resume`` from ``TRAIN_LM_CKPT``: the resumed losses
    bitwise the unbroken run's; each run's kernels counted (its
    ``PathLaunches``): the attention kernels on the tensor-core route
    only, as many launches as its steps make, the plain version never;
    on the CPU a 3-step run prints the same model line; the example's
    first steps held against the CPU (``_train_lm_against_cpu``) and
    the attention kernels at its shape held against the plain version
    and timed.  ``distributed_retrieval_torch`` at 2 ranks (card and
    CPU) and at 1 (the collective off).  The host's train_lm and
    distributed_retrieval runs, and the one-rank run, go in child
    processes beside the card's (their seconds from start to end).
    Returns the train_lm runs' launches and the attention case."""
    sys.path.insert(0, str(ROOT / "examples"))
    seconds, out = {}, {}
    cpu_tmp = _scratch_dir("train_lm_cpu_")
    children = {
        "train_lm_cpu": _example_child("train_lm", [
            "--steps", "3", "--batch", "2", "--seq", "32", "--device",
            "cpu", "--ckpt", str(Path(cpu_tmp.name) / "cpu")]),
        "distributed_retrieval_cpu": _example_child(
            "distributed_retrieval", ["--ranks", "2", "--device", "cpu"]),
        # one rank on the card: it prints the auto-off line iff its
        # collective launch count is None
        "distributed_retrieval_1_rank": _example_child(
            "distributed_retrieval", ["--ranks", "1"])}
    try:
        return _run_examples(seconds, out, children)
    finally:
        for child in children.values():
            _stop_child(child[0])
        cpu_tmp.cleanup()


def _run_examples(seconds, out, children):
    import shutil

    from repro_torch.kernels.flash_attention import ref as fa_ref
    for name in ("quickstart", "live_ingest", "rag_serve"):
        main = _example(name).main
        card, _, seconds[name] = _example_run(main, [])
        cpu, _, seconds[f"{name}_cpu"] = _example_run(main,
                                                      ["--device", "cpu"])
        check(card == cpu, f"examples: {name} prints other lines on the "
                           f"card: {card} vs {cpu}")
        out[name] = {"lines": len(card)}
    train_mod = _example("train_lm")
    train, lm_cfg = train_mod.main, train_mod.small_lm()
    # a step: each microbatch runs every layer's attention forward
    # twice (the layer's checkpoint runs it again in the backward) and
    # its backward once
    per_step = {"fwd": 2 * TRAIN_LM_MICROBATCHES * lm_cfg.n_layers,
                "bwd": TRAIN_LM_MICROBATCHES * lm_cfg.n_layers}
    train_launches = {}

    def counted(run, argv, n_steps):
        path = PathLaunches()
        fa_ref.reset_call_count()
        got = path.drive(lambda: _example_run(train, argv))
        counts = dict(path.counts, attention_ref=fa_ref.call_count())
        for pass_ in ("fwd", "bwd"):
            check(counts[f"flash_attention_{pass_}"] ==
                  n_steps * per_step[pass_] and
                  counts[f"flash_attention_{pass_}_fp32"] == 0,
                  f"examples: {run}'s {pass_} attention launches {counts}: "
                  f"{per_step[pass_]} a step on the tensor-core route")
        check(counts["attention_ref"] == 0,
              f"examples: {run} ran the plain attention on the card")
        train_launches[run] = counts
        return got

    with _scratch_dir("train_lm_") as tmp:
        ckpt = Path(tmp) / "card"
        steps = ["--steps", str(TRAIN_LM_STEPS), "--ckpt", str(ckpt)]
        lines, full, seconds["train_lm"] = counted(
            "train_lm", steps, TRAIN_LM_STEPS)
        check(full.final_step == TRAIN_LM_STEPS and
              full.losses[-1] < full.losses[0],
              f"examples: train_lm {lines}")
        shutil.rmtree(ckpt / f"step-{TRAIN_LM_STEPS:08d}")
        r_lines, resumed, seconds["train_lm_resume"] = counted(
            "train_lm_resume", steps + ["--resume"],
            TRAIN_LM_STEPS - TRAIN_LM_CKPT)
        check(r_lines[1] == f"resumed from step {TRAIN_LM_CKPT}" and
              resumed.losses == full.losses[TRAIN_LM_CKPT:],
              "examples: the resumed losses differ from the unbroken "
              "run's")
        cpu_lines, seconds["train_lm_cpu"] = _child_lines(
            children["train_lm_cpu"], "train_lm on the CPU")
        check(cpu_lines[0] == lines[0],
              f"examples: train_lm's model line {lines[0]} vs {cpu_lines[0]}")
    t0 = time.perf_counter()
    against_cpu = _train_lm_against_cpu(train_mod)
    fa_case = attention_case(
        8 // TRAIN_LM_MICROBATCHES, lm_cfg.n_heads, lm_cfg.n_kv_heads,
        128, 128, lm_cfg.d_head, True, torch.bfloat16, seed=43,
        timed=True)
    seconds["train_lm_against_cpu"] = time.perf_counter() - t0
    out["train_lm"] = {"model": lines[0], "finished": lines[-1],
                       "loss_first": full.losses[0],
                       "loss_last": full.losses[-1],
                       "median_step_s": statistics.median(full.step_s),
                       "resumed": r_lines[-1],
                       "launches": train_launches,
                       "against_cpu": against_cpu,
                       "attention_case": fa_case}
    dist_main = _example("distributed_retrieval").main
    card, result, seconds["distributed_retrieval"] = _example_run(
        dist_main, ["--ranks", "2"])
    cpu, seconds["distributed_retrieval_cpu"] = _child_lines(
        children["distributed_retrieval_cpu"],
        "distributed_retrieval on the CPU")
    check(card == cpu, f"examples: distributed_retrieval at 2 ranks "
                       f"prints other lines on the card: {card} vs {cpu}")
    # the loop on one rank: its one slot's scan and the merge
    check(result["launches"] == (1, 2),
          f"examples: distributed_retrieval's launches {result}")
    one, seconds["distributed_retrieval_1_rank"] = _child_lines(
        children["distributed_retrieval_1_rank"],
        "distributed_retrieval at 1 rank")
    check(one[-1].startswith("collective query auto-off"),
          f"examples: distributed_retrieval at 1 rank: {one}")
    out["distributed_retrieval"] = {"backend": result["backend"],
                                    "lines": card, "one_rank": one[-1]}
    emit("examples", seconds=seconds, **out)
    return {"launches": train_launches, "attention_case": fa_case}


# ---------------------------------------------------------------------------
# phases 6k-6l: the index lifecycle and the live-serving day
# ---------------------------------------------------------------------------

# burst counts walked under the default profile: at the main path's
# 5000 documents the growth phase queues more documents than its bound
# (1024 pending) at any of them (``_peak_pending_docs``)
LIVE_BURSTS = (2, 4, 8)
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
    """``LiveHarness`` on the streaming-ingest profile at 4 shards with
    the query cache, over the main path's corpus: the seeded schedule's
    ingest bursts, removals, Zipf query batches, a snapshot and restore
    mid-stream and one policy-triggered migration to 8 shards, gated
    inside ``run()`` (old-epoch availability, completion, bitwise parity
    with the synchronous replay of ``committed_ops``)."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT, \
        ERARAG_STREAMING
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving.live_harness import LiveHarness, \
        make_schedule

    t0 = _phase_start()
    cfg = replace(ERARAG_STREAMING, index_shards=LIVE_SHARDS,
                  query_cache=True)
    sched = make_schedule(corpus, seed=0, query_batch=LIVE_QUERY_BATCH,
                          queries_per_phase=4)
    # why the day takes the streaming profile: under the default one the
    # queue would overflow its bound whatever the number of growth bursts
    walk = {"schedule": _peak_pending_docs(sched, ERARAG_DEFAULT),
            **{f"{bursts}_bursts": _peak_pending_docs(make_schedule(
                corpus, seed=0, query_batch=LIVE_QUERY_BATCH,
                queries_per_phase=4, bursts=bursts), ERARAG_DEFAULT)
               for bursts in LIVE_BURSTS}}
    check(min(walk.values()) > ERARAG_DEFAULT.ingest_max_pending_docs,
          f"live_day: {len(corpus.docs)} documents queue at most {walk} "
          f"under the default profile's bound")
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
                  "of minutes)"},
         profile="ERARAG_STREAMING", peak_pending_docs=peak,
         max_pending_docs=cfg.ingest_max_pending_docs,
         default_profile_walk={
             "max_pending_docs": ERARAG_DEFAULT.ingest_max_pending_docs,
             "peak_pending_docs": walk},
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
    base = torch.cuda.memory_allocated()
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
    MEASURED["train_path"] = {"peak": peak, "base": base, "step_s": step_s}
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
# phase 11: the MoE LM family and Adafactor
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 4        # depth cut of deepseek-moe-16b's 28 layers
MOE_TRAIN_LR = 1e-3
MAVERICK_LAYERS = 2         # one [dense, moe] block of maverick's 48
MOE_FWD_SHAPE = (8, 512)    # the bitwise-repeat launch: (b, l)


class RoutingTally:
    """Routed (token, expert) assignments and those that kept a
    capacity slot, by launch kind (``decode``: one token a row of the
    engine's batch), summed on the card from every ``moe_route`` call
    made while it is active."""

    def __init__(self, decode_tokens):
        from repro_torch.models import layers
        self._layers, self._route = layers, layers.moe_route
        self.decode_tokens = decode_tokens
        self.sums = {}

    def __enter__(self):
        route = self._route

        def counted(router, xf, moe):
            r = route(router, xf, moe)
            kind = "decode" if xf.shape[0] == self.decode_tokens \
                else "prefill"
            acc = self.sums.setdefault(kind, torch.zeros(
                2, dtype=torch.int64, device=xf.device))
            acc[0] += r.gate_idx.numel()
            acc[1] += r.live.sum()
            return r

        self._layers.moe_route = counted
        return self

    def __exit__(self, *exc):
        self._layers.moe_route = self._route

    def dropped(self):
        out = {}
        for kind, (routed, kept) in self.sums.items():
            routed, kept = int(routed), int(kept)
            out[kind] = {"routed": routed, "kept": kept,
                         "dropped_share": (routed - kept) / routed}
        return out


def run_moe_serving(rag, corpus):
    """deepseek-moe-16b at all 28 layers in bf16 behind an ``Engine`` of
    8 slots x 4096 positions (random weights, seed 0): 8 prompts as one
    batch, prefill by bucket, decode with 8 live slots, the decode step's
    kernels, the routed assignments capacity dropped; then the LM reader
    through ``run_serving_rag``."""
    from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig

    t0 = _phase_start()
    cfg = deepseek_moe_16b()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "moe_serving: parameter count")
    eng = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW_TOKENS, compute_dtype=torch.bfloat16))
    check(eng.model is model, "moe_serving: the engine copied the model")
    fa_before = (fa_ops.launch_count(), fa_ops.bwd_launch_count())
    _, prompts, lengths = _serve_prompts(eng, corpus, "moe_serving")
    prefill_t, decode_t = _launch_timers(eng)
    log = TokenLog(eng)
    with RoutingTally(SERVE_MAX_BATCH) as tally:
        answers = eng.generate_batch(prompts)
    log.stop(eng)
    check(all(a.startswith("tok") for a in answers),
          "moe_serving: an empty answer")
    check(all(bool(torch.isfinite(x.float()).all())
              for rows in log.rows.values() for x in rows),
          "moe_serving: a logit is not finite")
    check(eng.stats["prefill_launches"] < eng.stats["prefill_prompts"],
          f"moe_serving: prefill launches {eng.stats}")
    per_bucket = _per_bucket(prefill_t.records)
    full = [r for r in decode_t.records
            if r["live_slots"] == SERVE_MAX_BATCH]
    median_decode = statistics.median(r["ms"] for r in full) \
        if full else None
    profile = _decode_profile(model, cfg, eng, 3000)
    kv_bytes = sum(c.numel() * c.element_size() for c in eng.caches.values())
    weight_bytes = _weight_bytes(model)
    bound_ms = (weight_bytes + kv_bytes) / MEM_BYTES_PER_S * 1e3
    live_shares = [(weight_bytes + kv_bytes * (r["length"] + 1) /
                    SERVE_MAX_SEQ) / MEM_BYTES_PER_S * 1e3 / r["ms"]
                   for r in full]
    check(fa_before == (fa_ops.launch_count(), fa_ops.bwd_launch_count()),
          "moe_serving: flash_attention launched on the serving path")
    decode_capacity = moe_capacity(SERVE_MAX_BATCH, cfg.moe)
    emit("moe_serving", model=cfg.name, n_layers=cfg.n_layers,
         params=n_params, compute_dtype="bfloat16", init_s=init_s,
         moe={"n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
              "n_shared": cfg.moe.n_shared,
              "capacity_factor": cfg.moe.capacity_factor},
         engine={"max_batch": SERVE_MAX_BATCH, "max_seq_len": SERVE_MAX_SEQ,
                 "max_new_tokens": SERVE_NEW_TOKENS},
         prompt_tokens=lengths, stats=dict(eng.stats),
         capacity={"decode": decode_capacity,
                   "prefill_by_bucket": {
                       blen: moe_capacity(SERVE_MAX_BATCH * blen, cfg.moe)
                       for blen in per_bucket}},
         routing=tally.dropped(), prefill_per_bucket=per_bucket,
         decode_step_ms_8_live={"median": median_decode, "n": len(full)},
         decode_step_bound_ms=bound_ms,
         decode_step_bound_by="bytes (every expert's bf16 weights, the "
                              "router's fp32, without the embedding "
                              "table, + K/V at max_seq_len)",
         decode_step_bound_share=bound_ms / median_decode
         if median_decode else None,
         decode_step_bound_share_at_live_length={
             "median": statistics.median(live_shares) if live_shares
             else None},
         decode_profile=profile, weight_bytes=weight_bytes,
         kv_cache_bytes=kv_bytes, flash_attention_launches=0,
         **_phase_end(t0))
    del eng, log, prefill_t, decode_t   # the timers' launches hold it
    torch.cuda.empty_cache()
    summ = run_moe_summarizer(model, cfg)
    reader = run_serving_rag(rag, corpus, model, cfg, phase="moe_serving_rag")
    return {k: summ[k] + reader[k] for k in reader}


def run_moe_summarizer(model, cfg):
    """``EraRAG`` with an ``LMSummarizer`` on deepseek-moe-16b, batched
    summaries of 8 tokens, over 8 documents: every summary the engine
    writes is hashed by ``lsh_hash``, each shape held against the plain
    hash."""
    from repro_torch.configs.erarag import ERARAG_DEFAULT
    from repro_torch.core.erarag import EraRAG
    from repro_torch.core.summarize import LMSummarizer
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving import Engine, EngineConfig

    t0 = _phase_start()
    path = PathLaunches(record=True)
    docs = SyntheticCorpus.generate(n_docs=SUMMARY_DOCS, n_topics=8,
                                    seed=0).docs
    eng = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=1024, max_new_tokens=8,
        compute_dtype=torch.bfloat16))
    rag = EraRAG(ERARAG_DEFAULT, HashingEmbedder(dim=256),
                 summarizer=LMSummarizer(eng, max_tokens=8), device="cuda")
    path.drive(lambda: rag.insert_docs(docs))
    summaries = [n.text for n in rag.graph.nodes.values() if n.layer > 0]
    check(summaries and all(t.startswith("tok") for t in summaries),
          "moe_summarizer: no LM summary")
    check(not rag.graph.check_integrity(), "moe_summarizer: graph integrity")
    check(path.counts["lsh_hash"] > 0,
          "moe_summarizer: lsh_hash never launched")
    cases = _path_kernel_cases(path, "moe_summarizer", timed=True)
    emit("moe_summarizer", model=cfg.name, docs=len(docs),
         reduced={"docs": [5000, len(docs)]}, summaries=len(summaries),
         segments=rag.graph.stats["segments_summarized"],
         generate_batches=eng.stats["generate_batches"],
         engine_launches=eng.launches, launches=dict(path.counts),
         kernel_cases=cases, **_phase_end(t0))
    return dict(path.counts)


def run_maverick_block():
    """One [dense, moe] block of llama4-maverick at full width (2 of its
    48 layers) in bf16: ``prefill_padded`` of 4 rows in a 512 bucket,
    then ``decode_step`` at 4 positions; finite logits, times."""
    from repro_torch.configs.llama4_maverick import llama4_maverick
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import moe_capacity

    t0 = _phase_start()
    cfg = replace(llama4_maverick(), n_layers=MAVERICK_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = T.init_params(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "maverick: parameter count")
    check([layer.is_moe for layer in model.layers] == [False, True],
          "maverick: the block is not [dense, moe]")
    lengths = np.array([512, 300, 77, 1], np.int64)
    tokens = torch.randint(4, cfg.vocab_size, (4, 512), generator=gen,
                           device="cuda")
    times = {}
    with torch.inference_mode(), RoutingTally(len(lengths)) as tally:
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = T.prefill_padded(model, tokens, lengths, cfg,
                                          max_len=1024,
                                          compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        times["prefill_ms"] = (time.perf_counter() - t) * 1e3
        check(bool(torch.isfinite(logits.float()).all()),
              "maverick: prefill logits")
        step_ms = []
        tok = logits.argmax(-1)[:, None]
        for pos in range(512, 516):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = T.decode_step(model, tok, caches, pos, cfg,
                                      compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            check(bool(torch.isfinite(logits.float()).all()),
                  f"maverick: decode logits at {pos}")
            tok = logits.argmax(-1)[:, None]
        times["decode_step_ms"] = step_ms
    weight_bytes = _weight_bytes(model)
    emit("moe_maverick_block", model=cfg.name,
         reduced={"n_layers": [48, MAVERICK_LAYERS]}, params=n_params,
         weight_bytes=weight_bytes, compute_dtype="bfloat16",
         init_s=init_s, rows=len(lengths), bucket=512,
         lengths=lengths.tolist(),
         capacity={"prefill": moe_capacity(4 * 512, cfg.moe),
                   "decode": moe_capacity(4, cfg.moe)},
         routing=tally.dropped(), **times,
         decode_step_byte_bound_ms=weight_bytes / MEM_BYTES_PER_S * 1e3,
         **_phase_end(t0))
    del model, caches
    torch.cuda.empty_cache()


def run_moe_reference():
    """Reduced deepseek-moe-16b and llama4-maverick engines (weights
    drawn once on the CPU) on the card and on the CPU in fp32: tokens
    under the margin rule, stats equal, logits within SERVING_REF_TOL;
    then one bf16 ``moe_fwd`` at deepseek's full width twice, bitwise."""
    from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
    from repro_torch.configs.llama4_maverick import llama4_maverick
    from repro_torch.kernels.timing import time_ms
    from repro_torch.models.layers import moe_fwd, moe_init
    from repro_torch.serving.testing import make_test_engine

    t0 = _phase_start()
    prompts = ["alpha beta", "tell me about alpha beta",
               "gamma delta question about the river",
               "a considerably longer question that lands in a larger "
               "padded bucket than the short prompts do, with more words",
               "epsilon zeta words", "eta theta iota kappa lambda mu"]
    engines = {}
    for fn in (deepseek_moe_16b, llama4_maverick):
        red = fn().reduced()
        # the model's fields (its max_seq_len, 128, is the recipe's)
        over = {f: getattr(red, f) for f in (
            "name", "family", "n_layers", "d_model", "n_heads",
            "n_kv_heads", "d_head", "d_ff", "vocab_size", "rope_theta",
            "moe", "moe_every")}
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = make_test_engine(max_batch=6, max_seq_len=64,
                                   device=dev, **over)
            log = TokenLog(eng)
            eng.generate_batch(prompts)
            runs[dev] = (eng, log)
        cmp = margin_rule(runs["cpu"][1], runs["cuda"][1],
                          f"moe_reference {red.name} card vs CPU")
        check(cmp["max_logit_diff"] <= SERVING_REF_TOL,
              f"moe_reference {red.name}: logits differ by "
              f"{cmp['max_logit_diff']}")
        check(runs["cpu"][0].stats == runs["cuda"][0].stats,
              f"moe_reference {red.name}: stats differ")
        engines[red.name] = {"card_vs_cpu": cmp,
                             "stats": runs["cuda"][0].stats}
    cfg = deepseek_moe_16b()
    mod = moe_init(torch.Generator(device="cuda").manual_seed(1),
                   cfg.d_model, cfg.moe, torch.bfloat16)
    p = mod.params(torch.bfloat16)
    x = torch.randn(MOE_FWD_SHAPE + (cfg.d_model,), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2)
                    ).to(torch.bfloat16)
    with torch.inference_mode():
        a, aux_a = moe_fwd(p, x, cfg.moe)
        b, aux_b = moe_fwd(p, x, cfg.moe)
        fwd_ms = time_ms(lambda: moe_fwd(p, x, cfg.moe), reps=5)
    check(torch.equal(a, b) and torch.equal(aux_a, aux_b),
          "moe_reference: two bf16 moe_fwd runs differ")
    check(bool(torch.isfinite(a.float()).all()), "moe_reference: moe_fwd")
    emit("moe_reference", recipe="make_test_engine with each config's "
         "reduced() fields, fp32, weights drawn on the CPU",
         engines=engines, tolerance=SERVING_REF_TOL,
         moe_fwd_bitwise={"model": cfg.name, "shape": list(MOE_FWD_SHAPE),
                          "dtype": "bfloat16", "repeat_equal": True,
                          "ms": fwd_ms},
         **_phase_end(t0))
    del mod, p, x, a, b
    torch.cuda.empty_cache()


def run_moe_train():
    """deepseek-moe-16b at full width, 4 layers, l = 4096: 5 Adafactor
    steps of 2 sequences in 2 microbatches, gradients summed and the
    update run in bf16, on one fixed batch; the attention kernels at its
    shape (hq = hkv = 16, d = 128) against the plain version."""
    from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.optimizer import make_train_step, opt_init

    t0 = _phase_start()
    cfg = replace(deepseek_moe_16b(), n_layers=MOE_TRAIN_LAYERS)
    b, l = TRAIN_SHAPE["b"], cfg.shape("train_4k").seq_len
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "moe_train: parameter count")
    batch = synthetic_lm_batches(cfg.vocab_size, b, l, seed=0)(0)
    n_mb = 2
    step = make_train_step(lambda m, bt: loss_fn(m, bt, cfg),
                           base_lr=MOE_TRAIN_LR, n_microbatches=n_mb,
                           optimizer="adafactor",
                           accum_dtype=torch.bfloat16)
    opt = opt_init(model, "adafactor")
    losses, auxes, step_s = [], [], []

    def run():
        nonlocal model, opt
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)
            auxes.append(float(m["aux"]))

    torch.cuda.reset_peak_memory_stats()
    path = PathLaunches()
    fa_ref.reset_call_count()
    path.drive(run)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(path.counts, attention_ref=fa_ref.call_count())
    del model, opt
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"moe_train: losses {losses}")
    check(losses[-1] < losses[0], f"moe_train: loss did not fall: {losses}")
    for pass_ in ("fwd", "bwd"):
        check(launches[f"flash_attention_{pass_}"] > 0 and
              launches[f"flash_attention_{pass_}_fp32"] == 0,
              f"moe_train: {pass_} launches by route {launches}: the bf16 "
              f"step must run the tensor-core kernels only")
    check(launches["attention_ref"] == 0,
          "moe_train: the plain attention ran on the card")
    # the kernels at the microbatch's shape, held and timed
    case = attention_case(b // n_mb, cfg.n_heads, cfg.n_kv_heads, l, l,
                          cfg.d_head, True, torch.bfloat16, seed=41,
                          timed=True)
    tokens = b * l
    med = statistics.median(step_s[1:])
    MEASURED["moe_train"] = {"peak": peak, "base": base, "step_s": med}
    emit("moe_train", model=cfg.name,
         reduced={"n_layers": [28, MOE_TRAIN_LAYERS]}, params=n_params,
         batch=b, seq_len=l, n_microbatches=n_mb, optimizer="adafactor",
         accum_dtype="bfloat16", base_lr=MOE_TRAIN_LR,
         compute_dtype="bfloat16", steps=TRAIN_STEPS, init_s=init_s,
         losses=losses, aux=auxes, step_s=step_s,
         median_step_s_after_first=med, tokens_per_s=tokens / med,
         steps_max_memory_allocated_bytes=peak, launches=launches,
         attention_case=case, **_phase_end(t0))
    return launches, case


# ---------------------------------------------------------------------------
# phase 12: the RecSys and GNN families, phi3-medium
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("dcn-v2", "deepfm", "dien", "mind")
RECSYS_TABLE_ROWS = {"dcn-v2": 13_130_240, "deepfm": 14_313_216,
                     "dien": 1_000_192, "mind": 1_000_192}
RECSYS_STEPS = 5
# AdamW's rate: the reference's default (``train/loop.py``'s
# ``base_lr``), but 1e-4 for dcn-v2, whose loss swings up at 3e-4 and
# 1e-3 in both packages alike, the more the closer to full size
# (``scripts/recsys_rates.py`` on the CPU: at 300,000 rows a field and
# 32768 rows, 0.6932 -> 0.6952 at 3e-4 and -> 0.7358 at 1e-3 after one
# step), and rose over 5 steps on the H100 at 3e-4
RECSYS_LR = {"dcn-v2": 1e-4, "deepfm": 3e-4, "dien": 3e-4, "mind": 3e-4}
# DIEN's two GRUs save every one of their 100 steps' tensors for the
# backward: 25.8 GB for 32768 rows on the H100
# (``saved_bytes_one_microbatch``), so about 52 GB at b = 65536; it
# runs in 2 microbatches of 32768 (26.9 GB peak), and as the BCE loss is
# a mean over rows the step's gradient is the same.  MIND's in-batch
# softmax keeps one 65536^2 fp32 matrix (17.2 GB) and its backward
# makes two more: a 55.0 GB peak at 1 microbatch, which fits, so MIND's
# negatives stay the whole batch.
RECSYS_MICROBATCHES = {"dcn-v2": 1, "deepfm": 1, "dien": 2, "mind": 1}
# the slab of 1M candidates scored as serve batches: DIEN's 100 stacked
# GRU states are 432 B a row twice over (the steps and their stack):
# 86 GB at 1M rows, so 4 slices of 262,144
RECSYS_SLAB_SLICE = {"dien": 262_144}
RECSYS_CPU_ROWS = 256       # rows of each shape held against the CPU
# card vs CPU, fp32 (the CPU tests' tolerances): outputs within 1e-5 of
# the CPU's largest magnitude (MIND's 0.01-scale table puts its scores
# near 1e-5, and its in-batch loss within about that of ln(rows)), the
# loss within 1e-5 of the larger of 1 and its size, each gradient leaf
# of that loss within 1e-4 relative Frobenius
RECSYS_TOL = 1e-5
RECSYS_GRAD_RTOL = 1e-4
GNN_STEPS = 5
GNN_LR = 1e-3
GNN_TOL = 2e-2              # card vs CPU of the largest |logit|: bf16
# minibatch_lg's host graph (reddit scale: 232,965 nodes) with a tenth
# of its 114,615,892 edges, drawn uniformly: the CSR build (a stable
# argsort) and the draw take seconds, not a minute; 49 in-edges a node
# on average still saturate the (15, 10) fanout
GNN_HOST_EDGES = 114_615_892 // 10
PHI3_TRAIN_LAYERS = 4       # depth cut of phi3-medium's 40 layers


def _recsys_batch(cfg, specs, seed):
    """Inputs of the shapes ``specs`` gives, drawn on the card from a
    seeded generator: ids uniform over each field's vocab (``sparse``)
    or the whole table (``hist``, ``target``, ``candidates``), lengths
    1..S, labels 0/1, dense features N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total = int(sum(cfg.vocab_sizes))
    out = {}
    for key, spec in specs.items():
        shape = tuple(spec.shape)
        if key == "sparse":
            hi = torch.tensor(cfg.vocab_sizes, device="cuda")
            u = torch.rand(shape, generator=gen, device="cuda")
            out[key] = torch.minimum((u * hi).long(), hi - 1).int()
        elif key in ("hist", "target", "candidates"):
            out[key] = torch.randint(0, total, shape, generator=gen,
                                     device="cuda", dtype=torch.int32)
        elif key == "hist_len":
            out[key] = torch.randint(1, cfg.seq_len + 1, shape,
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
        elif key == "labels":
            out[key] = torch.randint(0, 2, shape, generator=gen,
                                     device="cuda").float()
        else:
            out[key] = torch.randn(shape, generator=gen, device="cuda")
    return out


def _rows(batch, n):
    """The first ``n`` rows of every leaf (candidates, one user's slab,
    kept whole)."""
    return {k: v if k == "candidates" else v[:n] for k, v in batch.items()}


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x.detach().cpu()


def _cpu_model(model):
    from repro_torch.models.layers import ParamTree
    return ParamTree(model.tree(lambda p: p.detach().cpu()))


def _max_err(got, want):
    return float((got.double().cpu() - want.double()).abs().max())


def _recsys_serve(name, cfg, api, model, cpu_model, shape):
    """A serve shape on the card: ms a batch, rows/s, and its first
    rows against the CPU; the slab shape also in slices where the
    bytes force them."""
    from repro_torch.kernels.timing import time_ms

    spec = cfg.shape(shape)
    step = api.step_fn(spec)
    batch = _recsys_batch(cfg, api.input_specs(spec), seed=7)
    rows = spec.batch if spec.kind != "retrieval-scoring" or \
        cfg.interaction == "multi-interest" else spec.n_candidates
    sl = RECSYS_SLAB_SLICE.get(name) if rows == spec.n_candidates else None

    def run():
        with torch.inference_mode():
            if not sl:
                return step(model, batch)
            return torch.cat([step(model, {k: v[i:i + sl]
                                           for k, v in batch.items()})
                              for i in range(0, rows, sl)])

    torch.cuda.reset_peak_memory_stats()
    out = run()
    ms = time_ms(run, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    res = {"rows": rows, "ms": ms, "rows_per_s": rows / ms * 1e3,
           "slice_rows": sl, "max_memory_allocated_bytes": peak}
    if isinstance(out, tuple):            # MIND: 1 user x 1M candidates
        vals, ids = out
        with torch.inference_mode():
            cv, ci = step(cpu_model, _to_cpu(batch))
        check(torch.equal(ids.cpu(), ci),
              f"recsys {name} {shape}: top-100 ids differ from the CPU's")
        err, want = _max_err(vals, cv), cv
        cand = batch["candidates"].cpu()
        top = cand[ids[0].cpu()]
        res.update(top_k=int(ids.shape[-1]), ids_equal_cpu=True,
                   max_abs_err=err, distinct_ids_in_top=int(
                       top.unique().numel()),
                   tied_ranks=int((vals[0, 1:] == vals[0, :-1]).sum()))
    else:
        check(out.shape == (rows,) and bool(torch.isfinite(out).all()),
              f"recsys {name} {shape}: output {tuple(out.shape)}")
        n = RECSYS_CPU_ROWS
        with torch.inference_mode():
            want = step(cpu_model, _to_cpu(_rows(batch, n)))
        err = _max_err(out[:n], want)
        res.update(cpu_rows=n, max_abs_err=err)
    scale = float(want.abs().max())
    res.update(cpu_max_abs=scale)
    check(0 < scale and err <= RECSYS_TOL * scale,
          f"recsys {name} {shape}: card vs CPU {err} of {scale}")
    del batch, out
    return res


def _saved_bytes(fn):
    """Bytes of the distinct storages autograd saves for the backward of
    ``fn()``'s output (its forward run once, then dropped).  The hook
    keeps a detached view: an op's own output, packed as itself, would
    hold its graph in a cycle that is never freed."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t.detach()

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())


def _recsys_train(name, cfg, api, model, cpu_model):
    """5 AdamW steps on one fixed train_batch; the loss of its first
    rows and that loss's gradients against the CPU, and whether a
    backward repeats bitwise."""
    from repro_torch.train.optimizer import make_train_step, microbatch, \
        opt_init

    spec = cfg.shape("train_batch")
    loss_of = api.step_fn(spec)
    batch = _recsys_batch(cfg, api.input_specs(spec), seed=3)
    n = RECSYS_CPU_ROWS
    card_loss = loss_of(model, _rows(batch, n))[0]
    cpu_loss = loss_of(cpu_model, _to_cpu(_rows(batch, n)))[0]
    card_loss.backward()
    cpu_loss.backward()
    card_loss, cpu_loss = card_loss.item(), cpu_loss.item()
    loss_err = abs(card_loss - cpu_loss)
    check(loss_err <= RECSYS_TOL * max(1.0, abs(cpu_loss)),
          f"recsys {name} train_batch: card loss {card_loss} vs CPU "
          f"{cpu_loss}")
    grad_err = {k: _rel_fro(a.grad.cpu(), b.grad) for (k, a), b in
                zip(model.named_parameters(), cpu_model.parameters())}
    for p in (*model.parameters(), *cpu_model.parameters()):
        p.grad = None
    check(max(grad_err.values()) <= RECSYS_GRAD_RTOL,
          f"recsys {name} train_batch: gradients vs CPU {grad_err}")
    # the gradient of one microbatch, twice from the same weights
    n_mb = RECSYS_MICROBATCHES[name]
    saved = _saved_bytes(lambda: loss_of(model,
                                         microbatch(batch, 0, n_mb))[0])
    grads = []
    for _ in range(2):
        loss_of(model, microbatch(batch, 0, n_mb))[0].backward()
        grads.append([p.grad for p in model.parameters()])
        for p in model.parameters():
            p.grad = None
    repeat = all(torch.equal(a, b) for a, b in zip(*grads))
    differing = [i for i, (a, b) in enumerate(zip(*grads))
                 if not torch.equal(a, b)]
    del grads
    step = make_train_step(loss_of, base_lr=RECSYS_LR[name],
                           n_microbatches=n_mb)
    opt = opt_init(model)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RECSYS_STEPS):
        t = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    del opt
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"recsys {name} train_batch: losses {losses}")
    names = [k for k, _ in model.named_parameters()]
    return {"rows": spec.batch, "n_microbatches": n_mb,
            "saved_bytes_one_microbatch": saved, "optimizer": "adamw",
            "base_lr": RECSYS_LR[name], "losses": losses, "step_s": step_s,
            "median_step_s_after_first": statistics.median(step_s[1:]),
            "rows_per_s": spec.batch / statistics.median(step_s[1:]),
            "max_memory_allocated_bytes": peak,
            "cpu_rows": n, "loss_vs_cpu_abs_err": loss_err,
            "grad_vs_cpu_rel_fro_err": grad_err,
            "backward_bitwise_repeatable": repeat,
            "grads_differing": [names[i] for i in differing]}


def run_recsys(name):
    """One RecSys architecture at its full config through ``get_api``:
    its 4 shapes on the card, each held against the CPU on its first
    rows (MIND's top-100 over the whole slab)."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models.api import get_api

    t0 = _phase_start()
    base = torch.cuda.memory_allocated()
    cfg = get_arch(name)
    api = get_api(cfg)
    model, _ = api.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table = model["table"]
    check(table.shape[0] == RECSYS_TABLE_ROWS[name],
          f"recsys {name}: table rows {table.shape[0]}")
    cpu_model = _cpu_model(model)
    shapes = {s: _recsys_serve(name, cfg, api, model, cpu_model, s)
              for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    shapes["train_batch"] = _recsys_train(name, cfg, api, model, cpu_model)
    MEASURED[f"{name} train_batch"] = {
        "peak": shapes["train_batch"]["max_memory_allocated_bytes"],
        "base": base,
        "step_s": shapes["train_batch"]["median_step_s_after_first"]}
    MEASURED[f"{name} serve_bulk"] = {
        "peak": shapes["serve_bulk"]["max_memory_allocated_bytes"],
        "base": base, "step_s": shapes["serve_bulk"]["ms"] / 1e3}
    tables = {k: [tuple(p.shape), p.numel() * p.element_size()]
              for k, p in model.named_parameters()
              if k in ("table", "first")}
    emit("recsys", model=name, source=cfg.source, init_s=init_s,
         params=sum(p.numel() for p in model.parameters()),
         param_count_config=cfg.param_count(), tables=tables,
         shapes=shapes, **_phase_end(t0))
    del model, cpu_model
    torch.cuda.empty_cache()


def _gnn_graph(shape, n, e, n_classes, seed):
    """(node_feat, edge_index, labels, label_mask, extra) of one GNN
    shape, padded to (n, e): padding nodes are masked out of the loss,
    padding edges are self-loops on them, one each in turn."""
    from repro_torch.models.gnn import NeighborSampler

    rng = np.random.Generator(np.random.PCG64(seed))
    extra = {}
    if shape.name == "minibatch_lg":
        t = time.perf_counter()
        host = rng.integers(0, shape.n_nodes, size=(2, GNN_HOST_EDGES),
                            dtype=np.int64)
        sampler = NeighborSampler(shape.n_nodes, host, seed=seed)
        del host
        csr_s = time.perf_counter() - t
        t = time.perf_counter()
        seeds = rng.choice(shape.n_nodes, shape.batch_nodes, replace=False)
        nodes, ei, seed_mask = sampler.sample(seeds, shape.fanout)
        extra = {"host_nodes": shape.n_nodes, "host_edges": GNN_HOST_EDGES,
                 "host_edges_published": shape.n_edges,
                 "csr_build_s": csr_s,
                 "sample_s": time.perf_counter() - t,
                 "sampled_nodes": int(len(nodes)),
                 "sampled_edges": int(ei.shape[1])}
        n_real, mask = len(nodes), seed_mask
    elif shape.name == "molecule":
        g, per_n, per_e = shape.graph_batch, shape.n_nodes, shape.n_edges
        local = rng.integers(0, per_n, size=(g, 2, per_e))
        ei = (local + (np.arange(g) * per_n)[:, None, None]
              ).transpose(1, 0, 2).reshape(2, g * per_e)
        n_real, mask = g * per_n, np.ones(g * per_n, dtype=bool)
        extra = {"graphs": g,
                 "graph_ids": np.repeat(np.arange(g), per_n)}
    else:
        n_real = shape.n_nodes
        ei = rng.integers(0, n_real, size=(2, shape.n_edges))
        mask = np.ones(n_real, dtype=bool)
    pad_e = e - ei.shape[1]
    check(n > n_real or pad_e == 0, f"gnn {shape.name}: no padding node")
    pad = n_real + np.arange(pad_e) % max(n - n_real, 1)
    ei = np.concatenate([ei, np.stack([pad, pad])], axis=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feat = torch.randn((n, shape.d_feat), generator=gen, device="cuda")
    labels = torch.randint(0, n_classes, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
    label_mask = np.zeros(n, dtype=bool)
    label_mask[:n_real] = mask
    return (feat, torch.from_numpy(ei.astype(np.int32)).cuda(), labels,
            torch.from_numpy(label_mask).cuda(), extra)


def run_gnn(shape_name):
    """gatedgcn at 16 layers, d = 70, 47 classes, through ``get_api``:
    5 AdamW steps on one shape's padded graph; two forwards bitwise
    equal, the 4-layer checkpoint groups bitwise a run without them;
    ``full_graph_sm`` also against the CPU."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models import gnn
    from repro_torch.models.api import get_api
    from repro_torch.train.optimizer import make_train_step, opt_init

    t0 = _phase_start()
    base = torch.cuda.memory_allocated()
    cfg = get_arch("gatedgcn")
    api = get_api(cfg)
    shape = cfg.shape(shape_name)
    specs = api.input_specs(shape)
    n, df = specs["node_feat"].shape
    e = specs["edge_index"].shape[1]
    feat, ei, labels, mask, extra = _gnn_graph(shape, n, e, cfg.n_classes,
                                               seed=0)
    batch = {"node_feat": feat, "edge_index": ei, "labels": labels,
             "label_mask": mask}
    model, _ = api.init(torch.Generator(device="cuda").manual_seed(0),
                        d_feat=df)
    res = {"nodes": n, "edges": e, "d_feat": df,
           "labelled_nodes": int(mask.sum()),
           **{k: v for k, v in extra.items() if k != "graph_ids"}}
    with torch.no_grad():
        f1 = gnn.forward(model, feat, ei, cfg)
        f2 = gnn.forward(model, feat, ei, cfg)
    check(bool(torch.isfinite(f1).all()) and torch.equal(f1, f2),
          f"gnn {shape_name}: two forwards differ")
    res["forward_bitwise_repeatable"] = True
    if shape_name == "full_graph_sm":
        cpu = _cpu_model(model)
        with torch.no_grad():
            want = gnn.forward(cpu, feat.cpu(), ei.cpu(), cfg)
        err = _max_err(f1, want)
        scale = float(want.abs().max())
        check(err <= GNN_TOL * scale,
              f"gnn {shape_name}: card vs CPU {err} (largest {scale})")
        res["vs_cpu"] = {"max_abs_err": err, "max_abs_logit": scale,
                         "tolerance": GNN_TOL * scale}
        del cpu
    if "graph_ids" in extra:
        with torch.no_grad():
            pooled = gnn.batched_graph_forward(
                model, feat, ei, torch.from_numpy(extra["graph_ids"]).cuda(),
                cfg, extra["graphs"])
        check(pooled.shape == (extra["graphs"], cfg.n_classes) and
              bool(torch.isfinite(pooled).all()),
              f"gnn {shape_name}: graph readout {tuple(pooled.shape)}")
    # checkpointed groups of 4 against no checkpoint: loss and grads
    out = []
    for remat in (4, 0):
        torch.cuda.reset_peak_memory_stats()
        loss, _ = gnn.loss_fn(model, batch, cfg, remat_group=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()],
                    torch.cuda.max_memory_allocated()))
        for p in model.parameters():
            p.grad = None
    check(torch.equal(out[0][0], out[1][0]) and
          all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1])),
          f"gnn {shape_name}: checkpointed groups differ from none")
    res["checkpoint_groups_bitwise"] = True
    res["max_memory_allocated_bytes_remat"] = {"4": out[0][2],
                                               "none": out[1][2]}
    del out
    step = make_train_step(api.step_fn(shape), base_lr=GNN_LR)
    opt = opt_init(model)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(GNN_STEPS):
        t = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gnn {shape_name}: losses {losses}")
    res.update(losses=losses, step_s=step_s,
               median_step_s_after_first=statistics.median(step_s[1:]),
               steps_max_memory_allocated_bytes=
               torch.cuda.max_memory_allocated())
    MEASURED[f"gatedgcn {shape_name}"] = {
        "peak": res["steps_max_memory_allocated_bytes"], "base": base,
        "step_s": res["median_step_s_after_first"]}
    emit("gnn", model="gatedgcn", shape=shape_name, n_layers=cfg.n_layers,
         d_hidden=cfg.d_hidden, n_classes=cfg.n_classes,
         params=sum(p.numel() for p in model.parameters()),
         optimizer="adamw", base_lr=GNN_LR, **res, **_phase_end(t0))
    del model, opt, batch
    torch.cuda.empty_cache()


def run_phi3_serving(corpus):
    """phi3-medium-14b at all 40 layers, bf16, random weights from a
    seeded generator, behind an ``Engine`` of 8 slots x 4096 positions:
    the 8 serving prompts as one batch, 16 new tokens each."""
    from repro_torch.common.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, EngineConfig

    t0 = _phase_start()
    cfg = get_arch("phi3-medium-14b")
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "phi3_serving: parameter count")
    eng = Engine(cfg, model, EngineConfig(
        max_batch=SERVE_MAX_BATCH, max_seq_len=SERVE_MAX_SEQ,
        max_new_tokens=16, compute_dtype=torch.bfloat16))
    fa_before = (fa_ops.launch_count(), fa_ops.bwd_launch_count())
    _, prompts, lengths = _serve_prompts(eng, corpus, "phi3_serving")
    prefill_t, decode_t = _launch_timers(eng)
    before = dict(eng.stats)
    answers = eng.generate_batch(prompts)
    stats = {k: eng.stats[k] - before[k] for k in before}
    check(len(answers) == len(prompts) and
          stats["prefill_launches"] < stats["prefill_prompts"],
          f"phi3_serving: stats {stats}")
    # decode at position n against prefill of the n + 1 tokens
    ids = eng.tok.encode(prompts[3], add_special=True)[:301]
    ids = torch.from_numpy(ids.astype(np.int64))[None].cuda()
    with torch.inference_mode():
        _, cache = T.prefill(model, ids[:, :300], cfg, max_len=301,
                             compute_dtype=torch.bfloat16)
        dec, _ = T.decode_step(model, ids[:, 300:], cache, 300, cfg,
                               compute_dtype=torch.bfloat16)
        ref, _ = T.prefill(model, ids, cfg, compute_dtype=torch.bfloat16)
    del cache
    dec_diff = float((dec.float() - ref.float()).abs().max())
    dec_scale = float(ref.float().abs().max())
    check(bool(torch.isfinite(dec.float()).all()) and
          dec_diff <= DECODE_REL_TOL * dec_scale,
          f"phi3_serving: decode vs prefill differ by {dec_diff} "
          f"(largest |logit| {dec_scale})")
    profile = _decode_profile(model, cfg, eng, 3000)
    kv_bytes = sum(c.numel() * c.element_size() for c in eng.caches.values())
    weight_bytes = _weight_bytes(model)
    bound_ms = (weight_bytes + kv_bytes) / MEM_BYTES_PER_S * 1e3
    full = [r["ms"] for r in decode_t.records
            if r["live_slots"] == SERVE_MAX_BATCH]
    check(bool(full), "phi3_serving: no decode step with 8 live slots")
    check(fa_before == (fa_ops.launch_count(), fa_ops.bwd_launch_count()),
          "phi3_serving: flash_attention launched on the serving path")
    median_decode = statistics.median(full)
    emit("phi3_serving", model=cfg.name, n_layers=cfg.n_layers,
         params=n_params, weight_bytes_bf16=sum(
             p.numel() * p.element_size() for p in model.parameters()),
         compute_dtype="bfloat16", init_s=init_s,
         engine={"max_batch": SERVE_MAX_BATCH, "max_seq_len": SERVE_MAX_SEQ,
                 "max_new_tokens": 16},
         prompt_tokens=lengths, stats=stats,
         prefill_per_bucket=_per_bucket(prefill_t.records),
         decode_step_ms_8_live={"median": median_decode, "n": len(full)},
         decode_step_bound_ms=bound_ms,
         decode_step_bound_by="bytes (bf16 weights without the embedding "
                              "table + K/V at max_seq_len)",
         decode_step_bound_share=bound_ms / median_decode,
         decode_vs_prefill={"position": 300, "max_abs_diff": dec_diff,
                            "max_abs_logit": dec_scale,
                            "tolerance": DECODE_REL_TOL * dec_scale},
         decode_profile=profile, kv_cache_bytes=kv_bytes,
         flash_attention_launches=0, **_phase_end(t0))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


def run_phi3_train():
    """phi3-medium-14b at full width, 4 layers, l = 4096: 5 AdamW steps
    of 2 sequences in 2 microbatches, bf16 compute, on one fixed batch;
    the attention kernels at its shape (hq = 40, hkv = 10, d = 128)
    against the plain version, timed."""
    from repro_torch.common.registry import get_arch
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.optimizer import make_train_step, opt_init

    t0 = _phase_start()
    cfg = replace(get_arch("phi3-medium-14b"), n_layers=PHI3_TRAIN_LAYERS)
    b, l = TRAIN_SHAPE["b"], cfg.shape("train_4k").seq_len
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "phi3_train: parameter count")
    batch = synthetic_lm_batches(cfg.vocab_size, b, l, seed=0)(0)
    n_mb = 2
    step = make_train_step(lambda m, bt: loss_fn(m, bt, cfg),
                           n_microbatches=n_mb)
    opt = opt_init(model)
    losses, step_s = [], []

    def run():
        nonlocal model, opt
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    path = PathLaunches()
    fa_ref.reset_call_count()
    path.drive(run)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(path.counts, attention_ref=fa_ref.call_count())
    del model, opt
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phi3_train: losses {losses}")
    for pass_ in ("fwd", "bwd"):
        check(launches[f"flash_attention_{pass_}"] > 0 and
              launches[f"flash_attention_{pass_}_fp32"] == 0,
              f"phi3_train: {pass_} launches by route {launches}: the bf16 "
              f"step must run the tensor-core kernels only")
    check(launches["attention_ref"] == 0,
          "phi3_train: the plain attention ran on the card")
    case = attention_case(b // n_mb, cfg.n_heads, cfg.n_kv_heads, l, l,
                          cfg.d_head, True, torch.bfloat16, seed=43,
                          timed=True)
    med = statistics.median(step_s[1:])
    MEASURED["phi3_train"] = {"peak": peak, "base": base, "step_s": med}
    tokens = b * l
    pairs = l * (l + 1) // 2
    model_flop = 3.0 * (2.0 * _matmul_params(cfg) * tokens +
                        4.0 * b * cfg.n_heads * cfg.d_head * pairs *
                        cfg.n_layers)
    emit("phi3_train", model=cfg.name,
         reduced={"n_layers": [40, PHI3_TRAIN_LAYERS]}, params=n_params,
         param_bytes_fp32_with_grads_and_moments=16 * n_params,
         batch=b, seq_len=l, n_microbatches=n_mb, optimizer="adamw",
         compute_dtype="bfloat16", steps=TRAIN_STEPS, init_s=init_s,
         losses=losses, step_s=step_s, median_step_s_after_first=med,
         tokens_per_s=tokens / med, model_flop_per_s=model_flop / med,
         steps_max_memory_allocated_bytes=peak, launches=launches,
         attention_case=case, **_phase_end(t0))
    return launches, case


def run_new_families(corpus):
    """The RecSys and GNN families and phi3-medium (phase 12), the
    kernels' counters read around each: only ``phi3_train`` launches
    one (``flash_attention``)."""
    families = PathLaunches()
    gc.collect()
    torch.cuda.empty_cache()
    emit("families_start",
         memory_allocated_bytes=torch.cuda.memory_allocated())
    for name in RECSYS_ARCHS:
        families.drive(lambda: run_recsys(name))
    for shape in ("full_graph_sm", "molecule", "minibatch_lg"):
        families.drive(lambda: run_gnn(shape))
    families.drive(lambda: run_phi3_serving(corpus))
    check(not any(families.counts.values()),
          f"recsys, gnn and phi3_serving launched {families.counts}: none "
          f"of them runs a kernel of the port")
    return run_phi3_train()


# ---------------------------------------------------------------------------

# the dry run's predicted peak over the phase's max_memory_allocated
DRYRUN_PEAK_BAND = (0.75, 1.33)


def _dryrun_setups():
    """(label, arch, shape name, config, policy) of each setup, at the
    phases' exact configs."""
    from repro_torch.common.registry import get_arch

    def cut(arch, layers):
        cfg = get_arch(arch)
        train = replace(cfg.shape("train_4k"), global_batch=TRAIN_SHAPE["b"])
        return replace(cfg, n_layers=layers, shapes=(train,))

    out = [("train_path", "llama3-8b", "train_4k",
            cut("llama3-8b", TRAIN_LAYERS), {"n_microbatches": 2}),
           # Adafactor with bf16 accumulation, as the phase trains
           ("moe_train", "deepseek-moe-16b", "train_4k",
            cut("deepseek-moe-16b", MOE_TRAIN_LAYERS),
            {"n_microbatches": 2, "optimizer": "adafactor",
             "accum_dtype": torch.bfloat16}),
           # GQA groups of 4 (40 query heads over 10)
           ("phi3_train", "phi3-medium-14b", "train_4k",
            cut("phi3-medium-14b", PHI3_TRAIN_LAYERS),
            {"n_microbatches": 2})]
    for name in ("dcn-v2", "deepfm"):
        out.append((f"{name} train_batch", name, "train_batch",
                    get_arch(name),
                    {"n_microbatches": RECSYS_MICROBATCHES[name]}))
    out.append(("deepfm serve_bulk", "deepfm", "serve_bulk",
                get_arch("deepfm"), {"param_dtype": torch.float32}))
    out.append(("gatedgcn full_graph_sm", "gatedgcn", "full_graph_sm",
                get_arch("gatedgcn"), None))
    return out


def dryrun_child() -> int:
    """The dry runs of ``_dryrun_setups`` on a (1, 1) mesh, on fake
    tensors (no card): one JSON line, label -> result."""
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401
    from repro_torch.common.sharding import MeshShape
    from repro_torch.launch.dryrun import lower_cell

    one = MeshShape((1, 1), ("data", "model"))
    out = {}
    for label, arch, shape, cfg, policy in _dryrun_setups():
        out[label] = lower_cell(arch, shape, cfg=cfg, mesh_sizes=one,
                                whole_depth=True, policy=policy)
    print(json.dumps(out, default=str), flush=True)
    return 0


def start_dryrun():
    """The dry-run child, started with the script: it runs on the host
    alone (fake tensors), beside the phases on the card."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-child"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def run_dryrun(child):
    """The dry run's predictions (``child``, from ``start_dryrun``)
    against the setups' measured peaks and steps (see the module
    docstring)."""
    t0 = _phase_start()
    try:
        out, err = child.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        _stop_child(child)
        raise
    check(child.returncode == 0,
          f"dryrun: the child failed:\n{err[-4000:]}")
    results = json.loads(out.strip().splitlines()[-1])
    lo, hi = DRYRUN_PEAK_BAND
    for label, *_ in _dryrun_setups():
        res, got = results[label], MEASURED[label]
        terms = res["roofline"]
        bound_s = max(terms["t_compute_s"], terms["t_memory_s"],
                      terms["t_collective_s"])
        # what the setup's own step held: the peak less what other
        # phases left allocated (cuBLAS workspaces, caches) before the
        # setup made its weights
        step_peak = got["peak"] - got["base"]
        ratio = res["memory"]["peak_bytes"] / step_peak
        emit("dryrun", setup=label, mesh=res["mesh"],
             n_microbatches=res["n_microbatches"],
             predicted_peak_bytes=res["memory"]["peak_bytes"],
             predicted_argument_bytes=res["memory"]["argument_bytes"],
             max_memory_allocated_bytes=got["peak"],
             allocated_before_setup_bytes=got["base"],
             step_peak_bytes=step_peak,
             peak_ratio=ratio, peak_band=list(DRYRUN_PEAK_BAND),
             roofline=terms, bound_s=bound_s, step_s=got["step_s"],
             roofline_share=bound_s / got["step_s"],
             flops_by_dtype=res["flops_by_dtype"],
             flops=res["flops_per_device"],
             hbm_bytes=res["hbm_bytes_per_device"],
             replicated_ops=res["replicated_ops"],
             dryrun_s=res["seconds"])
        check(lo <= ratio <= hi,
              f"dryrun {label}: predicted peak {res['memory']['peak_bytes']}"
              f" over measured {step_peak} = {ratio}, outside {lo}-{hi}")
    # seconds: the wait for the child after the last setup's phase
    emit("dryrun_total", setups=len(results), **_phase_end(t0))


class Timeline:
    """Wall seconds of each step of ``main``, printed as the
    ``timeline`` phase before the kernels' line."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, name):
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now

    def emit(self):
        emit("timeline", seconds=self.seconds,
             total_s=time.perf_counter() - self.t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    child = start_dryrun()
    try:
        return _main(child)
    finally:
        _stop_child(child)


def _main(dryrun) -> int:
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels.common import build_kernels
    from repro_torch.kernels.timing import card

    tl = Timeline()
    smi = card()
    print(smi, flush=True)
    # one nvcc a source, all started together: the main path's two
    # kernels waited for, the quantized path's and attention's built
    # beside the main path and joined after it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        later = pool.submit(build_kernels, ["hamming_topk", "flash_attention"],
                            force=True)
        builds = build_kernels(["lsh_hash", "mips_topk"], force=True)
        first_wall_s = time.perf_counter() - t0
        tl.lap("device")

        corpus, rag, questions, n_init, launches = run_main_path()
        tl.lap("main_path")
        builds.update(later.result())
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=builds,
         build_wall_s={"lsh_hash, mips_topk": first_wall_s,
                       "all": time.perf_counter() - t0})
    tl.lap("device")
    run_reference_check()
    tl.lap("reference")
    lsh_main, lsh_deploy, lsh_wide, lsh_growth = run_lsh(rag, n_init)
    tl.lap("lsh_hash")
    mips_main, mips_deploy, mips_b1 = run_mips(rag, questions)
    tl.lap("mips_topk")
    rag_q, q_launches = run_quantized_path(corpus, rag, questions)
    tl.lap("quantized_path")
    run_reference_check(quantized_scan=True)
    tl.lap("reference")
    lsh_quant, ham_main, res_main, quant_c32, quant_deploy = run_hamming(
        rag_q, questions)
    tl.lap("hamming_topk")
    sh_launches, sh_q_launches = run_sharded_path(corpus, rag, rag_q,
                                                  questions)
    tl.lap("sharded_path")
    life_launches = run_lifecycle(corpus, rag_q, questions)
    tl.lap("lifecycle")
    del rag_q
    base_path = PathLaunches()
    b1_scan = run_baselines(corpus, base_path)
    base_launches = dict(base_path.counts)
    for name in ("lsh_hash", "mips_topk"):
        check(base_launches[name] > 0,
              f"{name} never launched on the baselines path")
    tl.lap("baselines")
    qc_launches = run_query_cache(corpus, rag, questions, PathLaunches())
    check(qc_launches["mips_topk"] > 0,
          "mips_topk never launched on the query cache path")
    tl.lap("query_cache")
    pipe, ingest_launches, per_embed_tick = run_ingest(rag, questions,
                                                       PathLaunches())
    run_index_report(pipe)
    del pipe
    tl.lap("ingest")
    live_launches = run_live_day(corpus)
    torch.cuda.empty_cache()
    tl.lap("live_day")
    run_serving_reference()
    model, lm_cfg = run_serving_engine(corpus)
    tl.lap("serving_engine")
    rag_launches = run_serving_rag(rag, corpus, model, lm_cfg)
    tl.lap("serving_rag")
    sum_launches = run_serving_summarizer(model, lm_cfg)
    serving_launches = {k: rag_launches[k] + sum_launches[k]
                        for k in rag_launches}
    del model
    torch.cuda.empty_cache()
    tl.lap("serving_summarizer")
    moe_rag_launches = run_moe_serving(rag, corpus)
    del rag
    gc.collect()
    torch.cuda.empty_cache()
    tl.lap("moe_serving")
    run_maverick_block()
    sh_deploy = run_sharded_deploy()
    tl.lap("sharded_2_22")
    coll = run_collective()
    tl.lap("collective")
    ex = run_examples()
    tl.lap("examples")
    run_reference_check(index_shards=4)
    run_reference_check(quantized_scan=True, index_shards=4)
    tl.lap("reference")
    fa_main = run_flash_attention()
    tl.lap("flash_attention")
    train_launches = run_train_path()
    fp32_launches = run_train_reference()
    resume_launches = run_train_resume()
    tl.lap("train")
    moe_ref_path = PathLaunches()
    moe_ref_path.drive(run_moe_reference)
    moe_train_launches, moe_fa_case = run_moe_train()
    tl.lap("moe_train")
    phi3_launches, phi3_fa_case = run_new_families(corpus)
    tl.lap("families")
    run_dryrun(dryrun)
    tl.lap("dryrun")
    tl.emit()

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
        """The launches of the lifecycle, live-day, train_resume, MoE and
        phi3_train phases and of the train_lm example's card runs (the
        120 steps and the resume), each read by its ``PathLaunches``
        (``moe_serving``: the MoE summarizer's and LM reader's runs; its
        engine and maverick runs launch none of these kernels, checked
        for attention)."""
        return {"live": {"launches": live_launches[name]},
                "lifecycle": {"launches": life_launches[name]},
                "train_resume": {"launches": resume_launches[name]},
                "moe_serving": {"launches": moe_rag_launches[name]},
                "moe_reference": {"launches": moe_ref_path.counts[name]},
                "moe_train": {"launches": moe_train_launches[name]},
                "phi3_train": {"launches": phi3_launches[name]},
                "examples_train_lm": {
                    "launches": ex["launches"]["train_lm"][name],
                    "resume_launches":
                        ex["launches"]["train_lm_resume"][name]}}

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

    def train_fa(case, pass_):
        """A training shape's case (``moe_train``: hq = hkv = 16;
        ``phi3_train``: hq = 40, hkv = 10; the train_lm example: b = 4,
        hq = 8, hkv = 4, l = 128, d = 64), held and timed there."""
        t = case["timing"]
        return {"shape": case["shape"],
                "max_abs_err": case["out_max_abs_err"]
                if pass_ == "fwd" else case["grad_max_abs_err"],
                **{k: t[f"{pass_}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "tflop_per_s", "bound_share")}}

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
                      "merge_device_ms", "bitwise_equal_flat")},
              # two ranks on the card, 2 of the 4 slots each: the
              # store-level collective's launches (both ranks), and each
              # rank's call at 2^22
              collective={"launches": coll["launches"]["mips_topk"],
                          "at_2_22_by_rank": coll["by_rank"]}),
        # main path and at_2_22_c32: the list route (C = 32); at_2_22:
        # the counting route (C = 4096)
        entry("hamming_topk", "src/repro/kernels/hamming_topk/kernel.py:57",
              ham_main, quant_deploy["hamming_topk"],
              q_launches["hamming_topk"], extra=ham_keys,
              at_2_22_c32={k: quant_c32["hamming_topk"][k]
                           for k in keys + ham_keys},
              at_2_22_c32_b1={k: quant_c32["hamming_topk"]["b1"][k]
                              for k in keys + ham_keys},
              sharded_path={"launches": sh_q_launches["hamming_topk"]},
              collective={"launches": coll["launches"]["hamming_topk"]}),
        # the exact rescore, XLA (not Pallas) in the JAX package; main
        # path and at_2_22_c32: C = 32, at_2_22: C = 4096
        entry("mips_rescore", "src/repro/kernels/quantized_scan/ops.py:229",
              res_main, quant_deploy["mips_rescore"],
              q_launches["mips_rescore"],
              source="src/repro_torch/csrc/mips_topk.cu",
              extra=rescore_keys,
              at_2_22_c32={k: quant_c32["mips_rescore"][k]
                           for k in keys + rescore_keys},
              sharded_path={"launches": sh_q_launches["mips_rescore"]},
              collective={"launches": coll["launches"]["mips_rescore"]}),
        # launches: the bf16 training path's (5 steps), on the tensor
        # cores; the fp32 FMA kernels' from train_reference's card steps
        *(dict(fa_entry(fa_main[torch.bfloat16], train_launches, pass_),
               moe_train_shape=train_fa(moe_fa_case, pass_),
               phi3_train_shape=train_fa(phi3_fa_case, pass_),
               train_lm_example_shape=train_fa(ex["attention_case"],
                                               pass_))
          for pass_ in ("fwd", "bwd")),
        *(fa_entry(fa_main[torch.float32], fp32_launches, pass_, "_fp32")
          for pass_ in ("fwd", "bwd")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dryrun-child"]:
        sys.exit(dryrun_child())
    sys.exit(main())
