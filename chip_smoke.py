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
                 groups of 64 hyperplanes) and at n = 2^22 rows.
4. ``mips_topk`` ``flagged_mips_topk`` through the kernel against its
                 plain version at the main path's shape (the real store
                 buffer) and at n = 2^22 rows x (256 + 3), b = 64, k = 8;
                 b = 1 against b = 64 must agree bitwise.
5. ``quantized_path`` the same corpus, build, growth rounds and questions
                 through ``EraRAG`` with ``quantized_scan=True``, the
                 counters set to 0 just before and read just after:
                 ``lsh_hash``, ``hamming_topk`` and ``mips_rescore`` must
                 have launched.  The graph must equal the exact path's;
                 every returned score must be bitwise the exact kernel's
                 for its row; with C = capacity the hits must be bitwise
                 the exact path's; b = 1 must equal b = 64; no tombstoned
                 row may return after ``remove_docs``.  Recall@8 against
                 the exact path and batches/s are reported, not checked.
                 The ``reference`` phase runs again with the quantized
                 scan.
6. ``hamming_topk`` first ``lsh_hash`` at the quantized path's shape
                 (the store's rows, k = 64) against its plain version,
                 and the store's code plane and the query codes against
                 the plain hash plus the flag groups.  Then the kernel
                 against its plain version, bitwise, at the
                 main path's shape (the quantized store's codes, b = 64,
                 C = 32) and at n = 2^22 rows x 11 words (real codes of
                 random rows, duplicated rows planted), C = 32 and 4096;
                 the gathered-rows rescore (``mips_rescore``) against its
                 plain version and the exact kernel at the same shapes;
                 the whole two-stage scan beside the exact scan at the
                 main path's shape and at 2^22.
7. ``kernels``   one line listing every kernel with its numbers.

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


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def run_reference_check(quantized_scan: bool = False):
    """The quickstart configuration on the card against the same code
    on the CPU (plain versions, which the CPU tests hold against the
    JAX package): same graph, hits, contexts and answers.  With
    ``quantized_scan`` both run the two-stage quantized scan."""
    from repro_torch.common.config import EraRAGConfig
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving.rag_pipeline import RAGPipeline

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                       max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024, quantized_scan=quantized_scan)
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
    emit("reference",
         config="quickstart" + ("_quantized" if quantized_scan else ""),
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


def lsh_case(v, h, label):
    from repro_torch.kernels.lsh_hash import ops
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref

    n, d = v.shape
    k = h.shape[1]

    def plain():   # its zero-padded bits beyond k are already 0
        return lsh_hash_ref(v, h)

    got = ops.lsh_hash(v, h)
    want = plain()
    torch.cuda.synchronize()
    n_flipped, max_flip_proj = lsh_flips(got, want, v, h, label)
    ms = time_ms(lambda: ops.lsh_hash(v, h))
    plain_ms = time_ms(plain, reps=5)
    n_words = -(-k // 32)
    bound_ms, bound_by = bound(4.0 * (n * d + d * k + n * n_words),
                               2.0 * n * d * k)
    return {"shape": {"n": n, "d": d, "k": k}, "bits_flipped": n_flipped,
            "flip_band": LSH_FLIP_BAND, "max_abs_err": max_flip_proj,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def run_lsh(rag, n_init):
    # the main path's largest call: the initial build's chunk batch
    leaves = [nd.embedding for nd in rag.graph.nodes.values()
              if nd.layer == 0][:n_init]
    v = torch.from_numpy(np.stack(leaves)).cuda()
    h = torch.from_numpy(rag.graph.lsh.hyperplanes).cuda()
    main = lsh_case(v, h, "main path")
    # the same rows under 128 hyperplanes: two groups of 64 (a quantized
    # store with scan_bits=128)
    gen = torch.Generator(device="cuda").manual_seed(4)
    h128 = torch.randn(h.shape[0], 128, device="cuda", generator=gen)
    wide = lsh_case(v, h128, "k=128")
    del v
    gen = torch.Generator(device="cuda").manual_seed(1)
    v = torch.randn(N_DEPLOY, h.shape[0], device="cuda", generator=gen)
    v[0] = 0.0   # the embedder's empty-text row: every bit set
    deploy = lsh_case(v, h, "2^22")
    del v
    torch.cuda.empty_cache()
    emit("lsh_hash", main_path=main, k_128=wide, at_2_22=deploy)
    return main, deploy


# ---------------------------------------------------------------------------
# phase 4: mips_topk
# ---------------------------------------------------------------------------

def mips_case(q, db, k, bias, label):
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_topk_ref

    b = q.shape[0]
    n, d = db.shape          # d counts the flag columns: the kernel's width
    q_aug = ops.augment_queries(q, bias).contiguous()
    vals, idx = ops.flagged_mips_topk(q, db, k, bias)
    # plain: one more candidate, to see near-ties at the k boundary
    pv, pi = mips_topk_ref(q_aug, db, min(k + 1, n))
    torch.cuda.synchronize()
    max_err = float((vals - pv[:, :k]).abs().max())
    check(max_err <= SCORE_TOL,
          f"mips_topk {label}: score error {max_err} > {SCORE_TOL}")
    # ids may differ only where a plain neighbour score lies within
    # the tolerance (a near-tie the two summation orders may swap)
    near = torch.zeros_like(pv, dtype=torch.bool)
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= SCORE_TOL
    near[:, 1:] |= close
    near[:, :-1] |= close
    bad = (idx != pi[:, :k]) & ~near[:, :k]
    check(not bool(bad.any()),
          f"mips_topk {label}: {int(bad.sum())} ids differ away from "
          f"near-ties")
    id_diffs = int((idx != pi[:, :k]).sum())
    # batch invariance: each query alone gives the batch's row bitwise
    for j in range(b):
        v1, i1 = ops.flagged_mips_topk(q[j:j + 1].contiguous(), db, k,
                                       bias)
        check(torch.equal(v1, vals[j:j + 1]) and
              torch.equal(i1, idx[j:j + 1]),
              f"mips_topk {label}: b=1 differs from b={b} at row {j}")
    # kernel, plain and library all start from the same augmented
    # queries; the flagged wrapper (augmentation included) is its own
    # number
    ms = time_ms(lambda: ops.mips_topk(q_aug, db, k))
    wrapper_ms = time_ms(lambda: ops.flagged_mips_topk(q, db, k, bias))
    plain_ms = time_ms(lambda: mips_topk_ref(q_aug, db, k), reps=5)
    library_ms = time_ms(lambda: torch.topk(q_aug @ db.T, k),
                         reps=5)
    bound_ms, bound_by = bound(4.0 * (n * d + b * d) + 8.0 * b * k,
                               2.0 * b * n * d)
    return {"shape": {"b": b, "n": n, "d": d, "k": k},
            "max_abs_err": max_err, "tolerance": SCORE_TOL,
            "ids_differing_at_near_ties": id_diffs,
            "batch_invariant": True, "kernel_ms": ms,
            "flagged_wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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
    del db
    torch.cuda.empty_cache()
    emit("mips_topk", main_path=main, at_2_22=deploy)
    return main, deploy["collapsed"]


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

    for name in ("lsh_hash", "hamming_topk", "mips_rescore"):
        check(launches[name] > 0,
              f"{name} kernel never launched on the quantized path")
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
         launches=launches, graph_equal=True,
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

    b, w = qc.shape
    n = dbc.shape[0]
    dist, idx = ops.hamming_topk(qc, dbc, c)
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
    return {"shape": {"b": b, "n": n, "w": w, "C": c},
            "max_abs_err": int((dist - pd).abs().max()),
            "bitwise_equal": True, "equal_distance_neighbours": ties,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, idx


def rescore_case(q_aug, db, cand, k, label):
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.mips_topk.ref import mips_rescore_ref

    b, d = q_aug.shape
    c = cand.shape[1]
    vals, idx = ops.mips_rescore(q_aug, db, cand, k)
    pv, pi = mips_rescore_ref(q_aug, db, cand, min(k + 1, c))
    torch.cuda.synchronize()
    max_err = float((vals - pv[:, :k]).abs().max())
    check(max_err <= SCORE_TOL,
          f"mips_rescore {label}: score error {max_err} > {SCORE_TOL}")
    near = torch.zeros_like(pv, dtype=torch.bool)
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= SCORE_TOL
    near[:, 1:] |= close
    near[:, :-1] |= close
    bad = (idx != pi[:, :k]) & ~near[:, :k]
    check(not bool(bad.any()),
          f"mips_rescore {label}: {int(bad.sum())} ids differ away from "
          f"near-ties")
    # each returned score is bitwise the exact kernel's for its row
    for j in range(b):
        rows = torch.sort(idx[j].long()).values
        ev, ei = ops.mips_topk(q_aug[j:j + 1].contiguous(),
                               db[rows].contiguous(), k)
        check(torch.equal(ev[0], vals[j]) and
              torch.equal(rows[ei[0].long()], idx[j].long()),
              f"mips_rescore {label}: query {j}'s scores are not the "
              f"exact kernel's")
    ms = time_ms(lambda: ops.mips_rescore(q_aug, db, cand, k))
    plain_ms = time_ms(lambda: mips_rescore_ref(q_aug, db, cand, k),
                       reps=5)
    rows_read = int(torch.unique(cand).numel())
    bound_ms, bound_by = bound(
        4.0 * (rows_read * d + b * d + b * c) + 8.0 * b * k,
        2.0 * b * c * d)
    return {"shape": {"b": b, "C": c, "d": d, "k": k,
                      "distinct_rows": rows_read},
            "max_abs_err": max_err, "tolerance": SCORE_TOL,
            "ids_differing_at_near_ties": int((idx != pi[:, :k]).sum()),
            "scores_bitwise_exact_kernel": True, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def run_hamming(rag_q, questions):
    from repro_torch.core.store import _filter_bias
    from repro_torch.kernels.mips_topk import ops as mips_ops
    from repro_torch.kernels.quantized_scan import ops as quant_ops

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
    ham_main, cand = hamming_case(qc, grp.codes, c_main, "main path",
                                  rate)
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
        ham, cand = hamming_case(qcd, codes, c, f"2^22 C={c}", rate)
        check(cand[0, :5].tolist() == list(range(999, 1004)),
              f"hamming_topk 2^22 C={c}: planted duplicates out of order")
        deploy[c] = {"hamming_topk": ham,
                     "mips_rescore": rescore_case(qd_aug, db, cand, k,
                                                  f"2^22 C={c}")}
        deploy[c]["two_stage_ms"] = time_ms(
            lambda: quant_ops.quantized_flagged_topk(
                qd, db, codes, k, c, bias, planes, spec))
    deploy["exact_flagged_mips_topk_ms"] = time_ms(
        lambda: mips_ops.flagged_mips_topk(qd, db, k, bias))
    del db, codes
    torch.cuda.empty_cache()
    emit("hamming_topk", popc_per_s=rate,
         main_path={"lsh_hash_quantized": lsh_main,
                    "hamming_topk": ham_main, "mips_rescore": res_main,
                    **scan_main},
         at_2_22={f"C={c}": v for c, v in deploy.items()
                  if isinstance(c, int)},
         exact_flagged_mips_topk_ms_at_2_22=deploy[
             "exact_flagged_mips_topk_ms"])
    return lsh_main, ham_main, res_main, deploy[4096]


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = build_kernels(["lsh_hash", "mips_topk", "hamming_topk"],
                           force=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=builds,
         build_wall_s=time.perf_counter() - t0)

    corpus, rag, questions, n_init, launches = run_main_path()
    run_reference_check()
    lsh_main, lsh_deploy = run_lsh(rag, n_init)
    mips_main, mips_deploy = run_mips(rag, questions)
    rag_q, q_launches = run_quantized_path(corpus, rag, questions)
    run_reference_check(quantized_scan=True)
    lsh_quant, ham_main, res_main, quant_deploy = run_hamming(rag_q,
                                                              questions)

    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")

    def entry(name, replaces, main_case, deploy_case, n_launches,
              source=None, **more):
        main = {k: main_case[k] for k in keys}
        return {"name": name, "route": "cuda",
                "source": source or f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n_launches,
                "ms": main.pop("kernel_ms"), **main,
                "at_2_22": {k: deploy_case[k] for k in keys}, **more}

    print(json.dumps({"kernels": [
        # launches: the exact main path's; the quantized path's beside
        entry("lsh_hash", "src/repro/kernels/lsh_hash/kernel.py:51",
              lsh_main, lsh_deploy, launches["lsh_hash"],
              quantized_path={
                  "launches": q_launches["lsh_hash"],
                  **{k: lsh_quant[k] for k in keys},
                  **{k: lsh_quant[k] for k in (
                      "bits_flipped", "code_plane_rows",
                      "code_plane_bits_flipped",
                      "query_code_bits_flipped")}}),
        entry("mips_topk", "src/repro/kernels/mips_topk/kernel.py:98",
              mips_main, mips_deploy, launches["mips_topk"]),
        entry("hamming_topk", "src/repro/kernels/hamming_topk/kernel.py:57",
              ham_main, quant_deploy["hamming_topk"],
              q_launches["hamming_topk"]),
        # the exact rescore, XLA (not Pallas) in the JAX package
        entry("mips_rescore", "src/repro/kernels/quantized_scan/ops.py:229",
              res_main, quant_deploy["mips_rescore"],
              q_launches["mips_rescore"],
              source="src/repro_torch/csrc/mips_topk.cu"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
