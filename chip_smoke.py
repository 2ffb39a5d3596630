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
                 shape (real embeddings) and at n = 2^22 rows.
4. ``mips_topk`` ``flagged_mips_topk`` through the kernel against its
                 plain version at the main path's shape (the real store
                 buffer) and at n = 2^22 rows x (256 + 3), b = 64, k = 8;
                 b = 1 against b = 64 must agree bitwise.
5. ``kernels``   one line listing both kernels with their numbers.

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


def bound(n_bytes: float, n_flop: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and fp32 operations over the non-tensor fp32 peak."""
    by_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    by_ops = n_flop / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


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
    return rag, questions, n_init_chunks, launches


def run_reference_check():
    """The quickstart configuration on the card against the same code
    on the CPU (plain versions, which the CPU tests hold against the
    JAX package): same graph, hits, contexts and answers."""
    from repro_torch.common.config import EraRAGConfig
    from repro_torch.core.erarag import EraRAG
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.embed.hashing import HashingEmbedder
    from repro_torch.serving.rag_pipeline import RAGPipeline

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                       max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024)
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
    emit("reference", config="quickstart", nodes=len(gpu.graph.nodes),
         queries=len(questions), modes=4, max_score_err=max_err,
         tolerance=SCORE_TOL, hits_equal=True, answers_equal=True)


# ---------------------------------------------------------------------------
# phase 3: lsh_hash
# ---------------------------------------------------------------------------

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
    bits_k = ops.unpack_bits(got, k)
    bits_p = ops.unpack_bits(want, k)
    flipped = (bits_k != bits_p)
    n_flipped = int(flipped.sum())
    max_flip_proj = 0.0
    if n_flipped:
        rows = flipped.any(dim=1).nonzero().flatten()
        proj = v[rows].double() @ h.double()
        max_flip_proj = float(proj.abs()[flipped[rows]].max())
    check(max_flip_proj <= LSH_FLIP_BAND,
          f"lsh_hash {label}: a bit with |projection| "
          f"{max_flip_proj} > {LSH_FLIP_BAND} differs")
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
    del v
    gen = torch.Generator(device="cuda").manual_seed(1)
    v = torch.randn(N_DEPLOY, h.shape[0], device="cuda", generator=gen)
    v[0] = 0.0   # the embedder's empty-text row: every bit set
    deploy = lsh_case(v, h, "2^22")
    del v
    torch.cuda.empty_cache()
    emit("lsh_hash", main_path=main, at_2_22=deploy)
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
    builds = build_kernels(["lsh_hash", "mips_topk"], force=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=builds,
         build_wall_s=time.perf_counter() - t0)

    rag, questions, n_init, launches = run_main_path()
    run_reference_check()
    lsh_main, lsh_deploy = run_lsh(rag, n_init)
    mips_main, mips_deploy = run_mips(rag, questions)

    def entry(name, replaces, main_case, deploy_case):
        keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "shape")
        main = {k: main_case[k] for k in keys}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "ms": main.pop("kernel_ms"), **main,
                "at_2_22": {k: deploy_case[k] for k in keys}}

    print(json.dumps({"kernels": [
        entry("lsh_hash", "src/repro/kernels/lsh_hash/kernel.py:51",
              lsh_main, lsh_deploy),
        entry("mips_topk", "src/repro/kernels/mips_topk/kernel.py:98",
              mips_main, mips_deploy),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
