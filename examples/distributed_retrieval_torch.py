"""Sharded retrieval on the PyTorch port: the EraRAG index over the ranks
of a process group.

The counterpart of ``examples/distributed_retrieval.py``, on
``repro_torch``.  It spawns ``--ranks`` processes, one per device, joined
in one group (``launch/mesh.py``: NCCL when each rank has a card of its
own, gloo when they share one or run on the CPU), and runs three parts
on every rank:

1. the row-sharded flat scan: the node embeddings split row-wise over
   the ranks, each rank scanning its block with the ``mips_topk``
   kernel, then the ``(ranks, b, k)`` candidates gathered and merged
   (``gather_merge_topk``): exactly the single-device scan's result;
2. the maintained version of that layout: a ``ShardedVectorStore`` on
   the group, each rank holding its own slots, whose per-version deltas
   stage rows only on the shards that own them;
3. the collective query (``collective_query=True``, the default): one
   call that scans every rank's slots, gathers and merges, against the
   per-shard loop that stays as the parity oracle, with the store's
   launch counts on this rank (the loop's: this rank's slot scans and
   its merge).  On one rank the collective switches itself off.

    PYTHONPATH=src python examples/distributed_retrieval_torch.py \\
        [--ranks N] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.core.store import ShardedVectorStore
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.mips_topk.ops import gather_merge_topk, mips_topk
from repro_torch.launch.mesh import run_ranks


def _hit_keys(batch):
    return [[(h.node_id, h.score) for h in hits] for hits in batch]


def rank_main(group) -> dict:
    """One rank's run; returns the lines rank 0 prints and the results
    the tests hold against the JAX package."""
    lines = []
    device = group.device
    n_dev = group.world_size
    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4,
                       s_max=12, max_layers=3, chunk_tokens=32)
    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), device=device)
    corpus = SyntheticCorpus.generate(n_docs=50, n_topics=5, seed=0)
    rag.insert_docs(corpus.docs)
    ids, embs, _ = rag.graph.all_embeddings()
    k = 8

    # --- the row-sharded flat scan: pad rows to a rank multiple ------
    n = embs.shape[0]
    db = np.pad(embs, ((0, (-n) % n_dev), (0, 0)))
    shard_rows = db.shape[0] // n_dev
    base = group.rank * shard_rows
    queries = rag.embedder.encode([qa.question for qa in corpus.qa[:4]])
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device)
    block = torch.from_numpy(db[base:base + shard_rows]).to(device)
    v_loc, i_loc = mips_topk(q, block, k)
    v, i = gather_merge_topk(v_loc[None], (i_loc + base)[None], k, group)

    # exact-match check against the single-device scan
    v_ref, i_ref = mips_topk(q, torch.from_numpy(embs).to(device), k)
    assert np.allclose(v.cpu().numpy(), v_ref.cpu().numpy(), atol=1e-5)
    assert np.array_equal(i.cpu().numpy(), i_ref.cpu().numpy())
    lines.append(f"sharded retrieval over {n_dev} device(s): exact match "
                 f"with single-device search for {q.shape[0]} queries")
    top1 = [ids[int(r)] for r in i[:, 0].tolist()]
    for qi, qa in enumerate(corpus.qa[:2]):
        lines.append(f"Q: {qa.question}  top-1 node: {top1[qi]}")

    # --- the maintained version: the sharded store on the group ------
    sharded = ShardedVectorStore(rag.graph, group=group)
    sharded.refresh()
    staged0 = [s.rows_staged for s in sharded.shard_stats()]
    extra = SyntheticCorpus.generate(n_docs=2, n_topics=2, seed=7)
    rag.insert_docs(extra.docs)
    sharded.refresh()
    rag.store.refresh()
    staged = [s.rows_staged - b
              for s, b in zip(sharded.shard_stats(), staged0)]
    hits_flat = rag.store.search_batch(queries, k)
    hits_shard = sharded.search_batch(queries, k)
    assert _hit_keys(hits_flat) == _hit_keys(hits_shard)
    lines.append(f"ShardedVectorStore over {sharded.n_shards} shard(s): "
                 f"delta staged per shard {staged} (total "
                 f"{sum(staged)} of {sharded.size} rows), exact parity "
                 f"with the single-buffer store")

    # --- the collective query against the loop -----------------------
    launches = None
    if sharded.collective_active:
        n0 = sharded.stats.kernel_launches
        hits_coll = sharded.search_batch(queries, k)
        n_coll = sharded.stats.kernel_launches - n0
        sharded.collective = False           # the parity oracle
        n0 = sharded.stats.kernel_launches
        hits_loop = sharded.search_batch(queries, k)
        n_loop = sharded.stats.kernel_launches - n0
        sharded.collective = True
        assert _hit_keys(hits_coll) == _hit_keys(hits_loop)
        launches = (n_coll, n_loop)
        lines.append(f"collective query: {n_coll} launch for the whole "
                     f"{sharded.n_shards}-shard scan+merge vs {n_loop} on "
                     f"this rank's per-shard loop, bitwise-identical "
                     f"results")
    else:
        lines.append("collective query auto-off (single-device mesh): "
                     "per-shard loop dispatch")
    return {"lines": lines, "top1": top1, "staged": staged,
            "launches": launches, "backend": group.backend,
            "device": str(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes in the group (default: one per card, "
                         "1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is stopped")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    out = run_ranks(rank_main, ranks, device=device.type,
                    timeout_s=args.timeout)
    assert all(r["lines"] == out[0]["lines"] for r in out)
    for line in out[0]["lines"]:
        print(line)
    return out[0]


if __name__ == "__main__":
    main()
