"""Quickstart on the PyTorch port: build an EraRAG index, grow it, query it.

The counterpart of ``examples/quickstart.py``, on ``repro_torch``: the
LSH hashing and the store's scans run on the card's hand-written
kernels (``--device cpu`` runs their plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.serving.rag_pipeline import RAGPipeline


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4,
                       s_max=12, max_layers=3, chunk_tokens=32,
                       top_k=8, token_budget=1024)
    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim),
                 device=args.device)

    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)

    rep = rag.insert_docs(init)
    print(f"initial build: {rep.n_new_chunks} chunks, "
          f"{rep.n_resummarized} summaries, "
          f"{rag.graph.n_layers} layers, "
          f"{rep.tokens_total} tokens")

    for i, r in enumerate(rounds):
        rep = rag.insert_docs(r)
        print(f"round {i + 1}: +{rep.n_new_chunks} chunks -> "
              f"{rep.n_resummarized} re-summaries "
              f"({rep.tokens_total} tokens) — selective, not rebuild")

    pipeline = RAGPipeline(rag)
    for qa in corpus.qa[:5]:
        ans = pipeline.answer(qa.question)
        mark = "OK " if qa.answer in ans.answer else "MISS"
        print(f"[{mark}] {qa.question}  ->  {ans.answer} "
              f"(gold {qa.answer})")

    errs = rag.graph.check_integrity()
    print(f"graph integrity: {'clean' if not errs else errs}")


if __name__ == "__main__":
    main()
