"""Live ingestion during serving on the PyTorch port: grow the corpus
without stalling it.

The counterpart of ``examples/live_ingest.py``, on ``repro_torch``: a
serving index answers query batches while an ``IngestService`` streams
a document burst in, one tick (chunk, embed and LSH-route, or commit)
between query batches.  The final index is bitwise what a synchronous
``insert_docs`` gives; the example checks that against a twin at the
end and prints ``index_report()["ingest"]``.

    PYTHONPATH=src python examples/live_ingest_torch.py [--device cpu]
"""
import argparse

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.ingest import IngestService
from repro_torch.serving.rag_pipeline import RAGPipeline


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4,
                       s_max=12, max_layers=3, chunk_tokens=32,
                       top_k=8, token_budget=1024,
                       ingest_docs_per_tick=4, ingest_embed_batch=16)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    base, burst = corpus.docs[:40], corpus.docs[40:]
    questions = [qa.question for qa in corpus.qa][:12]

    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim),
                 device=args.device)
    rag.insert_docs(base)
    rag.store.refresh()
    pipe = RAGPipeline(rag)
    svc = IngestService(rag)
    pipe.attach_ingest(svc)

    # the serving loop: one ingest tick between query batches
    svc.submit_many(burst)
    qi = 0
    while not svc.idle:
        stage = svc.tick()
        block = questions[qi % len(questions): qi % len(questions) + 4]
        answers = pipe.answer_batch(block or questions[:4])
        qi += 4
        print(f"tick={stage:<6s} pending={svc.pending_docs:3d} "
              f"index={rag.store.size:4d} rows "
              f"answered={len(answers)}")

    # background ingest is bitwise a synchronous insert of the burst
    twin = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim),
                  device=args.device)
    twin.insert_docs(base)
    for kind, payload in svc.committed_ops:
        (twin.insert_docs if kind == "insert"
         else twin.remove_docs)(payload)
    assert list(rag.graph.nodes) == list(twin.graph.nodes)
    for q in questions[:4]:
        a, b = rag.query(q), twin.query(q)
        assert [(h.node_id, h.score) for h in a.hits] == \
            [(h.node_id, h.score) for h in b.hits]
    print("\nbitwise parity with synchronous insert_docs: OK")

    ingest_report = pipe.index_report()["ingest"]
    print("ingest report:")
    for key, val in ingest_report.items():
        print(f"  {key}: {val}")


if __name__ == "__main__":
    main()
