"""RAG serving on the PyTorch port: EraRAG retrieval + the batched LM
decode engine.

The counterpart of ``examples/rag_serve.py``, on ``repro_torch``:
builds the index, serves QA requests through the engine (slots over a
shared KV cache), then grows the corpus without taking the service
down.  The reader LM is tiny and untrained, its weights drawn by the
port's own ``init_params`` from seed 0.

    PYTHONPATH=src python examples/rag_serve_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.common.config import EraRAGConfig, LMConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.rag_pipeline import RAGPipeline


def tiny_reader() -> LMConfig:
    return LMConfig(name="reader", family="lm-dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                    vocab_size=32000, max_seq_len=512)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4,
                       s_max=12, max_layers=3, chunk_tokens=32,
                       top_k=8, token_budget=512)
    rag = EraRAG(cfg, HashingEmbedder(dim=cfg.embed_dim), device=device)
    corpus = SyntheticCorpus.generate(n_docs=40, n_topics=5, seed=0)
    init, rounds = corpus.growth_rounds(0.6, 2)
    rag.insert_docs(init)
    print(f"index: {len(rag.graph.nodes)} nodes, "
          f"{rag.graph.n_layers} layers")

    # the batched decode engine over an untrained tiny reader LM: the
    # engine's mechanics (slots, prefill, per-slot cache) are what this
    # example runs; examples/train_lm_torch.py trains weights
    lm = tiny_reader()
    model = T.init_params(lm, torch.Generator(device=device).manual_seed(0))
    engine = Engine(lm, model, EngineConfig(max_batch=4, max_seq_len=256,
                                            max_new_tokens=8))
    # deterministic extractive reader answers; the engine generates
    # alongside to show the serving path
    pipeline = RAGPipeline(rag)
    questions = [qa for qa in corpus.qa if qa.kind == "detailed"][:6]
    for qa in questions:
        ans = pipeline.answer(qa.question)
        engine.submit(f"Context: {ans.context[:200]} Q: {qa.question}")
        mark = "OK " if qa.answer in ans.answer else "MISS"
        print(f"[{mark}] {qa.question} -> {ans.answer}")
    engine.run_until_done()
    print(f"engine drained: {len(engine._results)} generations")

    # live update: the corpus grows while serving continues
    rep = rag.insert_docs(rounds[0])
    print(f"live update: +{rep.n_new_chunks} chunks, "
          f"{rep.n_resummarized} re-summaries, index now "
          f"{len(rag.graph.nodes)} nodes")
    ans = pipeline.answer(questions[0].question)
    print(f"post-update query still serves: {ans.answer!r}")


if __name__ == "__main__":
    main()
