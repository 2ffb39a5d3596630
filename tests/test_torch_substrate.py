"""Port substrate parity: the PyTorch package's host-side copies
(config, corpus, chunker, tokenizer, embedder, partition) against the
JAX package's, bitwise, on inputs made from numpy seeds; plus import
hygiene and the device rule of the port's entry points.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.common.config import EraRAGConfig as JaxConfig
from repro.core.partition import partition_items as jax_partition
from repro.data.chunker import chunk_corpus as jax_chunk_corpus
from repro.data.corpus import SyntheticCorpus as JaxCorpus
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.embed.hashing import HashingEmbedder as JaxEmbedder

from repro_torch.common.config import EraRAGConfig
from repro_torch.configs.erarag import ERARAG_DEFAULT
from repro_torch.core.erarag import EraRAG
from repro_torch.core.graph import EraGraph
from repro_torch.core.lsh import HyperplaneLSH
from repro_torch.core.partition import partition_items
from repro_torch.core.store import VectorStore, store_from_state
from repro_torch.data.chunker import chunk_corpus
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.common import resolve_device
from repro_torch.serving.rag_pipeline import RAGPipeline

SRC = Path(__file__).resolve().parent.parent / "src"


def test_config_fields_match_reference():
    """Snapshots carry cfg as a dict: every reference field must be a
    port field with the same default."""
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port = {f.name: f.default for f in dataclasses.fields(EraRAGConfig)}
    assert port == ref
    cfg = JaxConfig(embed_dim=128, n_hyperplanes=10, chunk_tokens=32)
    assert EraRAGConfig(**cfg.__dict__).__dict__ == cfg.__dict__
    from repro.configs.erarag import ERARAG_DEFAULT as JAX_DEFAULT
    assert ERARAG_DEFAULT.__dict__ == JAX_DEFAULT.__dict__


@pytest.mark.parametrize("kw", [
    {"s_min": 0}, {"retrieval_bias_p": 1.5}, {"index_shards": -1},
    {"obs_max_spans": 0}])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        EraRAGConfig(**kw)


@pytest.mark.parametrize("n_docs,n_topics,seed", [(40, 4, 0), (90, 7, 3)])
def test_corpus_chunks_tokens_embeddings_bitwise(n_docs, n_topics, seed):
    a = JaxCorpus.generate(n_docs=n_docs, n_topics=n_topics, seed=seed)
    b = SyntheticCorpus.generate(n_docs=n_docs, n_topics=n_topics,
                                 seed=seed)
    assert a.docs == b.docs and a.topics == b.topics
    assert [dataclasses.astuple(x) for x in a.qa] == \
        [dataclasses.astuple(x) for x in b.qa]
    assert a.growth_rounds(0.5, 5) == b.growth_rounds(0.5, 5)

    ca = jax_chunk_corpus(a.docs, JaxTokenizer(), 32)
    cb = chunk_corpus(b.docs, HashTokenizer(), 32)
    assert [dataclasses.astuple(c) for c in ca] == \
        [dataclasses.astuple(c) for c in cb]

    texts = [c.text for c in ca[:50]] + ["", "What is the color?"]
    for t in texts:
        np.testing.assert_array_equal(JaxTokenizer().encode(t, True),
                                      HashTokenizer().encode(t, True))
    ja, pa = JaxEmbedder(dim=128, seed=seed), HashingEmbedder(dim=128,
                                                             seed=seed)
    np.testing.assert_array_equal(ja._proj, pa._proj)   # same PCG64 draw
    ea, eb = ja.encode(texts), pa.encode(texts)
    assert ea.dtype == eb.dtype == np.float32
    np.testing.assert_array_equal(ea, eb)
    assert not eb[-2].any()   # the empty text embeds to the zero row


@pytest.mark.parametrize("seed,n,s_min,s_max", [
    (0, 200, 4, 12), (1, 57, 3, 5), (2, 13, 10, 12), (3, 1, 4, 12)])
def test_partition_items_identical(seed, n, s_min, s_max):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, size=n)
    items = [(int(k), f"id{i:04d}") for i, k in enumerate(keys)]
    assert partition_items(items, s_min, s_max) == \
        jax_partition(items, s_min, s_max)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30, out.stdout


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without CUDA, an entry point not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HyperplaneLSH(16, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EraRAG(ERARAG_DEFAULT, HashingEmbedder(dim=256))
    graph = EraGraph(ERARAG_DEFAULT, HashingEmbedder(dim=256),
                     device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorStore(graph)
    assert resolve_device("cpu") == torch.device("cpu")
    assert VectorStore(graph, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [
    {"index_shards": 2}, {"index_shards": 0}, {"quantized_scan": True},
    {"query_cache": True}, {"reshard_skew_threshold": 1.5}])
def test_unported_options_raise(kw):
    cfg = dataclasses.replace(ERARAG_DEFAULT, embed_dim=16, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EraRAG(cfg, HashingEmbedder(dim=16), device="cpu")


def test_unported_serving_and_store_paths_raise():
    cfg = dataclasses.replace(ERARAG_DEFAULT, embed_dim=16)
    rag = EraRAG(cfg, HashingEmbedder(dim=16), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RAGPipeline(rag, engine=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RAGPipeline(rag).index_report()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rag.reshard(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rag.store.attach_lifecycle(object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        store_from_state({"kind": "sharded"}, rag.graph, device="cpu")
