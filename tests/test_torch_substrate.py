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
from repro_torch.core.store import VectorStore
from repro_torch.data.chunker import chunk_corpus
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.common import resolve_device
from repro_torch.lifecycle import LifecyclePolicy
from repro_torch.serving.rag_pipeline import RAGPipeline
from repro_torch.serving.testing import make_test_engine
from torch_threads import one_blas_thread  # noqa: F401

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
        "import importlib, os, pkgutil, sys\n"
        "import torch\n"
        "testing = {m for m in sys.modules "
        "if m.startswith('torch.testing._internal')}\n"
        "env = dict(os.environ)\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "bad += sorted(m for m in sys.modules if m.startswith("
        "'torch.testing._internal') and m not in testing)\n"
        "bad += ['environ'] if dict(os.environ) != env else []\n"
        "slices = ['repro_torch.models.transformer', "
        "'repro_torch.models.convert', 'repro_torch.train.loop', "
        "'repro_torch.kernels.flash_attention.ops', "
        "'repro_torch.core.baselines', 'repro_torch.core.query_cache', "
        "'repro_torch.ingest', 'repro_torch.ingest.service', "
        "'repro_torch.lifecycle.report', 'repro_torch.obs.schema', "
        "'repro_torch.obs.metrics', 'repro_torch.core.erarag', "
        "'repro_torch.serving.rag_pipeline', "
        "'repro_torch.checkpoint.store', 'repro_torch.lifecycle.policy', "
        "'repro_torch.lifecycle.manager', "
        "'repro_torch.serving.live_harness', "
        "'repro_torch.configs.deepseek_moe_16b', "
        "'repro_torch.configs.llama4_maverick', "
        "'repro_torch.train.optimizer', 'repro_torch.common.registry', "
        "'repro_torch.common.utils', 'repro_torch.configs.dcn_v2', "
        "'repro_torch.configs.deepfm', 'repro_torch.configs.dien', "
        "'repro_torch.configs.mind', 'repro_torch.configs.gatedgcn', "
        "'repro_torch.configs.phi3_medium', 'repro_torch.models.recsys', "
        "'repro_torch.models.gnn', 'repro_torch.models.api', "
        "'repro_torch.data.pipeline', 'repro_torch.launch.mesh', "
        "'repro_torch.common.sharding', 'repro_torch.models.sharding_ctx', "
        "'repro_torch.distributed', "
        "'repro_torch.distributed.comm_analysis', "
        "'repro_torch.distributed.dtensor_rules', "
        "'repro_torch.launch.dryrun']\n"
        "bad += [m for m in slices if m not in sys.modules]\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 93, out.stdout


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
    {"reshard_tombstone_threshold": 0.5}, {"reshard_skew_threshold": 1.5}])
def test_unported_options_raise(kw):
    """The ``reshard_*`` thresholds, once unported and raising, now
    attach the config's ``LifecyclePolicy`` to the store."""
    cfg = dataclasses.replace(ERARAG_DEFAULT, embed_dim=16, **kw)
    rag = EraRAG(cfg, HashingEmbedder(dim=16), device="cpu")
    policy = rag.store._policy
    assert isinstance(policy, LifecyclePolicy)
    assert policy == LifecyclePolicy.from_config(cfg)
    assert policy.skew_threshold == kw.get("reshard_skew_threshold", 0.0)
    assert policy.tombstone_threshold == \
        kw.get("reshard_tombstone_threshold", 0.0)


def test_unported_serving_and_store_paths_raise():
    cfg = dataclasses.replace(ERARAG_DEFAULT, embed_dim=16)
    rag = EraRAG(cfg, HashingEmbedder(dim=16), device="cpu")
    # the lifecycle of slice 12: a policy attaches (the flat store's
    # stands down: it never migrates in place)
    policy = LifecyclePolicy(skew_threshold=1.0, min_rows=1)
    rag.store.attach_lifecycle(policy)
    assert rag.store._policy is policy and rag.store.migration is None
    assert policy.decide(rag.store) is None
    # the serving front of slice 10 is served
    assert RAGPipeline(rag).index_report()["size"] == 0
    assert EraRAG(dataclasses.replace(cfg, query_cache=True),
                  HashingEmbedder(dim=16),
                  device="cpu").query_cache is not None
    # and the LM reader of slice 11: one question through a pipeline
    # with a tiny engine
    rag.insert_docs([("d0", "The color of alpha is red. Alpha lives in "
                            "the north.")])
    pipe = RAGPipeline(rag, engine=make_test_engine(device="cpu"))
    ans = pipe.answer("What is the color of alpha?")
    assert ans.hits > 0 and ans.answer.startswith("tok")
    assert pipe.index_report()["launches"]["engine"][
        "generate_batches"] == 1


def _not_ported_items():
    """(file:line, item) of every ``not_ported(what, item)`` call in the
    port, the item resolved where it is a module constant."""
    import ast
    import importlib
    out = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        mod = None
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "not_ported"):
                continue
            arg = node.args[1]
            if isinstance(arg, ast.Constant):
                item = arg.value
            else:
                if mod is None:
                    name = ".".join(path.relative_to(SRC).with_suffix("")
                                    .parts)
                    mod = importlib.import_module(name)
                item = getattr(mod, arg.id)
            out.append((f"{path.relative_to(SRC)}:{node.lineno}", item))
    return out


def test_every_not_ported_item_is_in_roadmap_queue_1():
    """Every raise quotes a fixed item ID ("3. LM serving") that names
    an item of ROADMAP.md's queue 1, word for word."""
    import re
    roadmap = (SRC.parent / "ROADMAP.md").read_text()
    queue1 = roadmap.split("### 1. Modules to port")[1].split("### 2.")[0]
    items = set(re.findall(r"^- \*\*(\d+\. [^*]+?)\.?\*\*", queue1,
                           re.M))
    sites = _not_ported_items()
    # none may be left; every one left must name a queue-1 item, and
    # none may quote an item that is ported (11. MoE, 12. Adafactor)
    bad = [(site, item) for site, item in sites if item not in items]
    assert not bad, (bad, sorted(items))
    ported = [(site, item) for site, item in sites
              if item.startswith(("11. ", "12. "))]
    assert not ported, ported
