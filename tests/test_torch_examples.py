"""The PyTorch port's examples (``examples/*_torch.py``) on the CPU, held
against the JAX package's examples.

``quickstart``, ``live_ingest`` and ``rag_serve`` print, line for line,
what the reference examples print (both ``main``s run in this process,
their output captured).  ``train_lm_torch`` reports the reference
model's parameter count, its loss falls over a short run, and
``--resume`` continues from the checkpoint.  ``distributed_retrieval_
torch`` runs on four gloo ranks: its top-1 nodes are the reference's
single-device ``mips_topk`` top-1, and the rows each shard stages are
the JAX package's mesh-free ``ShardedVectorStore`` at four shards; on
one rank it prints the reference's "auto-off" line.  None of the
examples imports ``jax`` or ``repro``.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_blas_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SRC = Path(__file__).resolve().parents[1] / "src"
PORTED = ("quickstart", "live_ingest", "rag_serve", "train_lm",
          "distributed_retrieval")


def _module(name: str):
    """An example module, imported from ``examples/`` by file."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


PRINTING = ("quickstart", "live_ingest", "rag_serve")
IMPORTS = (
    "import importlib.util, sys\n"
    f"for name in {[f'{n}_torch' for n in PORTED]!r}:\n"
    f"    spec = importlib.util.spec_from_file_location(name, "
    f"{str(EXAMPLES)!r} + '/' + name + '.py')\n"
    "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
    "m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
    "print(bad)\n"
    "sys.exit(1 if bad else 0)\n")


@pytest.fixture(scope="module")
def children():
    """Started at the module's first test, so that they run beside the
    port's examples: each reference example that prints, run as a
    script, and a fresh interpreter that imports the port's examples.
    OpenBLAS keeps one thread in them, as in this process
    (``torch_threads``): several processes that each spread their small
    products over every core slow one another down many times over."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OPENBLAS_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in PRINTING}
    procs["imports"] = subprocess.Popen(
        [sys.executable, "-c", IMPORTS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finished(proc):
    """(return code, stdout, stderr) of a child."""
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


@pytest.mark.parametrize("name", PRINTING)
def test_example_prints_the_reference_lines(name, children):
    got = _printed(_module(f"{name}_torch").main, ["--device", "cpu"])
    rc, out, err = _finished(children[name])
    assert rc == 0, err[-4000:]
    assert got == out.splitlines()
    assert len(got) >= 5


def test_train_lm_reports_the_reference_model_and_resumes(tmp_path):
    import jax

    from repro.models import transformer as JT

    mod = _module("train_lm_torch")
    ref = _module("train_lm")
    shapes = jax.eval_shape(lambda k: JT.init_params(ref.small_lm(), k)[0],
                            jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    ckpt = tmp_path / "ckpt"
    argv = ["--steps", "3", "--batch", "2", "--seq", "32", "--device",
            "cpu", "--ckpt", str(ckpt)]
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            first = mod.main(argv)
        lines = out.getvalue().splitlines()
        assert lines[0] == f"model: {n_ref / 1e6:.1f}M params"
        assert first.final_step == 3 and len(first.losses) == 3
        assert first.losses[-1] < first.losses[0]
        resumed_lines = _printed(
            mod.main, argv[:1] + ["5"] + argv[2:] + ["--resume"])
        assert resumed_lines[1] == "resumed from step 3"
        assert resumed_lines[2].startswith("finished at step 5:")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


@pytest.fixture(scope="module")
def distributed():
    sys.path.insert(0, str(EXAMPLES))
    try:
        mod = importlib.import_module("distributed_retrieval_torch")
        four = _printed_result(mod.main, ["--ranks", "4", "--device",
                                          "cpu"])
        one = _printed_result(mod.main, ["--ranks", "1", "--device",
                                         "cpu"])
    finally:
        sys.path.remove(str(EXAMPLES))
    return four, one


def _printed_result(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return out.getvalue().splitlines(), result


def test_distributed_retrieval_on_four_ranks_matches_reference(distributed):
    import jax.numpy as jnp

    from repro.common.config import EraRAGConfig as JaxConfig
    from repro.core.erarag import EraRAG as JaxRAG
    from repro.core.store import ShardedVectorStore as JaxSharded
    from repro.data.corpus import SyntheticCorpus
    from repro.embed.hashing import HashingEmbedder as JaxEmbedder
    from repro.kernels.mips_topk.ops import mips_topk

    (lines, result), _ = distributed
    assert result["backend"] == "gloo"
    cfg = JaxConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                    max_layers=3, chunk_tokens=32)
    rag = JaxRAG(cfg, JaxEmbedder(dim=cfg.embed_dim))
    corpus = SyntheticCorpus.generate(n_docs=50, n_topics=5, seed=0)
    rag.insert_docs(corpus.docs)
    ids, embs, _ = rag.graph.all_embeddings()
    queries = rag.embedder.encode([qa.question for qa in corpus.qa[:4]])
    _, idx = mips_topk(jnp.asarray(queries), jnp.asarray(embs), 8)
    assert result["top1"] == [ids[int(r)] for r in np.asarray(idx)[:, 0]]

    sharded = JaxSharded(rag.graph, n_shards=4)
    sharded.refresh()
    staged0 = [s.rows_staged for s in sharded.shard_stats()]
    rag.insert_docs(SyntheticCorpus.generate(n_docs=2, n_topics=2,
                                             seed=7).docs)
    sharded.refresh()
    staged = [s.rows_staged - b
              for s, b in zip(sharded.shard_stats(), staged0)]
    assert result["staged"] == staged
    # the loop's launches on rank 0: its one slot's scan and the merge
    assert result["launches"] == (1, 2)
    assert lines[0] == ("sharded retrieval over 4 device(s): exact match "
                        "with single-device search for 4 queries")
    assert lines[-1].startswith("collective query: 1 launch for the "
                                "whole 4-shard scan+merge vs 2 on this "
                                "rank's per-shard loop")


def test_distributed_retrieval_on_one_rank_switches_collective_off(
        distributed):
    (four, _), (one, result) = distributed
    assert result["launches"] is None
    assert one[-1] == ("collective query auto-off (single-device mesh): "
                       "per-shard loop dispatch")
    assert one[1:3] == four[1:3]       # the same top-1 nodes


def test_examples_import_neither_jax_nor_reference(children):
    rc, out, err = _finished(children["imports"])
    assert rc == 0, out + err
    assert sorted(p.stem for p in EXAMPLES.glob("*_torch.py")) == \
        sorted(f"{n}_torch" for n in PORTED)
