"""The port's architecture registry, configs, ``ModelAPI``, tree and
generator utilities and data pipeline against the JAX package's, on the
CPU.

- ``list_archs()`` equal; every config field for field (``to_json``)
  with ``param_count`` equal, full and reduced.
- For every architecture x shape (40 cells): ``input_specs`` shapes and
  dtypes (the port's on the ``meta`` device; its LM cache one K and one
  V over every layer, the reference's a pair a block position) and
  ``input_axes`` equal to the reference's, and ``demo_batch`` bitwise
  equal; the ``init`` axes trees equal.
- ``get_api(get_arch(name))`` runs every step function of every
  architecture at its reduced config.
- ``key_for``'s generator is the same in processes with other string
  hash salts; the tree helpers equal the reference's.
- ``TokenBatcher`` bitwise; ``Prefetcher`` order, ``end_step``, a
  ``make_batch`` error re-raised and ``close()``.
- The microbatch repair: every batch leaf cut along its own leading
  axis, and an LM step at 2 microbatches bitwise the slicing by
  ``tokens`` it had before.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JC
from repro.common import utils as JU
from repro.common.registry import get_arch as jax_get_arch
from repro.common.registry import list_archs as jax_list_archs
from repro.data.pipeline import TokenBatcher as JaxTokenBatcher
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.models import api as JA
from repro_torch.common import config as C
from repro_torch.common import utils as U
from repro_torch.common.registry import get_arch, list_archs, register_arch
from repro_torch.data.pipeline import Prefetcher, TokenBatcher, \
    synthetic_lm_batches
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import api as A
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from torch_threads import one_blas_thread  # noqa: F401

CPU = torch.device("cpu")
SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = jax_list_archs()
CELLS = [(a, s.name) for a in ARCHS for s in jax_get_arch(a).shapes]


def _spec(x):
    """(shape, dtype name) of a JAX stand-in, an array or a tensor."""
    if torch.is_tensor(x):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), str(np.dtype(x.dtype))


def test_list_archs_equal():
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="duplicate"):
        register_arch("mind")(lambda: None)


@pytest.mark.parametrize("name", ARCHS)
def test_config_field_for_field(name):
    want, got = jax_get_arch(name), get_arch(name)
    assert type(got).__name__ == type(want).__name__
    assert got.to_json() == want.to_json()
    assert got.param_count() == want.param_count()
    assert got.reduced().to_json() == want.reduced().to_json()
    assert got.reduced().param_count() == want.reduced().param_count()
    if isinstance(want, JC.LMConfig):
        assert got.active_param_count() == want.active_param_count()
    for s_got, s_want in zip(got.shapes, want.shapes):
        assert s_got.to_json() == s_want.to_json()
        assert (s_got.is_decode, s_got.is_prefill, s_got.is_training) == \
            (s_want.is_decode, s_want.is_prefill, s_want.is_training)


def _assert_specs_equal(got, want, lm_cache_blocks):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "caches":
            # reference: a (n_blocks, ...) pair a block position;
            # port: one (n_layers, ...) pair
            for kv in ("k", "v"):
                shapes = {_spec(c[kv]) for c in want[k]}
                assert len(shapes) == 1 and len(want[k]) == lm_cache_blocks
                (shape, dt), = shapes
                assert _spec(got[k][kv]) == \
                    ((shape[0] * lm_cache_blocks,) + shape[1:], dt)
            continue
        assert _spec(got[k]) == _spec(want[k]), k


@pytest.mark.parametrize("name,shape", CELLS)
def test_input_specs_axes_and_demo_batch(name, shape):
    cfg_j, cfg = jax_get_arch(name), get_arch(name)
    japi, api = JA.get_api(cfg_j), A.get_api(cfg)
    sj, s = cfg_j.shape(shape), cfg.shape(shape)
    bs = T.block_size(cfg) if isinstance(cfg, C.LMConfig) else 1
    specs = api.input_specs(s)
    assert all(v.device.type == "meta"
               for v in jax.tree.leaves(specs) if torch.is_tensor(v))
    _assert_specs_equal(specs, japi.input_specs(sj), bs)
    ax_j = japi.input_axes(sj)
    ax = api.input_axes(s)
    if "caches" in ax_j:
        assert all(c == ax["caches"] for c in ax_j.pop("caches"))
        ax.pop("caches")
    assert ax == ax_j
    want = japi.demo_batch(sj, 5)
    got = api.demo_batch(s, 5, device=CPU)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "caches":
            _assert_specs_equal({k: got[k]}, {k: want[k]}, bs)
            assert not any(bool(got[k][kv].any()) for kv in ("k", "v"))
        elif k == "cache_len":
            assert got[k] == int(want[k]) == 0
        else:
            assert _spec(got[k]) == _spec(want[k]), k
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_init_axes_trees_equal(name):
    cfg_j, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    box = {}

    def init(key):          # traced only: the axes are plain data
        params, box["axes"] = JA.get_api(cfg_j).init(key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    ax_j = box["axes"]
    model, ax = A.get_api(cfg).init(torch.Generator().manual_seed(0))
    assert ax == ax_j
    assert U.tree_param_count(model) >= cfg.param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_get_api_runs_every_shape(name):
    cfg = get_arch(name).reduced()
    api = A.get_api(cfg)
    model, _ = api.init(torch.Generator().manual_seed(1))
    for shape in cfg.shapes:
        batch = api.demo_batch(shape, 2, device=CPU)
        with torch.set_grad_enabled(shape.kind == "training"):
            out = api.step_fn(shape)(model, batch)
        first = out[0]
        assert torch.isfinite(first).all(), (name, shape.name)
        if shape.kind == "training":
            assert first.dim() == 0
            first.backward()
            assert all(p.grad is not None for p in model.parameters())
            model.zero_grad(set_to_none=True)


def test_key_for_is_stable_across_processes():
    """The JAX package folds ``abs(hash(str(p)))``, which Python salts
    per process; the port's blake2b digest gives one stream."""
    code = ("from repro_torch.common.utils import key_for\n"
            "import torch\n"
            "print(hash('layer'), torch.randint(0, 2**31, (4,), "
            "generator=key_for(3, 'layer', 7)).tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(SRC),
               PYTHONHASHSEED=str(abs(hash("salt")) % 1000 + 1))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    salted, draws = out.split(" ", 1)
    assert int(salted) != hash("layer")      # another salt than here
    here = torch.randint(0, 2**31, (4,),
                         generator=U.key_for(3, "layer", 7)).tolist()
    assert draws == f"{here}\n"
    other = torch.randint(0, 2**31, (4,),
                          generator=U.key_for(3, "layer", 8)).tolist()
    assert other != here


def test_tree_utils_match_reference():
    rng = np.random.default_rng(0)
    tree_np = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": [rng.integers(0, 5, size=(7,)).astype(np.int32),
                     {"c": np.ones((2, 2, 2), np.float32)}]}
    tree_j = jax.tree.map(jnp.asarray, tree_np)
    tree_t = jax.tree.map(torch.from_numpy, tree_np)
    assert U.tree_size_bytes(tree_t) == JU.tree_size_bytes(tree_j) == 108
    assert U.tree_param_count(tree_t) == JU.tree_param_count(tree_j) == 27
    cast = U.cast_tree(tree_t, torch.bfloat16)
    cast_j = JU.cast_tree(tree_j, jnp.bfloat16)
    assert cast["a"].dtype == torch.bfloat16
    assert cast["b"][0].dtype == torch.int32
    assert U.tree_size_bytes(cast) == JU.tree_size_bytes(cast_j)
    for n in (0, 1023, 1024, 5 * 2**30, 3e15):
        assert U.human_bytes(n) == JU.human_bytes(n)
    for x, m in ((0, 8), (1, 8), (256, 256), (13_130_001, 256)):
        assert U.ceil_to(x, m) == JU.ceil_to(x, m)
    store = {}
    with U.timed_block(store, "t"):
        pass
    assert store["t"] >= 0.0


def test_token_batcher_bitwise():
    texts = ["the quick brown fox", "", "jumps over the lazy dog " * 40,
             "EraRAG grows its graph"]
    want = JaxTokenBatcher(JaxTokenizer(), max_len=32).batch(texts)
    got = TokenBatcher(HashTokenizer(), max_len=32).batch(texts)
    for k in ("tokens", "mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_in_order():
    make = synthetic_lm_batches(100, batch=2, seq_len=4, seed=0)
    pf = Prefetcher(make, start_step=3, depth=2, end_step=7)
    got = [(s, b["tokens"]) for s, b in pf]
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, toks in got:
        np.testing.assert_array_equal(toks, make(s)["tokens"])
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_propagates_worker_error():
    def make(step):
        if step == 2:
            raise ValueError("boom at step 2")
        return {"tokens": np.zeros((1, 4), dtype=np.int32)}

    pf = Prefetcher(make, depth=2, end_step=10)
    got = []
    with pytest.raises(ValueError, match="boom at step 2"):
        for s, _ in pf:
            got.append(s)
    assert got == [0, 1]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_unsticks_full_queue():
    make = synthetic_lm_batches(100, batch=2, seq_len=4, seed=0)
    pf = Prefetcher(make, depth=1, end_step=5)
    deadline = time.time() + 5.0
    while pf._q.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    pf.close()
    assert not pf._thread.is_alive()


def test_microbatch_cuts_each_leaf_by_its_own_leading_axis():
    rng = np.random.default_rng(0)
    batch = {"sparse": rng.integers(0, 9, size=(8, 3), dtype=np.int32),
             "dense": rng.standard_normal((8, 2)).astype(np.float32),
             "edge_index": rng.integers(0, 9, size=(2, 6), dtype=np.int32),
             "nested": [rng.standard_normal((4,)).astype(np.float32)]}
    for i in range(2):
        got = O.microbatch(batch, i, 2)
        want = jax.tree.map(lambda x: np.asarray(jax.lax.dynamic_slice_in_dim(
            jnp.asarray(x), i * (x.shape[0] // 2), x.shape[0] // 2, 0)),
            batch)
        jax.tree.map(np.testing.assert_array_equal, got, want)


def test_lm_step_at_two_microbatches_is_what_it_was():
    """The repair changes nothing for an LM batch: the step equals one
    built from slices of ``len(batch["tokens"]) // 2`` rows, bitwise."""
    cfg = get_arch("llama3-8b").reduced()
    batch = synthetic_lm_batches(cfg.vocab_size, 4, 16, seed=3)(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    models = [T.init_params(cfg, torch.Generator().manual_seed(2))
              for _ in range(2)]

    def loss(m, b):
        return T.loss_fn(m, b, cfg, compute_dtype=torch.float32)

    step = O.make_train_step(loss, base_lr=1e-2, n_microbatches=2)
    _, _, metrics = step(models[0], O.opt_init(models[0]), batch)
    # the slicing the step had before: one size, from ``tokens``
    ref = models[1]
    size = len(batch["tokens"]) // 2
    losses = []
    for i in range(2):
        part = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
        loss_i, _ = loss(ref, part)
        loss_i.backward()
        losses.append(loss_i.detach())
    params = list(ref.parameters())
    grads = [p.grad.div_(2) for p in params]
    O.adamw_update(params, grads, O.adamw_init(params), lr=1e-2)
    assert torch.equal(metrics["loss"], torch.stack(losses).mean())
    for a, b in zip(models[0].parameters(), ref.parameters()):
        assert torch.equal(a, b)
