"""The RecSys family of the port (DeepFM, DCN-v2, DIEN, MIND over a fused
embedding table) against the JAX package's, on the CPU.

The reduced configs of both registries; weights drawn by the JAX
package (``init_params``, key 0) and carried over with
``params_from_numpy``, MIND's table scaled to unit variance (below);
inputs the reference's ``demo_batch`` numpy draws.
- Every architecture's ``serve_fn`` and ``loss_fn`` in every one of its
  4 shapes, through both packages' ``get_api``: outputs and losses
  within 1e-5, the reference's largest magnitude at least 100x that
  (fp32), every gradient leaf within 1e-4 (relative Frobenius) of
  ``jax.grad``.
- DIEN with ragged ``hist_len`` (1 and S included); MIND's interest
  capsules, their norm below 1, and its top-k: ids equal to
  ``lax.top_k``'s, exact ties to the lowest index, at n = 1,000,000
  (one route in the reference) and n = 2^20 (its two-stage route).
- ``embedding_bag_mean`` with empty and full bags.
- ``make_train_step`` on DeepFM: 3 AdamW steps held step by step
  against the reference's, and one step at 2 microbatches (every batch
  leaf cut along its own leading axis).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as jax_get_arch
from repro.models import api as JA
from repro.models import recsys as JR
from repro.train.optimizer import make_train_step as jax_train_step
from repro.train.optimizer import opt_init as jax_opt_init
from repro_torch.common.registry import get_arch
from repro_torch.models import api as A
from repro_torch.models import recsys as R
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train.optimizer import make_train_step, opt_init
from torch_threads import one_blas_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5          # fp32 logits, losses and serve outputs
GRAD_RTOL = 1e-4    # relative Frobenius error per gradient leaf
# MIND's table is N(0, 0.01^2) in the reference: at the reduced widths
# its scores are about 1e-5 and its in-batch loss ln(b) whatever the
# logits, so a comparison within TOL would hold nothing.  Scaled by 100
# (unit variance) in both packages, its scores and loss are O(1).
MIND_TABLE_SCALE = 100.0
ARCHS = ("deepfm", "dcn-v2", "dien", "mind")
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@functools.lru_cache(maxsize=None)
def reduced(name):
    """(JAX config, port config, the reference's weights as numpy, its
    offsets) of a reduced RecSys config."""
    cfg_j = jax_get_arch(name).reduced()
    params, _, offsets = JR.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    if name == "mind":
        tree["table"] = tree["table"] * np.float32(MIND_TABLE_SCALE)
    return cfg_j, get_arch(name).reduced(), tree, offsets


def _port_model(name):
    _, cfg, tree, _ = reduced(name)
    return params_from_numpy(tree, cfg, device=CPU)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in flat}


def _rel_fro(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_grads_close(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel_fro(got[k], want[k]) <= GRAD_RTOL, k


def _assert_close(got, want):
    """``got`` within TOL of ``want``, whose largest magnitude must be at
    least 100x TOL: a comparison that an output of zeros would pass
    holds nothing."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale >= 100 * TOL, scale
    err = float(np.abs(got - want).max())
    assert err <= TOL, (err, scale)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ARCHS)
def test_step_fn_matches_reference(name, shape):
    cfg_j, cfg, tree, _ = reduced(name)
    japi, api = JA.get_api(cfg_j), A.get_api(cfg)
    spec = cfg.shape(shape)
    batch = {k: np.asarray(v)
             for k, v in japi.demo_batch(cfg_j.shape(shape), 3).items()}
    jstep = japi.step_fn(cfg_j.shape(shape))
    model = _port_model(name)
    step = api.step_fn(spec)
    if spec.kind == "training":
        (loss_j, _), g_j = jax.jit(jax.value_and_grad(
            jstep, has_aux=True))(jax.tree.map(jnp.asarray, tree), batch)
        loss, metrics = step(model, _torch_batch(batch))
        loss.backward()
        _assert_close(loss.item(), float(loss_j))
        if name == "mind":          # the in-batch logits move the loss
            b = len(batch["target"])
            assert abs(float(loss_j) - np.log(b)) >= 100 * TOL
        assert metrics["nll"].item() == loss.item()
        _assert_grads_close(params_to_numpy(model, grads=True),
                            jax.tree.map(np.asarray, g_j))
        return
    want = jax.jit(jstep)(jax.tree.map(jnp.asarray, tree), batch)
    with torch.no_grad():
        got = step(model, _torch_batch(batch))
    if isinstance(want, tuple):               # MIND's (scores, ids)
        _assert_close(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        return
    _assert_close(got.numpy(), want)


def test_dien_ragged_history():
    """hist_len 1, S and between: the GRUs stop at each row's length,
    the attention masks the rest, and the bag mean divides by it."""
    cfg_j, cfg, tree, offsets = reduced("dien")
    rng = np.random.default_rng(5)
    s = cfg.seq_len
    b = 6
    batch = {"hist": rng.integers(0, 128, size=(b, s)).astype(np.int32),
             "hist_len": np.array([1, s, 3, 1, s - 1, 2], np.int32),
             "target": rng.integers(0, 128, size=b).astype(np.int32),
             "labels": rng.integers(0, 2, size=b).astype(np.float32)}
    params = jax.tree.map(jnp.asarray, tree)
    want = jax.jit(lambda p, bt: JR.dien_fwd(p, bt, cfg_j, offsets))(
        params, batch)
    model = _port_model("dien")
    got = R.dien_fwd(model, _torch_batch(batch), cfg, offsets)
    _assert_close(got.detach().numpy(), want)
    # a row's output ignores its history past hist_len
    batch2 = dict(batch, hist=batch["hist"].copy())
    batch2["hist"][0, 1:] = (batch2["hist"][0, 1:] + 7) % 128
    got2 = R.dien_fwd(model, _torch_batch(batch2), cfg, offsets)
    assert float(got2[0]) == float(got[0])
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda p, bt: JR.loss_fn(p, bt, cfg_j, offsets), has_aux=True))(
            params, batch)
    loss, _ = R.loss_fn(model, _torch_batch(batch), cfg, offsets)
    loss.backward()
    _assert_close(loss.item(), float(loss_j))
    _assert_grads_close(params_to_numpy(model, grads=True),
                        jax.tree.map(np.asarray, g_j))


def test_mind_interests_and_capsule_norms():
    cfg_j, cfg, tree, _ = reduced("mind")
    rng = np.random.default_rng(9)
    b, s = 5, cfg.seq_len
    hist = rng.integers(0, 128, size=(b, s)).astype(np.int32)
    hist_len = np.array([1, s, 4, 2, s], np.int32)
    want = JR.mind_user_interests(jax.tree.map(jnp.asarray, tree), hist,
                                  hist_len, cfg_j)
    model = _port_model("mind")
    got = R.mind_user_interests(model, torch.from_numpy(hist),
                                torch.from_numpy(hist_len), cfg)
    assert got.shape == (b, cfg.n_interests, cfg.embed_dim)
    _assert_close(got.detach().numpy(), want)
    norms = torch.linalg.vector_norm(got, dim=-1)
    assert bool((norms < 1.0).all()), norms


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_mind_serves_bf16_weights_as_the_reference(shape):
    """Serving weights in bf16 (the dry run's serving policy): the fp32
    routing weights meet the bf16 table in the capsule products, which
    promote to fp32 in both packages (the port refused the mixed
    einsum before).  Within a bf16 step of the largest score."""
    cfg_j, cfg, tree, _ = reduced("mind")
    japi, api = JA.get_api(cfg_j), A.get_api(cfg)
    batch = {k: np.asarray(v)
             for k, v in japi.demo_batch(cfg_j.shape(shape), 3).items()}
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want = jax.jit(japi.step_fn(cfg_j.shape(shape)))(bf16, batch)
    model = _port_model("mind").to(torch.bfloat16)
    with torch.no_grad():
        got = api.step_fn(cfg.shape(shape))(model, _torch_batch(batch))
    got, want = (got[0], want[0]) if isinstance(want, tuple) else (got, want)
    assert got.dtype == torch.float32
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale >= 100 * TOL, scale
    assert float(np.abs(got.numpy() - want).max()) <= 2.0 ** -7 * scale


@pytest.mark.parametrize("n", [1_000_000, 1 << 20])
def test_mind_top_k_ties_go_to_the_lowest_index(n):
    """Candidates drawn from the reduced 128-row vocab repeat thousands
    of times, so the top 100 are exact ties: both packages take the
    lowest positions.  n = 2^20 is the reference's two-stage route."""
    cfg_j, cfg, tree, offsets = reduced("mind")
    rng = np.random.default_rng(n % 1000)
    batch = {"hist": rng.integers(0, 128, size=(1, cfg.seq_len)
                                  ).astype(np.int32),
             "hist_len": np.array([cfg.seq_len], np.int32),
             "candidates": rng.integers(0, 128, size=n).astype(np.int32)}
    vals_j, ids_j = JR.mind_score_candidates(
        jax.tree.map(jnp.asarray, tree), batch, cfg_j, offsets)
    with torch.no_grad():
        vals, ids = R.mind_score_candidates(_port_model("mind"),
                                            _torch_batch(batch), cfg,
                                            offsets)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    _assert_close(vals.numpy(), vals_j)
    top = batch["candidates"][ids.numpy()[0]]
    assert len(set(top.tolist())) == 1       # one candidate row, tied
    assert np.all(np.diff(ids.numpy()[0]) > 0)


@pytest.mark.parametrize("seed", range(3))
def test_topk_lowest_index_is_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(3, 777)).astype(np.float32)
    vals_j, ids_j = jax.lax.top_k(jnp.asarray(x), 50)
    vals, ids = R.topk_lowest_index(torch.from_numpy(x), 50)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))


def test_embedding_bag_mean():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, size=(5, 7)).astype(np.int32)
    lengths = np.array([0, 7, 1, 3, 7], np.int32)
    want = JR.embedding_bag_mean(jnp.asarray(table), ids, lengths)
    got = R.embedding_bag_mean(torch.from_numpy(table),
                               torch.from_numpy(ids),
                               torch.from_numpy(lengths))
    _assert_close(got.numpy(), want)
    assert float(got[0].abs().max()) == 0.0   # an empty bag pools to 0


def test_fused_table_layout():
    cfg = get_arch("dcn-v2")
    table, offsets = R.fused_table_init(torch.Generator().manual_seed(0),
                                        (5, 7, 300), 4)
    assert table.shape == (512, 4) and offsets.tolist() == [0, 5, 12]
    assert offsets.dtype == np.int64
    _, jax_off = JR.fused_table_init(jax.random.PRNGKey(0), (5, 7, 300), 4)
    np.testing.assert_array_equal(offsets, jax_off)
    # the full configs' table rows: 13,130,240 and 14,313,216 + padding
    assert R.ceil_to(sum(cfg.vocab_sizes), 256) == 13_130_240
    assert R.ceil_to(sum(get_arch("deepfm").vocab_sizes), 256) == \
        14_313_216


def _deepfm_steps(n_microbatches, n_steps, batch_seed=4):
    cfg_j, cfg, tree, offsets = reduced("deepfm")
    shape = cfg_j.shape("train_batch")
    rng = np.random.default_rng(batch_seed)
    b = 8
    batch = {"sparse": np.stack([rng.integers(0, v, size=b)
                                 for v in cfg.vocab_sizes],
                                axis=1).astype(np.int32),
             "labels": rng.integers(0, 2, size=b).astype(np.float32)}
    jstep = jax.jit(jax_train_step(
        JA.get_api(cfg_j).step_fn(shape), base_lr=1e-2,
        n_microbatches=n_microbatches))
    params = jax.tree.map(jnp.asarray, tree)
    jopt = jax_opt_init(params)
    model = params_from_numpy(tree, cfg, device=CPU)
    step = make_train_step(A.get_api(cfg).step_fn(cfg.shape("train_batch")),
                           base_lr=1e-2, n_microbatches=n_microbatches)
    opt = opt_init(model)
    for _ in range(n_steps):
        params, jopt, jm = jstep(params, jopt, batch)
        model, opt, m = step(model, opt, _torch_batch(batch))
        _assert_close(float(m["loss"]), float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * max(1.0, float(jm["grad_norm"]))
        got, want = _leaves(params_to_numpy(model)), \
            _leaves(jax.tree.map(np.asarray, params))
        for k in want:
            _assert_close(got[k], want[k])
    return float(m["loss"])


def test_deepfm_train_steps_match_reference():
    _deepfm_steps(n_microbatches=1, n_steps=3)


def test_deepfm_step_at_two_microbatches_matches_reference():
    """A RecSys batch has no ``tokens``: each leaf is cut along its own
    leading axis (this raised ``KeyError`` before)."""
    _deepfm_steps(n_microbatches=2, n_steps=1)
