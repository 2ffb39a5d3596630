"""LM training-step parity: the port's configs, ``loss_fn``, gradients,
AdamW train step and loop against the JAX package's, on the CPU.

Weights are drawn by the JAX package (``init_params(PRNGKey(0))``) and
carried over with ``params_from_numpy``; gradients and updated weights
come back through ``params_to_numpy``.  Batches come from both packages'
``synthetic_lm_batches`` (bitwise equal).  On the CPU the port's
attention is its plain version, and the JAX step's is
``chunked_attention``; the card's kernels are held against the same
plain version in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch
from repro.data.pipeline import synthetic_lm_batches as jax_batches
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.common.config import LMConfig, MoEConfig, ShapeSpec
from repro_torch.configs.llama3_8b import llama3_8b
from repro_torch.configs.qwen2_7b import qwen2_7b
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import optimizer as O
from repro_torch.train.loop import LoopConfig, run_training

CPU = torch.device("cpu")
PORT_CONFIGS = {"llama3-8b": llama3_8b, "qwen2-7b": qwen2_7b}
LOSS_RTOL = 1e-5     # fp32 compute: loss, relative
GRAD_RTOL = 1e-4     # relative Frobenius error per gradient leaf
BF16_LOSS_RTOL = 1e-2  # bf16 compute: both round activations to bf16,
#                       in other places (the JAX step's chunked attention
#                       keeps bf16 operands, the port's attention fp32)


def _jax_cfg(name):
    return get_arch(name).reduced()


def _port_cfg(name):
    return PORT_CONFIGS[name]().reduced()


def _jax_params(cfg_j):
    params, _ = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port_of_jax_cfg(cfg_j) -> LMConfig:
    """The JAX config, field by field, as the port's class."""
    kw = {f.name: getattr(cfg_j, f.name)
          for f in dataclasses.fields(cfg_j)}
    kw["shapes"] = tuple(ShapeSpec(**dataclasses.asdict(s))
                         for s in cfg_j.shapes)
    if cfg_j.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(cfg_j.moe))
    return LMConfig(**kw)


def _leaves(tree):
    """(path, array) of every leaf of a parameter tree, sorted."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in flat}


def _rel_fro(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b"])
def test_configs_match_reference(name):
    want = _port_of_jax_cfg(get_arch(name))
    got = PORT_CONFIGS[name]()
    assert got == want
    assert got.reduced() == _port_of_jax_cfg(get_arch(name).reduced())
    assert got.param_count() == get_arch(name).param_count()
    assert got.d_head == 128 and got.shape("train_4k").seq_len == 4096


@pytest.mark.parametrize("name", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_configs_raise_not_ported(name):
    cfg = _port_of_jax_cfg(get_arch(name).reduced())
    assert cfg.is_moe
    assert cfg.param_count() == get_arch(name).reduced().param_count()
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match="MoE"):
        params_from_numpy({}, cfg, device=CPU)


@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (3, 7, 1, 2), (9, 123, 3, 4)])
def test_synthetic_batches_bitwise(seed, step, shard, n_shards):
    got = synthetic_lm_batches(1000, 8, 33, seed, shard, n_shards)(step)
    want = jax_batches(1000, 8, 33, seed, shard, n_shards)(step)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b"])
def test_weight_bridge_round_trips(name):
    tree = _jax_params(_jax_cfg(name))
    model = params_from_numpy(tree, _port_cfg(name), device=CPU)
    assert sum(p.numel() for p in model.parameters()) == \
        _port_cfg(name).param_count()
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(back).items(),
                                _leaves(tree).items()):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def _jax_loss_and_grads(cfg_j, tree, batch, dtype):
    params = jax.tree.map(jnp.asarray, tree)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, cfg_j, compute_dtype=dtype),
        has_aux=True)(params)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b"])
def test_loss_and_gradients_match_reference_fp32(name):
    cfg_j, cfg = _jax_cfg(name), _port_cfg(name)
    tree = _jax_params(cfg_j)
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 48, seed=1)(0)
    want_loss, want_grads = _jax_loss_and_grads(cfg_j, tree, batch,
                                                jnp.float32)
    model = params_from_numpy(tree, cfg, device=CPU)
    loss, metrics = T.loss_fn(model, batch, cfg,
                              compute_dtype=torch.float32)
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert float(metrics["aux"]) == 0.0
    got = _leaves(params_to_numpy(model, grads=True))
    want = _leaves(want_grads)
    assert got.keys() == want.keys()
    for path in want:
        assert _rel_fro(got[path], want[path]) <= GRAD_RTOL, path


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b"])
def test_loss_matches_reference_bf16(name):
    cfg_j, cfg = _jax_cfg(name), _port_cfg(name)
    tree = _jax_params(cfg_j)
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 48, seed=2)(0)
    want_loss, _ = _jax_loss_and_grads(cfg_j, tree, batch, jnp.bfloat16)
    model = params_from_numpy(tree, cfg, device=CPU)
    loss, _ = T.loss_fn(model, batch, cfg)          # bf16 by default
    assert abs(loss.item() - want_loss) <= BF16_LOSS_RTOL * want_loss


# Three AdamW steps at lr up to 1e-2: an update is ~lr * g / |g|, so a
# gradient element near 0 whose fp32 value differs in the last bits may
# move its weight differently.  The weights are held by the error of the
# whole change they made (relative Frobenius, per leaf; ~2e-6 measured).
# The key bias is the exception: a bias shared by every key shifts each
# query's scores by a constant, to which softmax is blind, so without
# RoPE its gradient is exactly 0; with RoPE it is a small difference of
# large terms, ~1e3 times noisier relative to its size (1.1e-3 measured).
STEP_LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-4
KEY_BIAS_UPDATE_RTOL = 5e-3


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b"])
def test_train_steps_match_reference(name):
    cfg_j, cfg = _jax_cfg(name), _port_cfg(name)
    tree = _jax_params(cfg_j)
    make = synthetic_lm_batches(cfg.vocab_size, 4, 32, seed=3)

    j_step = jax.jit(JO.make_train_step(
        lambda p, b: JT.loss_fn(p, b, cfg_j, compute_dtype=jnp.float32),
        lr_schedule=JO.cosine_schedule(1e-2, 2, 3), n_microbatches=2))
    params = jax.tree.map(jnp.asarray, tree)
    opt = JO.opt_init(params)
    want_losses = []
    for step in range(3):
        batch = {k: jnp.asarray(v) for k, v in make(step).items()}
        params, opt, m = j_step(params, opt, batch)
        want_losses.append(float(m["loss"]))

    p_step = O.make_train_step(
        lambda mdl, b: T.loss_fn(mdl, b, cfg, compute_dtype=torch.float32),
        lr_schedule=O.cosine_schedule(1e-2, 2, 3), n_microbatches=2)
    model = params_from_numpy(tree, cfg, device=CPU)
    popt = O.opt_init(model)
    losses = []
    for step in range(3):
        model, popt, m = p_step(model, popt, make(step))
        losses.append(float(m["loss"]))
    assert popt.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_LOSS_RTOL)

    start, got = _leaves(tree), _leaves(params_to_numpy(model))
    want = _leaves(jax.tree.map(np.asarray, params))
    for path in want:
        moved = want[path] - start[path]
        assert np.linalg.norm(moved) > 0, path   # every leaf trains
        tol = KEY_BIAS_UPDATE_RTOL if "'bk'" in path else UPDATE_RTOL
        assert _rel_fro(got[path] - start[path], moved) <= tol, path


def test_schedule_and_adamw_match_reference():
    lr_j, lr_p = JO.cosine_schedule(3e-4, 10, 100), \
        O.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        assert lr_p(step) == float(lr_j(jnp.int32(step))), step
    assert lr_p(0) == 0.0

    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    state_j = JO.adamw_init([jnp.asarray(p) for p in ps])
    tp = [torch.from_numpy(p.copy()) for p in ps]
    state_p = O.adamw_init(tp)
    pj = [jnp.asarray(p) for p in ps]
    for step in range(4):
        # large enough that the global-norm clip applies at step 0
        gs = [rng.standard_normal(s).astype(np.float32) * (3 - step)
              for s in shapes]
        pj, state_j, mj = JO.adamw_update(pj, [jnp.asarray(g) for g in gs],
                                          state_j, lr=1e-2)
        tp, state_p, mp = O.adamw_update(tp, [torch.from_numpy(g)
                                              for g in gs], state_p, lr=1e-2)
        np.testing.assert_allclose(float(mp["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        for a, b in zip(tp, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    assert state_p.step == int(state_j.step) == 4


def test_run_training_is_the_train_step_in_a_loop():
    cfg = _port_cfg("llama3-8b")
    tree = _jax_params(_jax_cfg("llama3-8b"))
    make = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=4)
    loss = lambda m, b: T.loss_fn(m, b, cfg, compute_dtype=torch.float32)
    model = params_from_numpy(tree, cfg, device=CPU)
    res = run_training(loss, model, make,
                       LoopConfig(max_steps=4, base_lr=1e-2, log_every=0))
    ref_model = params_from_numpy(tree, cfg, device=CPU)
    step, opt = O.make_train_step(loss, base_lr=1e-2), O.opt_init(ref_model)
    want = []
    for i in range(4):
        ref_model, opt, m = step(ref_model, opt, make(i))
        want.append(float(m["loss"]))
    assert res.final_step == 4 and res.losses == want
    assert len(res.step_s) == 4 and res.wall_time_s >= sum(res.step_s)
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)


def test_fixed_batch_loss_falls():
    """The reference's own check (tests/test_models_smoke.py): ten steps
    on one fixed batch must overfit it."""
    cfg = _port_cfg("llama3-8b")
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 32, seed=0)(0)
    res = run_training(lambda m, b: T.loss_fn(m, b, cfg), model,
                       lambda step: batch,
                       LoopConfig(max_steps=10, base_lr=1e-2,
                                  n_microbatches=2, log_every=0))
    assert all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0] * 0.9, res.losses


def test_init_params_scales_and_layout():
    cfg = dataclasses.replace(_port_cfg("qwen2-7b"), d_model=256, d_ff=512,
                              vocab_size=2048, n_heads=8, d_head=32)
    model = T.init_params(cfg, torch.Generator().manual_seed(1))
    assert model.layers[0].attn.wq.shape == (256, 8 * 32)      # (in, out)
    assert model.lm_head.shape == (256, 2048)
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    want = (2.0 / (256 + 512)) ** 0.5
    assert abs(float(model.layers[1].ffn.w_up.std()) - want) < 0.02 * want
    assert torch.equal(model.layers[0].attn.bq, torch.zeros(256))
    assert torch.equal(model.final_norm, torch.ones(256))


def test_unported_paths_raise(tmp_path):
    cfg = _port_cfg("llama3-8b")
    model = T.init_params(cfg, torch.Generator())
    # LM serving is ported (slice 11): the forward passes over a KV
    # cache run on the reduced config (their parity with the JAX
    # package is tests/test_torch_serving.py)
    tokens = torch.arange(4, 12)[None]
    logits, cache = T.prefill(model, tokens, cfg, max_len=9,
                              compute_dtype=torch.float32)
    assert logits.shape == (1, cfg.vocab_size)
    step, _ = T.decode_step(model, tokens[:, :1], cache, 8, cfg,
                            compute_dtype=torch.float32)
    assert torch.isfinite(step).all() and cache["k"][:, :, :, 8].any()
    p = model.layers[0].attn.params(torch.float32)
    x = torch.ones(1, 4, cfg.d_model)
    kv = {n: torch.zeros(1, cfg.n_kv_heads, 8, cfg.d_head)
          for n in ("k", "v")}
    with torch.no_grad():
        L.attention_fwd(p, x, cfg, torch.arange(4), kv_cache=kv,
                        cache_len=0)
    assert kv["k"][:, :, :4].any() and not kv["k"][:, :, 4:].any()
    with pytest.raises(NotImplementedError, match="Adafactor"):
        O.make_train_step(None, optimizer="adafactor")
    with pytest.raises(NotImplementedError, match="Adafactor"):
        O.opt_init(model, "adafactor")
    # checkpointed training is served (slice 12): a run with ckpt_dir
    # leaves its final step on disk (the resume parity is
    # tests/test_torch_checkpoint.py)
    ckpt_dir = tmp_path / "ck"
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=0)
    res = run_training(lambda m, b: T.loss_fn(m, b, cfg), model, batch,
                       LoopConfig(max_steps=1, ckpt_dir=str(ckpt_dir),
                                  log_every=0))
    assert res.final_step == 1
    assert (ckpt_dir / "step-00000001" / "manifest.json").is_file()


def test_rope_and_rmsnorm_match_reference():
    from repro.models.layers import apply_rope as j_rope, \
        rmsnorm as j_rms, rope_angles as j_angles
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    cj, sj = j_angles(jnp.asarray(pos), 16, 5e5)
    cp, sp = L.rope_angles(torch.from_numpy(pos), 16, 5e5)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-6)
    for dt_j, dt_p in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        xb = np.array(jnp.asarray(x, dt_j).astype(jnp.float32))
        want = j_rope(jnp.asarray(xb, dt_j), cj, sj)
        got = L.apply_rope(torch.from_numpy(xb).to(dt_p), cp, sp)
        assert got.dtype == dt_p
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=1e-5 if dt_p ==
                                   torch.float32 else 1.6e-2)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(j_rms(jnp.asarray(x), jnp.asarray(w))), rtol=0,
        atol=1e-5)
