"""Adafactor in the port (``train/optimizer.py``) against the JAX
package's, on the CPU, over the reduced deepseek-moe-16b's parameter
tree: the expert stacks (4-D once stacked over blocks), the stacked
norms (2-D, factored), ``final_norm`` (1-D, a full second moment) and
the fp32 router.

- Five ``adafactor_update`` calls on seeded gradients: weights and the
  ``vr``/``vc``/``v`` statistics within 1e-6 of the reference in fp32.
  With ``update_dtype=bfloat16`` the weights are rounded to bf16 at
  every step in both packages: within one bf16 step (2^-8 of the
  weight) of the reference's, the statistics (fp32) within 1e-6
  relative.
- ``make_train_step`` with 2 microbatches, ``accum_dtype`` fp32 and
  bf16, three steps against the JAX step.  fp32: losses within 1e-5,
  each weight's change and each statistic within 1e-4 of the
  reference's (relative Frobenius).  bf16 (stated below): losses within
  1e-3, each weight within two bf16 steps, each statistic within 5e-2.
- ``run_training(LoopConfig(optimizer="adafactor"))`` stopped at a
  checkpoint and resumed is bitwise the unbroken run; the optimizer
  state's checkpoint has the reference's path keys, and a JAX Adafactor
  checkpoint loads in the port and a port one in the JAX package, with
  equal manifests.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jckpt
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import optimizer as O
from repro_torch.train.loop import LoopConfig, run_training
from test_torch_moe import jax_reduced
from test_torch_train import _leaves, _rel_fro
from torch_threads import one_blas_thread  # noqa: F401

CPU = torch.device("cpu")
NAME = "deepseek-moe-16b"
STATE_TOL = 1e-6        # fp32: weights and statistics, absolute
BF16_STEP = 2.0 ** -8   # one bf16 step, relative to the weight
STEP_LOSS_RTOL = 1e-5
# bf16 accumulation and update: the weights are rounded to bf16 every
# step, and where the packages round a product apart by one bf16 step
# the next loss moves (1.04e-4 relative seen at step 3)
BF16_STEP_LOSS_RTOL = 1e-3
UPDATE_RTOL = 1e-4      # fp32 step: each weight's change, per leaf
# bf16 step: the grads are rounded to bf16 where the packages' fp32 sums
# differ in the last bits, and a flipped rounding moves the trajectory.
# Each weight within two bf16 steps (2^-7) of the reference's, relative
# Frobenius over the leaf (5.2e-3 seen, the embedding); each statistic
# within 5e-2 (relative Frobenius)
BF16_WEIGHT_RTOL = 2.0 ** -7
BF16_STATE_RTOL = 5e-2


@pytest.fixture(scope="module")
def reduced():
    return jax_reduced(NAME)


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * np.float32(1e-2), tree)


def _state_leaves(state):
    """(field/path, array) of an Adafactor state's statistics."""
    out = {}
    for field in ("vr", "vc", "v"):
        for path, a in _leaves(getattr(state, field)).items():
            out[field + path] = a
    return out


def _port_state(state):
    return {f: jax.tree.map(lambda t: t.numpy(), getattr(state, f))
            for f in ("vr", "vc", "v")}


def test_state_layout_is_the_reference_tree(reduced):
    cfg_j, cfg, tree = reduced
    want = JO.adafactor_init(tree)
    model = params_from_numpy(tree, cfg, device=CPU)
    got = O.opt_init(model, "adafactor")
    assert got.step == 0 and int(want.step) == 0
    for field in ("vr", "vc", "v"):
        w = _leaves(getattr(want, field))
        g = _leaves(_port_state(got)[field])
        assert list(g) == list(w)
        for path in w:
            assert g[path].shape == w[path].shape, (field, path)
    # the expert stacks are 4-D once stacked, the norms 2-D
    assert tree["layers"][0]["ffn"]["w_gate"].ndim == 4
    assert tree["layers"][0]["ln1"].ndim == 2
    assert tree["final_norm"].ndim == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_five_updates_match_reference(reduced, dtype):
    cfg_j, cfg, tree = reduced
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(jnp.asarray, tree)
    js = JO.adafactor_init(jp)
    update = jax.jit(lambda p, g, s, lr: JO.adafactor_update(
        p, g, s, lr=lr, update_dtype=jdtype))
    model = params_from_numpy(tree, cfg, device=CPU)
    params = O.adafactor_params(model)
    state = O.adafactor_init(params)
    for step in range(5):
        g = _grads(tree, step)
        lr = 1e-2 * (step + 1)
        jp, js, _ = update(jp, jax.tree.map(jnp.asarray, g), js,
                           jnp.float32(lr))
        gt = jax.tree.map(torch.from_numpy, g)
        _, state, _ = O.adafactor_update(params, gt, state, lr=lr,
                                         update_dtype=dtype)
    assert state.step == int(js.step) == 5
    got, want = _leaves(params_to_numpy(model)), _leaves(jp)
    start = _leaves(tree)
    for path in want:
        assert np.any(want[path] != start[path]), path
        err = np.abs(got[path] - want[path])
        if dtype == torch.float32:
            assert err.max() <= STATE_TOL, (path, err.max())
        else:
            assert np.all(err <= BF16_STEP * np.abs(want[path]) + 1e-30), \
                (path, err.max())
    gs = _state_leaves(type(js)(0, **_port_state(state)))
    ws = _state_leaves(js)
    assert list(gs) == list(ws)
    for path in ws:
        scale = 1.0 if dtype == torch.float32 else \
            max(float(np.abs(ws[path]).max()), 1e-30)
        assert np.abs(gs[path] - ws[path]).max() <= STATE_TOL * scale, path


def _jax_steps(cfg_j, tree, make, accum, n=3):
    step = jax.jit(JO.make_train_step(
        lambda p, b: JT.loss_fn(p, b, cfg_j, compute_dtype=jnp.float32),
        lr_schedule=JO.cosine_schedule(1e-2, 1, n), n_microbatches=2,
        optimizer="adafactor", accum_dtype=accum))
    params = jax.tree.map(jnp.asarray, tree)
    opt = JO.opt_init(params, "adafactor")
    losses = []
    for i in range(n):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in
                                            make(i).items()})
        losses.append(float(m["loss"]))
    return losses, params, opt


@pytest.mark.parametrize("accum", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_train_step_matches_reference(reduced, accum):
    cfg_j, cfg, tree = reduced
    make = synthetic_lm_batches(cfg.vocab_size, 4, 16, seed=3)
    want_losses, jp, js = _jax_steps(
        cfg_j, tree, make, jnp.float32 if accum == torch.float32
        else jnp.bfloat16)
    step = O.make_train_step(
        lambda m, b: T.loss_fn(m, b, cfg, compute_dtype=torch.float32),
        lr_schedule=O.cosine_schedule(1e-2, 1, 3), n_microbatches=2,
        optimizer="adafactor", accum_dtype=accum)
    model = params_from_numpy(tree, cfg, device=CPU)
    opt = O.opt_init(model, "adafactor")
    losses = []
    for i in range(3):
        model, opt, m = step(model, opt, make(i))
        losses.append(float(m["loss"]))
    assert opt.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_LOSS_RTOL
                               if accum == torch.float32 else
                               BF16_STEP_LOSS_RTOL)
    start, got = _leaves(tree), _leaves(params_to_numpy(model))
    want = _leaves(jp)
    for path in want:
        moved = want[path] - start[path]
        assert np.linalg.norm(moved) > 0, path
        if accum == torch.float32:
            assert _rel_fro(got[path] - start[path], moved) <= \
                UPDATE_RTOL, path
        else:
            assert _rel_fro(got[path], want[path]) <= BF16_WEIGHT_RTOL, path
    gs = _state_leaves(type(js)(0, **_port_state(opt)))
    ws = _state_leaves(js)
    for path in ws:
        assert _rel_fro(gs[path], ws[path]) <= (
            UPDATE_RTOL if accum == torch.float32 else BF16_STATE_RTOL), path


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _loss(cfg):
    return lambda m, b: T.loss_fn(m, b, cfg, compute_dtype=torch.float32)


RESUME_LOOP = dict(base_lr=1e-2, log_every=0, optimizer="adafactor",
                   n_microbatches=2)


@pytest.fixture(scope="module")
def unbroken(reduced):
    """The 6 steps unbroken, once for both resume cases: (the run's
    result, the trained model)."""
    _, cfg, tree = reduced
    model = params_from_numpy(tree, cfg, device=CPU)
    make = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=5)
    return run_training(_loss(cfg), model, make,
                        LoopConfig(max_steps=6, **RESUME_LOOP)), model


@pytest.mark.parametrize("stop,every", [(3, 3), (4, 2)],
                         ids=["blocking-save", "async-saves"])
def test_adafactor_resume_is_bitwise_the_unbroken_run(tmp_path, reduced,
                                                      unbroken, stop,
                                                      every):
    _, cfg, tree = reduced
    make = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=5)
    loop = RESUME_LOOP
    full, full_model = unbroken
    ck = str(tmp_path / "ck")
    first = run_training(_loss(cfg), params_from_numpy(tree, cfg, device=CPU),
                         make, LoopConfig(max_steps=stop, ckpt_every=every,
                                          ckpt_dir=ck, **loop))
    assert first.losses == full.losses[:stop]
    model = params_from_numpy(tree, cfg, device=CPU)
    res = run_training(_loss(cfg), model, make,
                       LoopConfig(max_steps=6, ckpt_every=100, ckpt_dir=ck,
                                  **loop), resume=True)
    assert res.final_step == 6 and res.losses == full.losses[stop:]
    for a, b in zip(model.parameters(), full_model.parameters()):
        assert torch.equal(a, b)
    _, saved, extra = load_checkpoint(ck)
    assert extra == {"step": 6}
    assert saved["['opt']/.step"].dtype == np.int32 and \
        int(saved["['opt']/.step"]) == 6
    # the statistics' keys are the reference's (field, then the tree)
    keys = {k for k in saved if k.startswith("['opt']/.v")}
    ref = jckpt._flatten({"opt": JO.adafactor_init(tree)})
    assert keys == {k for k, _ in ref if k.startswith("['opt']/.v")}


def _stepped_states(tree, cfg):
    """The JAX state after two updates, and the port's state holding the
    same arrays (copied in)."""
    jp = jax.tree.map(jnp.asarray, tree)
    js = JO.adafactor_init(jp)
    update = jax.jit(lambda p, g, s: JO.adafactor_update(p, g, s, lr=1e-2))
    for step in range(2):
        jp, js, _ = update(jp, jax.tree.map(jnp.asarray,
                                            _grads(tree, 10 + step)), js)
    js = jax.tree.map(np.asarray, js)
    model = params_from_numpy(tree, cfg, device=CPU)
    ps = O.opt_init(model, "adafactor")
    for dst, src in zip(O.tree_leaves([ps.vr, ps.vc, ps.v]),
                        jax.tree.leaves([js.vr, js.vc, js.v])):
        dst.copy_(torch.from_numpy(np.array(src)))
    return js, ps._replace(step=2), model


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adafactor_checkpoint_crosses_between_packages(tmp_path, reduced,
                                                       writer):
    cfg_j, cfg, tree = reduced
    js, ps, model = _stepped_states(tree, cfg)
    jtree = {"opt": js}
    ptree = {"opt": ps._replace(step=np.int32(ps.step))}
    jckpt.save_checkpoint(tmp_path / "jax", 2, jtree)
    save_checkpoint(tmp_path / "port", 2, ptree)
    manifests = [json.loads((tmp_path / w / "step-00000002" /
                             "manifest.json").read_text())
                 for w in ("jax", "port")]
    for m in manifests:
        m.pop("time")
    assert manifests[0] == manifests[1]
    # each loads the other's into its own state, bitwise
    if writer == "jax":
        template = {"opt": O.opt_init(model, "adafactor")}
        _, got, _ = load_checkpoint(tmp_path / "jax", template=template)
        assert int(got["opt"].step) == 2
        for a, b in zip(O.tree_leaves([got["opt"].vr, got["opt"].vc,
                                       got["opt"].v]),
                        jax.tree.leaves([js.vr, js.vc, js.v])):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        template = {"opt": JO.adafactor_init(jax.tree.map(jnp.asarray,
                                                          tree))}
        _, got, _ = jckpt.load_checkpoint(tmp_path / "port",
                                          template=template)
        assert int(got["opt"].step) == 2
        for a, b in zip(jax.tree.leaves([got["opt"].vr, got["opt"].vc,
                                         got["opt"].v]),
                        O.tree_leaves([ps.vr, ps.vc, ps.v])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
