"""Checkpointing (``checkpoint/store.py``) and checkpointed training
(``train/loop.py``) in the PyTorch port, on the CPU.

The first group is the port's counterpart of ``tests/test_checkpoint.py``
and of the checkpoint cases of ``tests/test_train_infra.py``: digests,
torn writes, template shape and missing-key errors, async mutation
safety (numpy and tensor leaves), error propagation on ``wait``,
keep-last-k rotation.  The second holds the on-disk layout to the JAX
package's: the same path keys for dicts, lists, tuples, NamedTuples and
``None``, and a checkpoint written by either package loads in the
other with keys, manifests and arrays equal.  The last runs the
training loop to six steps unbroken, and stopped at a checkpoint then
resumed: losses, weights, both moments and the optimizer step equal
bitwise.
"""
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jckpt

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, \
    load_manifest, save_checkpoint
from repro_torch.checkpoint import store as tckpt
from repro_torch.configs.llama3_8b import llama3_8b
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.models import transformer as T
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWState


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
            "names": np.asarray(["alpha", "beta"]),
            "steps": np.arange(5, dtype=np.int64)}


def _tensor_tree(seed: int = 0):
    return {k: torch.from_numpy(v) if v.dtype.kind != "U" else v
            for k, v in _tree(seed).items()}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]),
                                      np.asarray(b[k]))


# ---------------------------------------------------------------------------
# the JAX package's checkpoint contracts, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_tree, _tensor_tree],
                         ids=["numpy", "tensor"])
def test_save_load_roundtrip_with_digests(tmp_path, make):
    tree = make()
    save_checkpoint(tmp_path, 3, tree, extra={"note": "hello"})
    step, by_key, extra = load_checkpoint(tmp_path)
    assert step == 3 and extra == {"note": "hello"}
    got = {k.strip("[']"): v for k, v in by_key.items()}
    _assert_tree_equal(_tree(), got)
    template = {k: 0 for k in tree}
    step, restored, _ = load_checkpoint(tmp_path, template=template)
    _assert_tree_equal(_tree(), restored)
    assert load_manifest(tmp_path) == (3, {"note": "hello"})


def test_digest_mismatch_detected(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    final = tmp_path / "step-00000001"
    manifest = json.loads((final / "manifest.json").read_text())
    key = next(iter(manifest["arrays"]))
    manifest["arrays"][key]["digest"] = "0" * 16   # torn write
    (final / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(IOError):
        load_checkpoint(tmp_path)


def test_torn_tmp_write_is_never_the_latest(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(1))
    (tmp_path / "step-00000002.tmp").mkdir()    # a crashed write
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    step, by_key, _ = load_checkpoint(tmp_path)
    assert step == 1
    np.testing.assert_array_equal(by_key["['w']"], _tree(1)["w"])
    # the next save of that step replaces the torn directory
    mgr.save(2, _tree(2))
    assert mgr.steps() == [1, 2]
    assert not (tmp_path / "step-00000002.tmp").exists()


@pytest.mark.parametrize("make", [_tree, _tensor_tree],
                         ids=["numpy", "tensor"])
def test_template_shape_mismatch_and_missing_key(tmp_path, make):
    save_checkpoint(tmp_path, 1, _tree())
    bad = dict(make())
    bad["w"] = torch.zeros(9, 9) if make is _tensor_tree \
        else np.zeros((9, 9), np.float32)
    with pytest.raises(ValueError):
        load_checkpoint(tmp_path, template=bad)
    extra_key = dict(make())
    extra_key["missing"] = np.zeros((1,))
    with pytest.raises(KeyError):
        load_checkpoint(tmp_path, template=extra_key)


def test_template_restore_puts_tensors_on_their_device(tmp_path):
    tree = {"w": np.ones((4, 2), np.float32), "s": np.int32(3),
            "opt": AdamWState(7, [np.full(3, 2.0, np.float32)],
                              [np.full(3, 5.0, np.float32)])}
    save_checkpoint(tmp_path, 1, tree)
    template = {"w": torch.zeros(4, 2), "s": 0,
                "opt": AdamWState(0, [torch.zeros(3)], [torch.zeros(3)])}
    _, restored, _ = load_checkpoint(tmp_path, template=template)
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], torch.ones(4, 2))
    assert isinstance(restored["opt"], AdamWState)
    assert int(restored["opt"].step) == 7 and int(restored["s"]) == 3
    assert torch.equal(restored["opt"].nu[0], torch.full((3,), 5.0))


def test_async_save_wait_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    assert mgr.latest_step() is None
    assert mgr.steps() == []
    tree = _tensor_tree()
    mgr.save_async(1, tree, extra={"k": 1})
    mgr.wait()
    assert mgr.latest_step() == 1
    step, by_key, extra = load_checkpoint(tmp_path)
    assert step == 1 and extra == {"k": 1}
    mgr.save_async(2, tree)     # a second save_async waits for the first
    mgr.save_async(3, tree)
    mgr.wait()
    assert mgr.steps() == [1, 2, 3]


@pytest.mark.parametrize("make", [_tree, _tensor_tree],
                         ids=["numpy", "tensor"])
def test_async_snapshot_is_mutation_safe(tmp_path, make):
    """save_async copies to the host at once: mutating the tree right
    after the call (a CPU tensor's storage included) must not reach the
    write."""
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = make()
    want = {k: np.array(v, copy=True) for k, v in _tree().items()}
    mgr.save_async(1, tree)
    tree["w"][:] = -1.0
    mgr.wait()
    _, restored, _ = load_checkpoint(tmp_path,
                                     template={k: 0 for k in want})
    np.testing.assert_array_equal(restored["w"], want["w"])


def test_keep_rotation_prunes_old_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 6):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [4, 5]
    step, _, _ = load_checkpoint(tmp_path)
    assert step == 5
    load_checkpoint(tmp_path, step=4)
    # the async writer rotates too
    m = CheckpointManager(tmp_path / "async", keep=2)
    for s in (1, 2, 3, 4):
        m.save_async(s, {"x": torch.full((4,), float(s))})
    m.wait()
    assert m.steps() == [3, 4] and m.latest_step() == 4


def test_async_error_propagates_on_wait(tmp_path):
    target = tmp_path / "not-a-dir"
    target.write_text("file in the way")
    mgr = CheckpointManager(target / "ckpt", keep=2)
    mgr.save_async(1, _tree())
    with pytest.raises(BaseException):
        mgr.wait()
    mgr.wait()      # the error is cleared: the manager is reusable
    mgr2 = CheckpointManager(tmp_path / "ok", keep=2)
    mgr2.save_async(1, _tree())
    mgr2.wait()
    assert mgr2.latest_step() == 1


# ---------------------------------------------------------------------------
# the on-disk layout, against the JAX package
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    first: object
    second: object


def _nested(seed: int):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"zeta": [arr(2), (arr(3), arr(1, 2))],
            "alpha": {"b": arr(4), "a": np.int64(seed)},
            "shards": [{"buf": arr(2, 3), "row_ids": np.asarray(["x", "y"]),
                        "alive": np.asarray([True, False])}],
            "opt": _Pair(np.int32(5), [arr(2), arr(2)]),
            "skip": None, "ints": {10: arr(1), 2: arr(2)}}


def test_path_keys_equal_the_jax_flattener():
    tree = _nested(0)
    want = jckpt._flatten(tree)
    got = tckpt._flatten(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert "['shards']/[0]/['buf']" in dict(got)
    assert "['opt']/.second/[1]" in dict(got)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_packages(tmp_path, writer):
    tree = _nested(3)
    save = jckpt.save_checkpoint if writer == "jax" else save_checkpoint
    load_other = load_checkpoint if writer == "jax" \
        else jckpt.load_checkpoint
    load_same = jckpt.load_checkpoint if writer == "jax" \
        else load_checkpoint
    save(tmp_path, 4, tree, extra={"epoch": 2})
    step, other, extra = load_other(tmp_path)
    _, same, _ = load_same(tmp_path)
    assert step == 4 and extra == {"epoch": 2}
    assert list(other) == list(same)
    for key in same:
        assert other[key].dtype == same[key].dtype
        np.testing.assert_array_equal(other[key], same[key])
    # both packages write the same manifest (outside its time stamp)
    manifest = json.loads((tmp_path / "step-00000004" /
                           "manifest.json").read_text())
    save_other = save_checkpoint if writer == "jax" \
        else jckpt.save_checkpoint
    save_other(tmp_path / "other", 4, tree, extra={"epoch": 2})
    twin = json.loads((tmp_path / "other" / "step-00000004" /
                       "manifest.json").read_text())
    manifest.pop("time"), twin.pop("time")
    assert manifest == twin
    # template restores in the other package, into its own structure
    tmpl = {"alpha": {"a": 0, "b": 0}, "shards": [{"buf": 0}]}
    _, restored, _ = load_other(tmp_path, template=tmpl)
    np.testing.assert_array_equal(np.asarray(restored["shards"][0]["buf"]),
                                  tree["shards"][0]["buf"])


# ---------------------------------------------------------------------------
# checkpointed training: stopped, resumed, bitwise the unbroken run
# ---------------------------------------------------------------------------

def _train_setup():
    cfg = llama3_8b().reduced()
    loss = lambda m, b: T.loss_fn(m, b, cfg, compute_dtype=torch.float32)
    make = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=5)
    return cfg, loss, make


def _fresh(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(3))


def _moments_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def unbroken_run():
    cfg, loss, make = _train_setup()
    model = _fresh(cfg)
    res = run_training(loss, model, make,
                       LoopConfig(max_steps=6, base_lr=1e-2, log_every=0))
    return model, res


@pytest.mark.parametrize("stop,every", [(3, 3), (4, 2)],
                         ids=["blocking-save", "async-saves"])
def test_resumed_training_is_bitwise_the_unbroken_run(tmp_path, stop,
                                                      every, unbroken_run):
    cfg, loss, make = _train_setup()
    full_model, full = unbroken_run
    ck = str(tmp_path / "ck")
    first = run_training(loss, _fresh(cfg), make,
                         LoopConfig(max_steps=stop, ckpt_every=every,
                                    ckpt_dir=ck, base_lr=1e-2,
                                    log_every=0))
    assert first.losses == full.losses[:stop]
    assert CheckpointManager(ck).steps()[-1] == stop
    # a new process: fresh weights and optimizer, resumed in place
    model = _fresh(cfg)
    res = run_training(loss, model, make,
                       LoopConfig(max_steps=6, ckpt_every=100, ckpt_dir=ck,
                                  base_lr=1e-2, log_every=0),
                       resume=True)
    assert res.final_step == 6
    assert res.losses == full.losses[stop:]
    for a, b in zip(model.parameters(), full_model.parameters()):
        assert torch.equal(a, b)
    # the end-of-run checkpoint holds the moments and the step
    _, tree, extra = load_checkpoint(ck)
    assert extra == {"step": 6} and int(tree["['opt']/.step"]) == 6
    named = dict(model.named_parameters())
    for name, p in named.items():
        np.testing.assert_array_equal(tree[f"['params']/['{name}']"],
                                      p.detach().numpy())


def test_resume_restores_the_optimizer_state(tmp_path):
    """The moments and the step come back into the optimizer in place:
    after a resume with nothing left to run, the state loaded equals
    the state saved."""
    cfg, loss, make = _train_setup()
    ck = str(tmp_path / "ck")
    model = _fresh(cfg)
    run_training(loss, model, make,
                 LoopConfig(max_steps=2, ckpt_every=1, ckpt_dir=ck,
                            keep=1, base_lr=1e-2, log_every=0))
    assert CheckpointManager(ck).steps() == [2]
    _, tree, _ = load_checkpoint(ck)
    again = _fresh(cfg)
    res = run_training(loss, again, make,
                       LoopConfig(max_steps=2, ckpt_dir=ck, base_lr=1e-2,
                                  log_every=0), resume=True)
    assert res.final_step == 2 and res.losses == []
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    n = len(list(model.parameters()))
    for i in range(n):
        assert np.any(tree[f"['opt']/.mu/[{i}]"] != 0)
    # resuming with no checkpoint starts from step 0
    cold = run_training(loss, _fresh(cfg), make,
                        LoopConfig(max_steps=1, ckpt_dir=str(tmp_path / "e"),
                                   base_lr=1e-2, log_every=0), resume=True)
    assert cold.final_step == 1 and len(cold.losses) == 1
