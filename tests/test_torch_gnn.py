"""GatedGCN of the port against the JAX package's, on the CPU.

Weights drawn by the JAX package (``init_params``, key 0) and carried
over with ``params_from_numpy``; inputs the reference's ``demo_batch``
draws.  Both packages run the node and edge streams in bf16, rounding
in other places (the port sums each segment in fp32 and rounds once;
the reference sums in bf16), so:
- ``forward``, ``loss_fn``, ``batched_graph_forward`` and the losses
  of 3 AdamW steps are within 2e-2 of the largest magnitude;
- each package's logits, and each leaf of the loss's gradient (the
  reference's from ``jax.grad``), against an fp64 evaluation of the
  same model (float64 ops, no bf16 rounding): the port's error is at
  most 1.5x the reference's.  bf16 streams leave both packages'
  gradients several percent from the fp64 one, so the two are not
  held to each other at 2e-2.
``NeighborSampler``'s draws are bitwise the reference's.  The port's
own properties: the 4-layer checkpoint groups give the loss and
gradients bitwise of a run without them, and the fixed-order segment
sum and its gather backward agree with an fp64 scatter.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as jax_get_arch
from repro.models import api as JA
from repro.models import gnn as JG
from repro.train.optimizer import make_train_step as jax_train_step
from repro.train.optimizer import opt_init as jax_opt_init
from repro_torch.common.registry import get_arch
from repro_torch.models import api as A
from repro_torch.models import gnn as G
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train.optimizer import make_train_step, opt_init
from torch_threads import one_blas_thread  # noqa: F401

CPU = torch.device("cpu")
BF16_TOL = 2e-2     # of the largest magnitude: bf16 streams in both
ERR_RATIO = 1.5     # port's fp64 error over the reference's, at most


@functools.lru_cache(maxsize=None)
def setup(n_layers=2, d_feat=128):
    """(JAX config, port config, the reference's weights as numpy) of
    the reduced gatedgcn at ``n_layers``."""
    cfg_j = dataclasses.replace(jax_get_arch("gatedgcn").reduced(),
                                n_layers=n_layers)
    cfg = dataclasses.replace(get_arch("gatedgcn").reduced(),
                              n_layers=n_layers)
    params = jax.jit(lambda k: JG.init_params(cfg_j, k, d_feat)[0])(
        jax.random.PRNGKey(0))
    return cfg_j, cfg, jax.tree.map(np.asarray, params)


def _batch(cfg_j, seed=0):
    batch = JA.get_api(cfg_j).demo_batch(cfg_j.shape("full_graph_sm"),
                                         seed)
    return {k: np.array(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _fp64(tree, batch, n_layers):
    """(logits, the masked loss's gradient tree) of the model in float64
    ops: no bf16 rounding anywhere."""
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float64),
                                            requires_grad=True), tree)
    src, dst = (torch.from_numpy(i.astype(np.int64))
                for i in batch["edge_index"])
    n = batch["node_feat"].shape[0]

    def norm(x, w):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * w

    def seg(x):
        return torch.zeros((n,) + x.shape[1:], dtype=x.dtype
                           ).index_add(0, dst, x)

    h = torch.from_numpy(batch["node_feat"]).double() @ p["enc_h"]
    e = torch.ones((len(src), 1), dtype=torch.float64) @ p["enc_e"]
    for i in range(n_layers):
        lp = {k: v[i] for k, v in p["layers"].items()}
        e_new = h[dst] @ lp["D"] + h[src] @ lp["E"] + e @ lp["C"]
        eta = torch.sigmoid(e_new)
        agg = seg(eta * (h[src] @ lp["B"]))
        h_new = h @ lp["A"] + agg / (seg(eta) + G.EPS)
        h = h + torch.relu(norm(h_new, lp["ln_h"]))
        e = e + torch.relu(norm(e_new, lp["ln_e"]))
    logits = h @ p["head"]
    labels = torch.from_numpy(batch["labels"].astype(np.int64))
    mask = torch.from_numpy(batch["label_mask"])
    nll = torch.logsumexp(logits, -1) - \
        logits.gather(1, labels[:, None])[:, 0]
    (torch.where(mask, nll, 0.0).sum() / mask.sum().clamp_min(1)
     ).backward()
    return logits.detach().numpy(), jax.tree.map(lambda t: t.grad.numpy(),
                                                 p)


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BF16_TOL * scale, \
        (float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference_and_fp64(seed):
    cfg_j, cfg, tree = setup()
    batch = _batch(cfg_j, seed)
    want = np.asarray(jax.jit(lambda p, b: JG.forward(
        p, b["node_feat"], b["edge_index"], cfg_j))(
            jax.tree.map(jnp.asarray, tree), batch))
    model = params_from_numpy(tree, cfg, device=CPU)
    with torch.no_grad():
        got = G.forward(model, torch.from_numpy(batch["node_feat"]),
                        torch.from_numpy(batch["edge_index"]), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    _close(got, want)
    exact, _ = _fp64(tree, batch, cfg.n_layers)
    err_port = float(np.abs(got - exact).max())
    err_ref = float(np.abs(want - exact).max())
    assert err_port <= ERR_RATIO * err_ref, (err_port, err_ref)


def test_loss_fn_matches_reference():
    cfg_j, cfg, tree = setup()
    batch = _batch(cfg_j, 2)
    batch["label_mask"][::3] = False
    shape = cfg_j.shape("full_graph_sm")
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        JA.get_api(cfg_j).step_fn(shape), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), batch)
    _, exact = _fp64(tree, batch, cfg.n_layers)
    model = params_from_numpy(tree, cfg, device=CPU)
    loss, m = A.get_api(cfg).step_fn(cfg.shape("full_graph_sm"))(
        model, _t(batch))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= BF16_TOL * abs(float(loss_j))
    assert m["nll"].item() == loss.item()
    grads = params_to_numpy(model, grads=True)
    assert sorted(grads["layers"]) == sorted(tree["layers"])
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, grads_j))[0])
    exact = dict(jax.tree_util.tree_flatten_with_path(exact)[0])
    assert len(got) == len(ref) == len(exact)

    def rel_fro(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    for path, g in got:
        assert g.shape == ref[path].shape and np.isfinite(g).all(), path
        err_port = rel_fro(g, exact[path])
        err_ref = rel_fro(np.asarray(ref[path], np.float64), exact[path])
        assert err_port <= ERR_RATIO * err_ref, \
            (jax.tree_util.keystr(path), err_port, err_ref)


def test_batched_graph_forward_matches_reference():
    cfg_j, cfg, tree = setup(d_feat=16)
    rng = np.random.default_rng(7)
    n_graphs, n_per, e_per = 4, 10, 24
    feat = rng.standard_normal((n_graphs * n_per, 16)).astype(np.float32)
    ei = np.concatenate([rng.integers(0, n_per, size=(2, e_per)) + g * n_per
                         for g in range(n_graphs)], axis=1).astype(np.int32)
    gid = np.repeat(np.arange(n_graphs), n_per).astype(np.int32)
    want = np.asarray(jax.jit(lambda p: JG.batched_graph_forward(
        p, feat, ei, gid, cfg_j, n_graphs))(jax.tree.map(jnp.asarray, tree)))
    model = params_from_numpy(tree, cfg, device=CPU)
    with torch.no_grad():
        got = G.batched_graph_forward(model, torch.from_numpy(feat),
                                      torch.from_numpy(ei),
                                      torch.from_numpy(gid), cfg, n_graphs)
    assert got.shape == (n_graphs, cfg.n_classes)
    _close(got.numpy(), want)


def test_train_steps_match_reference():
    """3 AdamW steps through both packages' ``make_train_step`` on one
    batch: each step's loss within the bf16 tolerance."""
    cfg_j, cfg, tree = setup()
    batch = _batch(cfg_j, 3)
    shape = cfg_j.shape("full_graph_sm")
    jstep = jax.jit(jax_train_step(JA.get_api(cfg_j).step_fn(shape),
                                   base_lr=1e-2))
    params = jax.tree.map(jnp.asarray, tree)
    jopt = jax_opt_init(params)
    model = params_from_numpy(tree, cfg, device=CPU)
    step = make_train_step(A.get_api(cfg).step_fn(cfg.shape(shape.name)),
                           base_lr=1e-2)
    opt = opt_init(model)
    losses = []
    for _ in range(3):
        params, jopt, jm = jstep(params, jopt, batch)
        model, opt, m = step(model, opt, _t(batch))
        losses.append(m["loss"].item())
        want = float(jm["loss"])
        assert abs(losses[-1] - want) <= BF16_TOL * abs(want)
    assert losses[-1] < losses[0]


def test_checkpoint_groups_are_bitwise_no_checkpoint():
    """8 layers = 2 groups of 4 under ``torch.utils.checkpoint``: the
    recomputed forward gives the same loss and gradients, bitwise."""
    cfg_j, cfg, tree = setup(n_layers=8)
    batch = _t(_batch(cfg_j, 4))
    out = []
    for remat in (4, 0):
        model = params_from_numpy(tree, cfg, device=CPU)
        loss, _ = G.loss_fn(model, batch, cfg, remat_group=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    (l4, g4), (l0, g0) = out
    assert torch.equal(l4, l0)
    assert all(torch.equal(a, b) for a, b in zip(g4, g0))


def test_segment_sum_and_gather_backward():
    rng = np.random.default_rng(1)
    n, e, d = 9, 40, 5
    idx = rng.integers(0, n - 2, size=e)           # two empty segments
    x = rng.standard_normal((e, d)).astype(np.float32)
    seg = G.segments(torch.from_numpy(idx), n)
    want = np.zeros((n, d))
    np.add.at(want, idx, x.astype(np.float64))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = G.segment_sum(xt, seg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    assert got[n - 2:].abs().max().item() == 0.0
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    got.backward(g)
    np.testing.assert_array_equal(xt.grad.numpy(), g.numpy()[idx])
    # gather's backward is the same segment sum
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                         ).requires_grad_(True)
    gathered = G.gather(h, seg)
    np.testing.assert_array_equal(gathered.detach().numpy(),
                                  h.detach().numpy()[idx])
    gathered.backward(torch.from_numpy(x))
    np.testing.assert_allclose(h.grad.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fanout", [(15, 10), (3, 2, 2)])
def test_neighbor_sampler_is_bitwise_the_reference(fanout):
    rng = np.random.default_rng(11)
    n, e = 3000, 40000
    ei = rng.integers(0, n, size=(2, e)).astype(np.int64)
    ei[1, :500] = 7                             # a high-degree node
    ours = G.NeighborSampler(n, ei, seed=5)
    theirs = JG.NeighborSampler(n, ei, seed=5)
    np.testing.assert_array_equal(ours.indptr, theirs.indptr)
    np.testing.assert_array_equal(ours.src_sorted, theirs.src_sorted)
    for seeds in (np.array([7, 1, 2, 7, 9]),
                  rng.integers(0, n, size=64)):
        for a, b in zip(ours.sample(seeds, fanout),
                        theirs.sample(seeds, fanout)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
