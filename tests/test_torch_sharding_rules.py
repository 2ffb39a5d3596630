"""The port's logical sharding rules and the models' ``shard()``
constraints against the JAX package's, on the CPU (no subprocess, no
process group).

- For every architecture x shape on both production meshes, every
  weight, batch and optimizer-state leaf of the port's dry-run cell
  (``launch/dryrun._build_cell``) resolves to the spec the reference's
  ``_build_cell`` gives it on a ``jax.sharding.AbstractMesh``, leaf for
  leaf in the reference's order, with equal shapes and an equal
  ``fallbacks`` audit.
- Each family's rule table, and ``rules_for_family`` over every shape
  kind, map every logical name as the reference's do; a few specs with
  prefix fallbacks and consumed axes; the store's mesh helpers.
- ``placements``: a spec as DTensor placements (a dim over two axes is
  ``Shard`` on both, in mesh order).
- ``shard`` outside a context returns the same object; the reduced LM
  (dense and MoE), RecSys and GNN forward and backward are bitwise what
  they are with every ``shard`` call removed, and reach those calls;
  the MoE token count and the GNN's segment custom ops are bitwise the
  plain code they replaced.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.common import sharding as JS
from repro.common.registry import get_arch as jax_get_arch
from repro.common.registry import list_archs as jax_list_archs
from repro.launch import dryrun as JD
from repro.models import api as JA
from repro_torch.common import sharding as S
from repro_torch.common.registry import get_arch
from repro_torch.launch import dryrun as D
from repro_torch.models import api as A
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import sharding_ctx
from repro_torch.models import transformer as T
from torch_threads import one_blas_thread  # noqa: F401

ARCHS = jax_list_archs()
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("training", "inference-prefill", "inference-decode",
         "long-context-decode", "full-batch", "sampled-training",
         "full-batch-large", "batched-small-graphs", "online-inference",
         "offline-scoring", "retrieval-scoring")
NAMES = ("batch", "seq", "kv_seq", "embed", "mlp", "heads", "kv_heads",
         "qkv_fused", "head_dim", "vocab", "experts", "tokens",
         "expert_mlp", "expert_embed", "layers", "edges", "nodes",
         "node_feat", "hidden", "vocab_rows", "candidates", "db_shards",
         "db_rows", "qbatch", "topk", "embed_flags", "unknown")


def _fast_axes_tree(api):
    """The reference's ``_axes_tree`` without its real init of the
    reduced config: the axes ``init`` returns while ``eval_shape``
    traces it (the same tree)."""
    out = {}

    def params(k):
        p, out["axes"] = api.init(k)
        return p
    jax.eval_shape(params, jax.random.PRNGKey(0))
    return out["axes"]


def _ref_leaves(cfg, shape, mesh, rules):
    """(params, batch, opt) leaves of the reference's cell as (shape,
    spec) pairs, in its tree order."""
    api = JA.get_api(cfg)
    _, args, _ = JD._build_cell(cfg, shape, api, mesh, rules,
                                include_optimizer=True)

    def pairs(tree):
        return [(tuple(x.shape), tuple(x.sharding.spec))
                for x in jax.tree.leaves(tree)]
    opt = pairs(args[1]) if len(args) == 3 else []
    return pairs(args[0]), pairs(args[-1]), opt


def _port_leaves(cell):
    def pairs(leaves):
        return [(tuple(lf.shape), tuple(lf.spec)) for lf in leaves]
    return pairs([lf for lf, _ in cell.params]), pairs(cell.batch), \
        pairs(cell.opt)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_resolves_to_the_reference_spec(arch, mesh_name,
                                                   monkeypatch):
    monkeypatch.setattr(JD, "_axes_tree", _fast_axes_tree)
    sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    mesh = S.MeshShape(sizes, names)
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    api = A.get_api(cfg)
    for jshape in jcfg.shapes:
        shape = cfg.shape(jshape.name)
        jrules = JS.rules_for_family(jcfg.family, jshape.kind)
        rules = S.rules_for_family(cfg.family, shape.kind)
        ref = _ref_leaves(jcfg, jshape, jmesh, jrules)
        cell = D._build_cell(cfg, shape, api, mesh, rules,
                             include_optimizer=True)
        for part, r, p in zip(("params", "batch", "opt"), ref,
                              _port_leaves(cell)):
            assert p == r, (arch, jshape.name, part)
        assert rules.fallbacks == jrules.fallbacks, (arch, jshape.name)
        assert cell.n_micro == _ref_n_micro(jcfg, jshape, sizes, names)


def _ref_n_micro(cfg, shape, sizes, names):
    """The reference's microbatch cut (``dryrun.py:129-135``)."""
    pol = JD._train_policy(cfg)
    if shape.kind not in JD.TRAIN_KINDS:
        return 1
    n = pol["n_microbatches"]
    gb = getattr(shape, "global_batch", 0) or getattr(shape, "batch", 0)
    if gb:
        ax = dict(zip(names, sizes))
        n = max(1, min(n, gb // (ax.get("pod", 1) * ax["data"])))
        while gb % n:
            n -= 1
    return n


def _table(rules):
    return {n: rules.mesh_axes_for(n) for n in NAMES}


def test_family_rules_match_reference():
    pairs = [(S.lm_rules(), JS.lm_rules()),
             (S.lm_rules(decode=True), JS.lm_rules(decode=True)),
             (S.lm_rules(long_context=True), JS.lm_rules(long_context=True)),
             (S.gnn_rules(), JS.gnn_rules()),
             (S.recsys_rules(), JS.recsys_rules()),
             (S.recsys_rules(serving=True), JS.recsys_rules(serving=True)),
             (S.retrieval_rules(), JS.retrieval_rules())]
    for fam in ("lm-dense", "lm-moe", "gnn", "recsys"):
        for kind in KINDS + ("",):
            pairs.append((S.rules_for_family(fam, kind),
                          JS.rules_for_family(fam, kind)))
    for port, ref in pairs:
        assert _table(port) == _table(ref)
    ext = [("extra", ("model",)), ("batch", None)]
    assert _table(S.lm_rules().extend(ext)) == \
        _table(JS.lm_rules().extend(ext))
    with pytest.raises(ValueError):
        S.rules_for_family("vision")


@pytest.mark.parametrize("shape,axes", [
    ((32, 48, 128), ("batch", "heads", "kv_seq")),
    ((8, 40, 4096), ("batch", "heads", "embed")),      # 40 heads: fallback
    ((24, 4096), ("embed", "embed")),                   # data consumed once
    ((48, 64), ("tokens", "expert_mlp")),               # prefix fallback
    ((96,), ("edges",)), ((7, 3), ("unknown", None)), ((), ())])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_fallbacks_match_reference(shape, axes, mesh_name):
    sizes, names = MESHES[mesh_name]
    for port, ref in ((S.lm_rules(decode=True), JS.lm_rules(decode=True)),
                      (S.gnn_rules(), JS.gnn_rules())):
        got = port.spec(S.MeshShape(sizes, names), shape, axes)
        want = ref.spec(AbstractMesh(sizes, names), shape, axes)
        assert got == tuple(want)
        assert port.fallbacks == ref.fallbacks


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_store_mesh_helpers_match_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    mesh, jmesh = S.MeshShape(sizes, names), AbstractMesh(sizes, names)
    assert S.db_shard_axes(mesh) == JS.db_shard_axes(jmesh)
    assert S.db_axis_size(mesh) == JS.db_axis_size(jmesh) == 16
    dev_mesh = jax.sharding.Mesh(
        np.arange(int(np.prod(sizes))).reshape(sizes), names)
    for axes in (("data",), ("model",), ("data", "model")):
        assert S.mesh_axis_devices(mesh, axes) == \
            [int(d) for d in JS.mesh_axis_devices(dev_mesh, axes)]
    for n in (4, 16, 20, 32):
        assert S.shard_placements(mesh, n) == \
            [int(d) for d in JS.shard_placements(dev_mesh, n)]
    none = S.LogicalRules([("db_shards", None)])
    assert S.shard_placements(mesh, 3, none) == [None] * 3
    assert S.db_axis_size(None) == 1
    with pytest.raises(ValueError):
        S.stacked_db_shardings(S.MeshShape((4,), ("model",)))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = S.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert S.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements(mesh, (None, None)) == (Replicate(),) * 3
    assert S.named_sharding(mesh, "data", None) == \
        (Replicate(), Shard(0), Replicate())
    assert S.logical_sharding(mesh, S.lm_rules(), (64, 4096),
                              ("batch", "embed")) == \
        (Shard(0), Shard(0), Replicate())
    assert S.stacked_db_shardings(mesh) == \
        ((Replicate(), Shard(0), Replicate()),) * 2
    with pytest.raises(ValueError, match="mesh order"):
        S.placements(mesh, (("model", "data"),))
    assert S.local_shape(mesh, (64, 48, 7), (("pod", "data"), "model",
                                             None)) == (2, 3, 7)


def test_shard_outside_a_context_is_the_same_object():
    x = torch.randn(4, 8)
    assert sharding_ctx._current() is None
    assert sharding_ctx.shard(x, ("batch", "embed")) is x
    with sharding_ctx.activation_sharding(S.MeshShape((4,), ("data",)),
                                          S.lm_rules()):
        assert sharding_ctx.shard(x, ("batch", "embed")) is x   # not a DTensor
    assert sharding_ctx._current() is None


# ---------------------------------------------------------------------------
# the models are what they were without the constraints
# ---------------------------------------------------------------------------
MODULES = (L, T, G, R)


def _grads(model):
    return [p.grad.clone() for p in model.parameters() if p.grad is not None]


def _run(fn, model):
    for p in model.parameters():
        p.grad = None
    out = fn()
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()
    return out, _grads(model)


def _both_ways(fn, model, monkeypatch):
    """(outputs and gradients with ``shard`` as it is, the same with it
    removed, the calls it saw)."""
    calls = []

    def recording(x, axes):
        y = sharding_ctx.shard(x, axes)
        assert y is x
        calls.append(tuple(axes))
        return y
    with monkeypatch.context() as m:
        for mod in MODULES:
            if hasattr(mod, "shard"):
                m.setattr(mod, "shard", recording)
        got = _run(fn, model)
    with monkeypatch.context() as m:
        for mod in MODULES:
            if hasattr(mod, "shard"):
                m.setattr(mod, "shard", lambda x, axes: x)
        want = _run(fn, model)
    return got, want, calls


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_lm_forward_backward_bitwise_without_constraints(arch, monkeypatch):
    cfg = get_arch(arch).reduced()
    api = A.get_api(cfg)
    model, _ = api.init(torch.Generator().manual_seed(0))
    batch = api.demo_batch(cfg.shape("train_4k"), device="cpu")
    got, want, calls = _both_ways(lambda: T.loss_fn(model, batch, cfg),
                                  model, monkeypatch)
    assert _equal(got, want)
    assert ("batch", "seq", "embed") in calls and \
        ("batch", "seq", "vocab") in calls and L.KV_AXES in calls
    if cfg.is_moe:
        assert ("experts", None, None) in calls and \
            ("tokens", None) in calls
    # serving: decode through the cache
    dec = api.demo_batch(cfg.shape("decode_32k"), device="cpu")
    with torch.no_grad():
        a = T.decode_step(model, dec["tokens"], dec["caches"], 3, cfg)[0]
        b = T.decode_step(model, dec["tokens"],
                          {k: v.clone() for k, v in dec["caches"].items()},
                          3, cfg)[0]
    assert torch.equal(a, b)


def test_moe_token_count_is_the_bincount():
    cfg = get_arch("deepseek-moe-16b").reduced()
    g = torch.Generator().manual_seed(1)
    xf = torch.randn(64, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.moe.n_experts, generator=g)
    r = L.moe_route(router, xf, cfg.moe)
    probs = torch.softmax(xf @ router, dim=-1)
    frac = torch.bincount(r.gate_idx.reshape(-1),
                          minlength=cfg.moe.n_experts).to(torch.float32) / 64
    aux = cfg.moe.router_aux_coef * cfg.moe.n_experts * \
        torch.sum(frac * probs.mean(dim=0))
    assert torch.equal(r.aux, aux)


@pytest.mark.parametrize("arch", ["deepfm", "dcn-v2", "dien", "mind"])
def test_recsys_forward_backward_bitwise_without_constraints(arch,
                                                             monkeypatch):
    cfg = get_arch(arch).reduced()
    api = A.get_api(cfg)
    model, _ = api.init(torch.Generator().manual_seed(0))
    shape = cfg.shape("train_batch")
    batch = api.demo_batch(shape, device="cpu")
    step = api.step_fn(shape)
    got, want, calls = _both_ways(lambda: step(model, batch), model,
                                  monkeypatch)
    assert _equal(got, want)
    if arch != "mind":
        assert calls
    cand = cfg.shape("retrieval_cand")
    serve = api.step_fn(cand)
    cb = api.demo_batch(cand, device="cpu")
    with torch.no_grad():
        assert _equal(serve(model, cb), serve(model, cb))


def test_gnn_forward_backward_bitwise_without_constraints(monkeypatch):
    cfg = get_arch("gatedgcn").reduced()
    api = A.get_api(cfg)
    model, _ = api.init(torch.Generator().manual_seed(0))
    shape = cfg.shape("full_graph_sm")
    batch = api.demo_batch(shape, device="cpu")
    got, want, calls = _both_ways(lambda: api.step_fn(shape)(model, batch),
                                  model, monkeypatch)
    assert _equal(got, want)
    assert ("edges", None) in calls and ("nodes", None) in calls


def test_segment_ops_are_the_plain_code():
    g = torch.Generator().manual_seed(2)
    index = torch.randint(0, 30, (200,), generator=g)
    seg = G.segments(index, 33)
    assert torch.equal(seg.perm, torch.sort(index, stable=True).indices)
    assert torch.equal(seg.lengths, torch.bincount(index, minlength=33))
    x = torch.randn(200, 6, generator=g).to(torch.bfloat16)
    want = torch.segment_reduce(
        x.index_select(0, seg.perm).to(torch.float32), "sum",
        lengths=seg.lengths, axis=0).to(torch.bfloat16)
    assert torch.equal(G._segment_sum(x, seg), want)
