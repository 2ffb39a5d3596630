"""The port's dry run (``launch/dryrun.py``, ``distributed/``) against
the JAX package's, on the CPU.

- *Collectives.*  The same all-gather and all-reduce: the reference's
  ``collective_breakdown`` reads them from the HLO of a ``shard_map``
  over the 4 test devices, the port's from a fake 4-rank group; both
  give ``{'all-gather': (1, 512), 'all-reduce': (1, 256)}``.
- *Roofline.*  ``roofline_terms`` with the reference's constants equals
  the reference's function.
- *One device.*  On a (1, 1) mesh, per-device flops by dtype equal the
  count of the same step on real CPU tensors (an LM decode, a DeepFM
  training step, a GatedGCN training step), and the fake route of
  attention gives the kernel's shapes without launching it.
- *Data-only mesh.*  Per-device product flops times the 4 ranks equal
  the unsharded count.
- *Against the reference.*  Child processes run the reference's
  ``lower_cell(probe=True)`` on 512 forced devices with Auto mesh axes
  (``scripts/dryrun_reference.py``) on deepfm ``serve_p99``, gatedgcn
  ``full_graph_sm`` and llama3-8b ``decode_32k``, one cell each, while
  the other tests run.  The port must give the same mesh and kind, equal
  ``argument_bytes``, the same set of sharding fallbacks, and flops
  within ``FLOPS_BAND`` of the reference's once each side's dtype
  conversions are taken out: XLA on the CPU converts every bf16 operand
  of a product to fp32 (deepfm's whole replicated table each step) and
  counts each conversion as a flop, which a bf16 product on the card
  does not do (``test_conversion_is_the_divergence`` counts that one op
  both ways).  No cell's peak may pass the H100's 80 GB.
- *Partitioned programs on small fake groups* (``models/sharding_ctx``,
  the custom ops' DTensor rules).  GQA heads: on a 16-wide ``model``
  axis, with 32 query heads over 8 key/value heads and with 40 over 10
  (which do not divide 16: split unevenly, 3 heads on the counted rank,
  as GSPMD pads them to 48), a rank's attention flops are its heads'
  share of the whole, on the training route (the kernels' custom ops)
  and on the prefill route (the plain compositions), and DTensor
  replicates no op.  MoE: deepseek's 64 experts over 16, a rank's
  expert products are 1/16 of the whole and no buffer it holds is as
  large as the (t, k, d) contributions of the per-token combine.  LM
  head: on a (2, 2, 4) mesh a training step (run in a child) gathers
  the head's weight, not the logits' rows or the vocab.  The dispatch
  and combine ops equal the plain code they stand for.
- *Against recorded reference lines.*  llama3-8b and deepseek-moe-16b
  ``prefill_32k``, whose reference runs take about a minute each, are
  held (the port's side computed in a child each) to the same checks
  against the reference's result lines in
  ``tests/dryrun_reference_cells.json``, which names the ``jax`` version
  and the command that made them; the test fails, naming that command,
  where the installed ``jax`` differs.  These are the cells GQA's head
  split and the MoE dispatch move most (LM prefill 7x the reference's
  flops, deepseek 116 GB a device, before both were partitioned).
- The dry run refuses to run beside a default group and leaves none.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.distributed import hlo_analysis as JH
from repro_torch.common.config import ShapeSpec
from repro_torch.common.registry import get_arch
from repro_torch.common.sharding import MeshShape, rules_for_family
from repro_torch.distributed import comm_analysis as CA
from repro_torch.distributed import collective_breakdown, roofline_terms
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import api as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_threads import one_blas_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REFERENCE_CELLS = (("deepfm", "serve_p99"), ("gatedgcn", "full_graph_sm"),
                   ("llama3-8b", "decode_32k"))
FLOPS_BAND = 0.25       # |port / reference - 1|, conversions taken out
RECORDED = json.loads((ROOT / "tests" / "dryrun_reference_cells.json")
                      .read_text())
RECORDED_CELLS = {(r["arch"], r["shape"]): r for r in RECORDED["cells"]}
MATMUL = ("bfloat16", "float32")


# the port's side of a recorded cell, in a child: its ``lower_cell``
# result as one JSON line
PORT_CELL = ("import json, sys; from repro_torch.launch.dryrun import "
             "lower_cell; print(json.dumps(lower_cell(*sys.argv[1:])))")
# this module's ``lm_head_step``, in a child
LM_HEAD_CHILD = (f"import json, sys; "
                 f"sys.path.insert(0, {str(ROOT / 'tests')!r}); "
                 "import test_torch_dryrun as t; "
                 "print(json.dumps(t.lm_head_step()))")


def _child(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def children():
    """Started at the module's first test, so that they run beside the
    other tests: the reference's ``lower_cell`` of each of its three
    cells, the port's of each recorded cell, and ``lm_head_step``, one
    child each."""
    procs = {("reference", a, s): _child(
        [str(ROOT / "scripts" / "dryrun_reference.py"), f"{a}:{s}"])
        for a, s in REFERENCE_CELLS}
    for arch, shape in sorted(RECORDED_CELLS):
        procs[arch, shape] = _child(["-c", PORT_CELL, arch, shape])
    procs["lm_head"] = _child(["-c", LM_HEAD_CHILD])
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _lines(proc) -> list:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return [json.loads(line) for line in out.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def reference_results(children):
    return {(a, s): _lines(children["reference", a, s])[0]
            for a, s in REFERENCE_CELLS}


# ---------------------------------------------------------------------------
# collectives and roofline
# ---------------------------------------------------------------------------
def test_collectives_match_the_hlo_count(children):
    mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,))

    def body(x):
        return (jax.lax.all_gather(x, "data", tiled=True),
                jax.lax.psum(x, "data"))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data", None),
                               out_specs=(P(), P()), check_vma=False))
    x = jax.device_put(jnp.ones((16, 8), jnp.float32),
                       NamedSharding(mesh, P("data", None)))
    want = JH.collective_breakdown(fn.lower(x).compile().as_text())
    assert want == {"all-gather": (1, 512), "all-reduce": (1, 256)}

    import torch.distributed._functional_collectives as funcol
    with D.fake_group(4), D._fake_mode():
        x = torch.empty(4, 8)                   # one rank's (16, 8) shard
        with CA.StepCounter() as counter:
            g = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
            r = funcol.all_reduce(x, "sum", dist.group.WORLD)
            funcol.wait_tensor(g)
            funcol.wait_tensor(r)
    assert collective_breakdown(counter) == want
    assert CA.collective_bytes(counter.collectives) == 768
    assert not dist.is_initialized()


@pytest.mark.parametrize("flops,hbm,coll,chips,links", [
    (1e12, 1e9, 1e6, 256, 4), (3.3e9, 8e9, 2e9, 512, 4), (0.0, 1.0, 0.0,
                                                          1, 2)])
def test_roofline_terms_match_reference(flops, hbm, coll, chips, links):
    want = JH.roofline_terms(flops, hbm, coll, chips, links)
    got = roofline_terms(flops, hbm, coll, chips, links,
                         peak_flops=JH.PEAK_FLOPS, hbm_bw=JH.HBM_BW,
                         link_bw=JH.ICI_BW)
    assert got == want
    h100 = roofline_terms({"bfloat16": 989.4e12, "float32": 67e12},
                          3.35e12, 450e9, chips)
    assert h100["t_compute_s"] == pytest.approx(2.0)
    assert h100["t_memory_s"] == pytest.approx(1.0)
    assert h100["t_collective_s"] == pytest.approx(1.0)


def test_conversion_is_the_divergence():
    """One bf16 product, counted both ways: XLA on the CPU adds an fp32
    conversion of each operand and of the result and counts each element
    as a flop; the port counts the product alone."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from dryrun_reference import convert_elements
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    m, k, n = 32, 64, 48
    a = jnp.ones((m, k), jnp.bfloat16)
    b = jnp.ones((k, n), jnp.bfloat16)
    compiled = jax.jit(lambda x, y: x @ y).lower(a, b).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    converts = convert_elements(compiled.as_text())
    assert converts > 0
    assert cost["flops"] - converts == 2 * m * k * n
    with D._fake_mode():
        x = torch.empty(m, k, dtype=torch.bfloat16)
        y = torch.empty(k, n, dtype=torch.bfloat16)
        with CA.StepCounter() as counter:
            x @ y
    assert dict(counter.flops) == {"bfloat16": 2 * m * k * n}


# ---------------------------------------------------------------------------
# one device and a data-only mesh
# ---------------------------------------------------------------------------
def _tiny(arch, shape: ShapeSpec):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, shapes=(shape,))


TINY = {
    "llama3-8b": ShapeSpec("tiny_decode", "inference-decode", seq_len=64,
                           global_batch=8),
    "deepfm": ShapeSpec("tiny_train", "training", batch=64),
    "gatedgcn": ShapeSpec("tiny_graph", "full-batch", n_nodes=300,
                          n_edges=1100, d_feat=24),
}


def _real_counts(cfg, shape):
    """The step's counts on real CPU tensors of the cell's shapes."""
    api = A.get_api(cfg)
    g = torch.Generator().manual_seed(0)
    pdt = D._param_dtype(cfg, shape)
    if cfg.family == "gnn":
        model, _ = api.init(g, d_feat=shape.d_feat)
    else:
        model, _ = api.init(g, dtype=pdt)
    batch = {}
    for key, t in api.input_specs(shape).items():
        if key == "caches":
            batch[key] = T.make_kv_cache(cfg, shape.global_batch,
                                         shape.seq_len, device="cpu")
        elif key == "cache_len":
            batch[key] = shape.seq_len - 1
        elif key == "edge_index":
            batch[key] = torch.randint(0, shape.n_nodes, tuple(t.shape),
                                       generator=g, dtype=torch.int32)
        elif t.dtype.is_floating_point:
            batch[key] = torch.randn(tuple(t.shape), generator=g)
        elif t.dtype == torch.bool:
            batch[key] = torch.ones(tuple(t.shape), dtype=torch.bool)
        else:
            batch[key] = torch.zeros(tuple(t.shape), dtype=t.dtype)
    cell = D.Cell(cfg, shape, api, pdt, 1, shape.kind in D.TRAIN_KINDS,
                  [], [], [], model)
    fn = D._step_fn(cell)
    opt = None
    if cell.train:
        from repro_torch.train.optimizer import opt_init
        opt = opt_init(model, "adamw")
    with CA.StepCounter() as counter:
        fn(model, opt, batch)
    return counter


@pytest.mark.parametrize("arch", sorted(TINY))
def test_one_device_counts_equal_the_unsharded_step(arch):
    cfg = _tiny(arch, TINY[arch])
    res = D.lower_cell(arch, TINY[arch].name, cfg=cfg, whole_depth=True,
                       mesh_sizes=MeshShape((1, 1), ("data", "model")))
    real = _real_counts(cfg, TINY[arch])
    assert res["flops_by_dtype"] == dict(real.flops)
    assert res["flops_per_device"] == real.total_flops > 0
    assert res["replicated_ops"] == []
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["llama3-8b", "deepfm"])
def test_data_mesh_share_is_a_quarter(arch):
    cfg = _tiny(arch, TINY[arch])
    one = D.lower_cell(arch, TINY[arch].name, cfg=cfg, whole_depth=True,
                       mesh_sizes=MeshShape((1,), ("data",)))
    four = D.lower_cell(arch, TINY[arch].name, cfg=cfg, whole_depth=True,
                        mesh_sizes=MeshShape((4,), ("data",)))
    for dt in MATMUL:
        assert 4 * four["flops_by_dtype"].get(dt, 0) == \
            one["flops_by_dtype"].get(dt, 0)
    assert sum(one["flops_by_dtype"].get(dt, 0) for dt in MATMUL) > 0
    assert four["collectives"]


def test_attention_fake_route_gives_the_kernel_shapes():
    FA.reset_launch_count()
    with D._fake_mode():
        q = torch.empty(2, 8, 128, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty(2, 2, 128, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        with CA.StepCounter() as counter:
            o = FA.flash_attention(q, k, k, causal=True)
            o.sum().backward()
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    pairs = 128 * 129 // 2
    assert counter.ops["repro_torch.flash_attention_fwd"] == 1
    assert counter.ops["repro_torch.flash_attention_bwd"] == 1
    assert counter.flops["bfloat16"] >= 14 * 2 * 8 * 64 * pairs
    assert FA.launch_count() == 0 and FA.bwd_launch_count() == 0
    assert FA.attention_pairs(4, 6, True) == 3 + 4 + 5 + 6


def test_meshes_name_the_group_ranks():
    from repro_torch.launch import mesh as M
    with pytest.raises(RuntimeError, match="initialize"):
        M.make_production_mesh(device_type="cpu")
    with D.fake_group(4):
        local = M.make_local_mesh(model=2, device_type="cpu")
        assert local.mesh_dim_names == ("data", "model")
        assert local.mesh.tolist() == [[0, 1], [2, 3]]
        with pytest.raises(ValueError, match="256 ranks"):
            M.make_production_mesh(device_type="cpu")
    assert M.production_mesh_shape(True).shape == {
        "pod": 2, "data": 16, "model": 16}


def test_dry_run_refuses_a_group_and_leaves_none():
    with D.fake_group(2):
        with pytest.raises(RuntimeError, match="already exists"):
            D.lower_cell("deepfm", "serve_p99")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the partitioned programs on small fake groups (these run while the
# children compute theirs)
# ---------------------------------------------------------------------------
MODEL16 = MeshShape((1, 16), ("data", "model"))
B, D_HEAD = 2, 16


def _loss_and_grads(cell):
    """A training cell's step without its optimizer's update."""
    step = cell.api.step_fn(cell.shape)
    return lambda model, opt, batch: step(model, batch)[0].backward()


def _step(cfg, shape: ShapeSpec, sizes: MeshShape):
    """One counted step of ``cfg`` at ``shape`` on a fake group of
    ``sizes``, one microbatch; a training step's loss and gradients
    (its update adds no product)."""
    rules = rules_for_family(cfg.family, shape.kind)
    with D.fake_group(sizes.size), \
            mock.patch.object(D, "_step_fn", _loss_and_grads) \
            if shape.kind == "training" else contextlib.nullcontext():
        mesh = device_mesh(sizes, "cpu")
        cell = D._build_cell(cfg, shape, A.get_api(cfg), mesh, rules,
                             include_optimizer=True, n_micro_override=1)
        return D.run_cell(cell, mesh, rules)


def _lm(arch, shape, **kw):
    base = dict(n_layers=1, d_model=128, d_head=D_HEAD, d_ff=256,
                vocab_size=512, shapes=(shape,))
    return dataclasses.replace(get_arch(arch), **{**base, **kw})


@pytest.mark.parametrize("hq,hkv", [(32, 8), (40, 10)])
@pytest.mark.parametrize("route", ["train", "prefill"])
def test_gqa_attention_splits_query_heads(route, hq, hkv):
    kind, l = {"train": ("training", 64), "prefill": ("inference-prefill",
                                                      256)}[route]
    shape = ShapeSpec("s", kind, seq_len=l, global_batch=B)
    counter = _step(_lm("llama3-8b", shape, n_heads=hq, n_kv_heads=hkv),
                    shape, MODEL16)
    assert counter.replicated_ops == set()
    mine = -(-hq // 16)                 # the counted rank's query heads
    if route == "train":
        pairs = FA.attention_pairs(l, l, True)
        for op, per_pair in (("fwd", 4), ("bwd", 10)):
            name = f"repro_torch.flash_attention_{op}"
            assert counter.ops[name] >= 1
            assert counter.op_flops[name] == counter.ops[name] * \
                per_pair * B * mine * D_HEAD * pairs
    else:
        # QK^T and PV over one block of every key, in fp32 (the
        # compositions' only fp32 products)
        assert counter.flops["float32"] == 4 * B * mine * l * l * D_HEAD


def test_moe_layer_keeps_the_experts_split():
    t_shape = ShapeSpec("s", "training", seq_len=256, global_batch=B)
    cfg = _lm("deepseek-moe-16b", t_shape, n_heads=8, n_kv_heads=8,
              moe=dataclasses.replace(get_arch("deepseek-moe-16b").moe,
                                      d_ff_expert=32), moe_every=1)
    counter = _step(cfg, t_shape, MODEL16)
    assert counter.replicated_ops == set()
    moe, t, d = cfg.moe, B * 256, cfg.d_model
    e, c, f = moe.n_experts, L.moe_capacity(t, moe), moe.d_ff_expert
    assert e == 64
    # three products a pass of the experts' (c, d) x (d, f): forward,
    # its recompute under the layer's checkpoint, and the backward's
    # two products each, on this rank's 4 experts
    assert counter.op_flops["aten.bmm"] == 4 * 3 * 2 * (e // 16) * c * d * f
    contrib = t * moe.top_k * d * 2             # (t, k, d) in bf16
    assert counter.largest_bytes < contrib / 2


LM_HEAD = dict(v=4096, d=128)


def lm_head_step() -> dict:
    """A training step's all-gathers (their shapes) and ``aten.mm``
    flops on a (2, 2, 4) mesh, run by a child of ``children``."""
    shape = ShapeSpec("s", "training", seq_len=64, global_batch=16)
    cfg = _lm("llama3-8b", shape, n_heads=4, n_kv_heads=4, d_ff=64,
              vocab_size=LM_HEAD["v"], d_model=LM_HEAD["d"])
    counter = _step(cfg, shape, MeshShape((2, 2, 4),
                                          ("pod", "data", "model")))
    return {"gathers": [list(r.shape) for r in counter.collectives
                        if r.kind == "all-gather"],
            "mm_flops": counter.op_flops["aten.mm"]}


def test_lm_head_gathers_no_vocab(children):
    step, = _lines(children["lm_head"])
    v, d = LM_HEAD["v"], LM_HEAD["d"]
    gathers = [tuple(s) for s in step["gathers"]]
    assert (d, v // 4) in gathers                  # the head's weight
    for s in gathers:
        assert v not in s
        # the head's weight, over one FSDP axis or both; never rows of
        # the logits (256 tokens a rank) or of their gradient
        assert v // 4 not in s or (len(s) == 2 and s[0] <= d), s
    # the head's products stay on this rank's vocab quarter: forward,
    # input gradient and weight gradient over its 256 of 1024 tokens
    assert step["mm_flops"] >= 3 * 2 * 256 * d * v // 4


def test_moe_dispatch_and_combine_ops_are_the_plain_code():
    cfg = get_arch("deepseek-moe-16b").reduced()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 40, cfg.d_model, generator=g).to(torch.bfloat16)
    p = {k: w for k, w in L.moe_init(g, cfg.d_model, cfg.moe)
         .params(torch.bfloat16).items() if k != "shared"}
    want, _ = L.moe_fwd(p, x, cfg.moe)
    xf = x.reshape(-1, cfg.d_model)
    t = xf.shape[0]
    r = L.moe_route(p["router"], xf, cfg.moe)
    xe = torch.ops.repro_torch.moe_gather(xf, r.sel_idx)
    assert torch.equal(xe, xf[r.sel_idx.reshape(-1)].reshape(xe.shape))
    ye = torch.bmm(torch.nn.functional.silu(torch.bmm(xe, p["w_gate"])) *
                   torch.bmm(xe, p["w_up"]), p["w_down"])
    # the combine as the dry run partitions it is bitwise the per-token
    # gather the card runs: the same products, summed in expert order
    combined = L._traced_combine(ye, r, t, r.sel_idx)
    assert torch.equal(L._moe_out(p, combined, x, xf), want)
    # integer values: every order of the adds is exact
    ints = torch.randint(-8, 8, ye.shape, generator=g).to(torch.float32)
    back = torch.ops.repro_torch.moe_scatter(ints, r.sel_idx, t)
    plain = torch.zeros((t, cfg.d_model))
    for j, i in enumerate(r.sel_idx.reshape(-1).tolist()):
        plain[i] += ints.reshape(-1, cfg.d_model)[j]
    assert torch.equal(back, plain)


# ---------------------------------------------------------------------------
# against the reference's own dry run
# ---------------------------------------------------------------------------
def _hold_to_reference(port: dict, ref: dict) -> None:
    # the reference's keys, and its memory keys, are the port's too
    assert set(ref) - {"convert_elements", "seconds"} <= set(port)
    assert set(ref["memory"]) <= set(port["memory"])
    assert port["mesh"] == ref["mesh"] and port["kind"] == ref["kind"]
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    assert {tuple(f) for f in port["sharding_fallbacks"]} == \
        {tuple(f) for f in ref["sharding_fallbacks"]}
    got = port["flops_per_device"] - port["flops_by_dtype"].get("convert", 0)
    want = ref["flops_per_device"] - ref["convert_elements"]["adjusted"]
    assert abs(got / want - 1) <= FLOPS_BAND, (got, want)
    assert 0 < port["memory"]["peak_bytes"] < 80e9


@pytest.mark.parametrize("arch,shape", REFERENCE_CELLS)
def test_cells_match_the_reference(arch, shape, reference_results):
    _hold_to_reference(D.lower_cell(arch, shape),
                       reference_results[(arch, shape)])


@pytest.mark.parametrize("arch,shape", sorted(RECORDED_CELLS))
def test_recorded_cells_match_the_reference(arch, shape, children):
    if jax.__version__ != RECORDED["jax"]:
        pytest.fail(f"the recorded reference lines are jax "
                    f"{RECORDED['jax']}'s, this is {jax.__version__}: "
                    f"record them again with `{RECORDED['command']}`")
    port, = _lines(children[arch, shape])
    assert port["replicated_ops"] == []
    _hold_to_reference(port, RECORDED_CELLS[(arch, shape)])
