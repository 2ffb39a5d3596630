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
- *Against the reference.*  One child process runs the reference's
  ``lower_cell(probe=True)`` on 512 forced devices with Auto mesh axes
  (``scripts/dryrun_reference.py``) on deepfm ``serve_p99``, gatedgcn
  ``full_graph_sm`` and llama3-8b ``decode_32k``; it runs while the
  other tests do.  The port must give the same mesh and kind, equal
  ``argument_bytes``, the same set of sharding fallbacks, and flops
  within ``FLOPS_BAND`` of the reference's once each side's dtype
  conversions are taken out: XLA on the CPU converts every bf16 operand
  of a product to fp32 (deepfm's whole replicated table each step) and
  counts each conversion as a flop, which a bf16 product on the card
  does not do (``test_conversion_is_the_divergence`` counts that one op
  both ways).
- The dry run refuses to run beside a default group and leaves none.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.common.sharding import MeshShape
from repro_torch.distributed import comm_analysis as CA
from repro_torch.distributed import collective_breakdown, roofline_terms
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import dryrun as D
from repro_torch.models import api as A
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parent.parent
REFERENCE_CELLS = (("deepfm", "serve_p99"), ("gatedgcn", "full_graph_sm"),
                   ("llama3-8b", "decode_32k"))
FLOPS_BAND = 0.25       # |port / reference - 1|, conversions taken out
MATMUL = ("bfloat16", "float32")


@pytest.fixture(scope="module")
def reference_child():
    """The reference's three cells, started at the module's first test
    so that the child runs beside the others."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "dryrun_reference.py")] +
        [f"{a}:{s}" for a, s in REFERENCE_CELLS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference_results(reference_child):
    out, err = reference_child.communicate(timeout=600)
    assert reference_child.returncode == 0, err[-4000:]
    res = [json.loads(line) for line in out.splitlines() if line.strip()]
    return {(r["arch"], r["shape"]): r for r in res}


# ---------------------------------------------------------------------------
# collectives and roofline
# ---------------------------------------------------------------------------
def test_collectives_match_the_hlo_count(reference_child):
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
# against the reference's own dry run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", REFERENCE_CELLS)
def test_cells_match_the_reference(arch, shape, reference_results):
    port = D.lower_cell(arch, shape)
    ref = reference_results[(arch, shape)]
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
