"""Dry run: every (arch x shape x production mesh) cell, without cards.

Proves, as the JAX package's ``launch/dryrun.py`` does, that the
distribution config is coherent, fits, and has a roofline.  There XLA
lowers and compiles each cell for 512 forced host devices; here the
partitioner is DTensor.  ``lower_cell`` starts a fake process group of
256 (or 512) ranks, names them as the production mesh, lays every
weight, batch leaf and optimizer moment out as a DTensor by the logical
rules (``common/sharding.py``), and runs one step of the cell on fake
tensors under the activation-sharding context, so the models' ``shard``
calls redistribute as the reference's constraints do.  One rank's local
ops are counted (``distributed/comm_analysis.py``): collectives, flops
by dtype, HBM bytes, and its live bytes, whose largest value is the
step's peak.  The roofline terms are the H100's.

A fake tensor takes the card's route: ``flash_attention`` runs its
kernels' custom ops, whose shape contracts (``register_fake``), flop
formulas and DTensor sharding rules stand in for the kernels.

An LM is counted, as the reference counts it, by a probe: the step at
1 and at 2 blocks, extrapolated affinely to the true depth
(``f(L) = f(1) + (L - 1) (f(2) - f(1))``); its layers are checkpointed
one at a time, so each block adds the same to every count.  Costs come
from probes at one microbatch (the reference's), memory from probes at
the cell's own microbatch count; ``raw_*`` are the memory run's counts.
The other families run at their whole depth (``whole_depth`` does that
for an LM too).

The fake group is made only inside ``lower_cell``, which refuses to run
where a default group exists and destroys its own in ``finally``.
Importing this module sets no environment variable and starts no group.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.common.config import GNNConfig, LMConfig, ShapeSpec
from repro_torch.common.registry import get_arch, list_archs
from repro_torch.common.sharding import LogicalRules, MeshShape, \
    local_shape, mesh_shape, placements, rules_for_family
from repro_torch.distributed.comm_analysis import StepCounter, \
    collective_breakdown, roofline_terms, tensor_leaves
from repro_torch.launch.mesh import device_mesh, make_production_mesh, \
    production_mesh_shape
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI, get_api
from repro_torch.models.convert import param_leaves
from repro_torch.models.sharding_ctx import activation_sharding, \
    contiguous_stride
from repro_torch.train.optimizer import AdafactorState, AdamWState, \
    adafactor_params, make_train_step, tree_leaves

TRAIN_KINDS = ("training", "sampled-training", "full-batch",
               "full-batch-large", "batched-small-graphs")
DEFAULT_OUT = "results/dryrun_torch"


# ---------------------------------------------------------------------------
# per-cell policy: optimizer + microbatch count (the reference's)
# ---------------------------------------------------------------------------
def _train_policy(cfg) -> dict:
    if cfg.family == "lm-moe" and cfg.param_count() > 1e11:
        # 400B llama4: Adafactor (factored 2nd moment) + bf16 stored
        # weights + bf16 grad accumulation
        return {"optimizer": "adafactor", "n_microbatches": 16,
                "param_dtype": torch.bfloat16,
                "accum_dtype": torch.bfloat16}
    if cfg.family in ("lm-dense", "lm-moe"):
        # >=10B dense models carry bigger per-layer activations: halve
        # the microbatch again
        micro = 16 if cfg.param_count() > 1e10 else 8
        return {"optimizer": "adamw", "n_microbatches": micro,
                "param_dtype": torch.float32,
                "accum_dtype": torch.float32}
    return {"optimizer": "adamw", "n_microbatches": 1,
            "param_dtype": torch.float32, "accum_dtype": torch.float32}


def _param_dtype(cfg, shape: ShapeSpec, policy=None) -> torch.dtype:
    """Serving cells read bf16 weights; training keeps the policy's
    (``policy`` overrides either)."""
    if policy and "param_dtype" in policy:
        return policy["param_dtype"]
    return _train_policy(cfg)["param_dtype"] \
        if shape.kind in TRAIN_KINDS else torch.bfloat16


def _n_micro(n_micro: int, shape: ShapeSpec, mesh) -> int:
    """The policy's microbatch count, cut so that each slice stays
    divisible by the batch-shard count (pod * data)."""
    gb = shape.global_batch or shape.batch
    if gb:
        sizes = mesh_shape(mesh)
        shards = sizes.get("pod", 1) * sizes.get("data", 1)
        n_micro = max(1, min(n_micro, gb // shards))
        while gb % n_micro:
            n_micro -= 1
    return n_micro


# ---------------------------------------------------------------------------
# the cell's leaves, in the reference's tree order
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Leaf:
    """One leaf of the reference's (params, batch, optimizer) trees:
    its path, global shape, dtype and logical axes, and the spec the
    rules resolve it to."""

    path: tuple
    shape: tuple
    dtype: torch.dtype
    axes: tuple
    spec: Optional[tuple] = None

    def local_bytes(self, mesh) -> int:
        n = int(np.prod(local_shape(mesh, self.shape, self.spec)))
        return n * torch.empty((), dtype=self.dtype).element_size()


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _path(name: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def abstract_model(cfg, api: ModelAPI, shape: ShapeSpec,
                   pdt: torch.dtype) -> Tuple[nn.Module, Any]:
    """The cell's weights as fake tensors at their global shapes (no
    memory, no draws for an LM), and their logical axes."""
    with _fake_mode():
        if isinstance(cfg, LMConfig):
            return transformer.LM(cfg, pdt, torch.device("cpu")), \
                transformer.param_axes(cfg)
        g = torch.Generator(device="cpu").manual_seed(0)
        if isinstance(cfg, GNNConfig):
            return api.init(g, d_feat=shape.d_feat or 128)
        return api.init(g, dtype=pdt)


def param_leaf_map(model: nn.Module, axes) -> List[Tuple[Leaf, list]]:
    """(leaf, the port's parameters it holds): an LM's ``layers``
    leaves stack one parameter a block (``convert.param_leaves``)."""
    out = []
    if isinstance(model, transformer.LM):
        for path, params, stacked in param_leaves(model):
            shape = ((len(params),) if stacked else ()) + \
                tuple(params[0].shape)
            out.append((Leaf(path, shape, params[0].dtype,
                             tuple(_at(axes, path))), params))
    else:
        for name, p in model.named_parameters():
            path = _path(name)
            ax = _at(axes, path)
            ax = tuple(ax) if ax is not None else (None,) * p.dim()
            out.append((Leaf(path, tuple(p.shape), p.dtype, ax), [p]))
    return sorted(out, key=lambda lp: lp[0].path)


def batch_leaves(cfg, api: ModelAPI, shape: ShapeSpec) -> List[Leaf]:
    """The batch's leaves in the reference's structure: an LM decode
    cache is ``block_size`` (k, v) pairs over blocks there, one pair
    over every layer in the port."""
    specs, axes = api.input_specs(shape), api.input_axes(shape)
    out = []
    for key in sorted(specs):
        if key == "caches":
            bs = transformer.block_size(cfg)
            for j in range(bs):
                for kv in ("k", "v"):
                    t = specs[key][kv]
                    out.append(Leaf(("caches", j, kv),
                                    (t.shape[0] // bs,) + tuple(t.shape[1:]),
                                    t.dtype, tuple(axes[key][kv])))
            continue
        t = specs[key]
        ax = axes[key]
        out.append(Leaf((key,), tuple(t.shape), t.dtype,
                        tuple(ax) if ax else (None,) * t.dim()))
    return out


def opt_leaves(params: List[Leaf], optimizer: str) -> List[Leaf]:
    """AdamW's (step, mu, nu) or Adafactor's (step, vr, vc, v) leaves,
    fp32, with the reference's axes (``dryrun.py:136-157`` there)."""
    f32 = torch.float32
    out = [Leaf(("step",), (), torch.int32, ())]
    if optimizer == "adamw":
        for name in ("mu", "nu"):
            out += [Leaf((name,) + p.path, p.shape, f32, p.axes)
                    for p in params]
        return out

    def vr(s, a):
        return (s[:-1], a[:-1]) if len(s) >= 2 else ((), ())

    def vc(s, a):
        return (s[:-2] + s[-1:], a[:-2] + a[-1:]) if len(s) >= 2 \
            else ((), ())

    def v(s, a):
        return (s, a) if len(s) < 2 else ((), ())
    for name, fn in (("vr", vr), ("vc", vc), ("v", v)):
        for p in params:
            s, a = fn(p.shape, p.axes)
            out.append(Leaf((name,) + p.path, tuple(s), f32, tuple(a)))
    return out


@dataclasses.dataclass
class Cell:
    """A cell laid out on a mesh: the leaves with their specs, and what
    the step needs."""

    cfg: Any
    shape: ShapeSpec
    api: ModelAPI
    pdt: torch.dtype
    n_micro: int
    train: bool
    params: List[Tuple[Leaf, list]]
    batch: List[Leaf]
    opt: List[Leaf]
    model: nn.Module
    policy: Optional[dict] = None   # ``_train_policy``, overrides merged

    def __post_init__(self):
        if self.policy is None:
            self.policy = _train_policy(self.cfg)

    def leaves(self) -> List[Leaf]:
        return [lf for lf, _ in self.params] + self.batch + self.opt

    def argument_bytes(self, mesh) -> int:
        return sum(lf.local_bytes(mesh) for lf in self.leaves())


def _build_cell(cfg, shape: ShapeSpec, api: ModelAPI, mesh,
                rules: LogicalRules, *, include_optimizer: bool,
                n_micro_override=None, policy=None) -> Cell:
    """Every leaf of the cell with its spec, resolved in the reference's
    order (weights, batch, optimizer state), so ``rules.fallbacks``
    logs what the reference's ``_build_cell`` logs."""
    pdt = _param_dtype(cfg, shape, policy)
    pol = {**_train_policy(cfg), **(policy or {})}
    model, axes = abstract_model(cfg, api, shape, pdt)
    params = param_leaf_map(model, axes)
    batch = batch_leaves(cfg, api, shape)
    train = shape.kind in TRAIN_KINDS and include_optimizer
    opt = opt_leaves([lf for lf, _ in params], pol["optimizer"]) \
        if train else []
    for lf in [lf for lf, _ in params] + batch + opt:
        lf.spec = rules.spec(mesh, lf.shape, lf.axes)
    n_micro = _n_micro(n_micro_override or pol["n_microbatches"], shape,
                       mesh) if train else 1
    return Cell(cfg, shape, api, pdt, n_micro, train, params, batch, opt,
                model, pol)


# ---------------------------------------------------------------------------
# the cell as DTensors, and one counted step
# ---------------------------------------------------------------------------
def _dtensor(mesh, shape, dtype, spec, zeros: bool = False):
    from torch.distributed.tensor import DTensor
    loc = local_shape(mesh, shape, spec)
    local = torch.zeros(loc, dtype=dtype) if zeros else \
        torch.empty(loc, dtype=dtype)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _place_params(cell: Cell, mesh) -> None:
    """Swap every weight of ``cell.model`` for a DTensor of its spec
    (a stacked leaf's spec without its ``layers`` entry)."""
    owner = {id(p): (m, n) for m in cell.model.modules()
             for n, p in m.named_parameters(recurse=False)}
    for lf, ps in cell.params:
        spec = lf.spec
        if len(ps) > 1 or len(lf.shape) > len(ps[0].shape):
            if spec[0] is not None:
                raise ValueError(f"{lf.path}: a stacked leaf sharded on "
                                 f"its layers axis ({spec})")
            spec = spec[1:]
        for i, p in enumerate(ps):
            m, n = owner[id(p)]
            dt = _dtensor(mesh, tuple(p.shape), p.dtype, spec)
            ps[i] = m._parameters[n] = nn.Parameter(
                dt, requires_grad=p.requires_grad)


def _make_batch(cell: Cell, mesh) -> Dict[str, Any]:
    by_path = {lf.path: lf for lf in cell.batch}
    out: Dict[str, Any] = {}
    for key, t in cell.api.input_specs(cell.shape).items():
        if key == "caches":
            spec = by_path[("caches", 0, "k")].spec
            out[key] = {kv: _dtensor(mesh, tuple(t[kv].shape), t[kv].dtype,
                                     spec, zeros=True) for kv in ("k", "v")}
        elif key == "cache_len":
            # the step at a full cache: the last position, so attention
            # reads every cached position, as the traced reference does
            out[key] = cell.shape.seq_len - 1
        else:
            out[key] = _dtensor(mesh, tuple(t.shape), t.dtype,
                                by_path[(key,)].spec)
    return out


def _make_opt(cell: Cell, mesh):
    by_path = {lf.path: lf for lf in cell.opt}
    kind = cell.policy["optimizer"]
    if kind == "adamw":
        path_of = {id(p): lf.path for lf, ps in cell.params for p in ps}
        mu, nu = [], []
        for p in cell.model.parameters():
            for name, out in (("mu", mu), ("nu", nu)):
                lf = by_path[(name,) + path_of[id(p)]]
                spec = lf.spec if len(lf.shape) == p.dim() else lf.spec[1:]
                out.append(_dtensor(mesh, tuple(p.shape), torch.float32,
                                    spec, zeros=True))
        return AdamWState(step=0, mu=mu, nu=nu)
    tree = adafactor_params(cell.model)

    def state(name, t=tree, path=()):
        """The moment ``name`` of every leaf of ``t`` (at ``path``)."""
        if isinstance(t, dict):
            return {k: state(name, v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(state(name, v, path + (i,))
                           for i, v in enumerate(t))
        lf = by_path[(name,) + path]
        return _dtensor(mesh, lf.shape, torch.float32, lf.spec, zeros=True)
    return AdafactorState(step=0, vr=state("vr"), vc=state("vc"),
                          v=state("v"))


def _step_fn(cell: Cell):
    step = cell.api.step_fn(cell.shape)
    if cell.train:
        pol = cell.policy
        train = make_train_step(step, n_microbatches=cell.n_micro,
                                optimizer=pol["optimizer"],
                                accum_dtype=pol["accum_dtype"])
        return lambda model, opt, batch: train(model, opt, batch)

    def serve(model, opt, batch):
        with torch.no_grad():
            return step(model, batch)
    return serve


# DTensor's propagation and redistribution plans, memoized across cells
_MEMO: Dict[str, dict] = {}


@contextlib.contextmanager
def _dtensor_internals(counter: StepCounter):
    """DTensor's own bookkeeping is not a rank's work: its shape
    propagation (each new op run once at global shapes on fake
    tensors) is not counted, and its planning of a redistribution and
    of an uneven shard's sizes (small index tensors it reads back with
    ``tolist``) runs on real tensors, outside the fake mode; a shard
    moved to another dim takes the card's all-to-all.  Under a
    fake mode DTensor takes itself to be tracing and caches neither its
    propagation nor its plans; the dry run memoizes them, as DTensor
    does in eager mode (on a 3-D mesh a plan is a graph search)."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def quiet(fn, real: bool, memo: Optional[dict]):
        def run(*args, **kwargs):
            with counter.suspend():
                if not real:
                    return fn(*args, **kwargs)
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)

        def wrapped(*args, **kwargs):
            if memo is None or kwargs:
                return run(*args, **kwargs)
            key = args + (costing[0],)
            if key not in memo:
                memo[key] = run(*args)
            return memo[key]
        return wrapped

    costing = [False]
    plan = _redistribute._gen_transform_infos_non_cached

    def greedy_or_plan(src, dst, use_graph=None):
        """A plan; for a strategy's cost estimate, DTensor's greedy plan
        (its eager default), not the graph search it takes for shard
        orders other than the mesh's (thousands of 10-ms searches a
        cell on a 3-D mesh)."""
        if costing[0]:
            try:
                return _redistribute.get_redistribute_planner(
                    src.device_mesh, src.tensor_meta
                ).generate_greedy_transform_infos(src, dst)
            except Exception:   # noqa: BLE001 - the search still plans it
                pass
        return plan(src, dst, use_graph)

    def cost(fn):
        def wrapped(*args):
            costing[0] = True
            try:
                return fn(*args)
            finally:
                costing[0] = False
        return wrapped

    from torch.distributed.tensor._ops import utils as op_utils
    patches = [
        (ShardingPropagator, "_propagate_tensor_meta_non_cached", False,
         False, _MEMO.setdefault("meta", {})),
        (_redistribute, "_gen_transform_infos_non_cached", True, False,
         _MEMO.setdefault("plans", {})),
        (placement_types.Shard, "local_shard_size_and_offset", True, True,
         None),
        (placement_types._StridedShard, "local_shard_size_and_offset",
         True, False, None)]
    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        """The card's all-to-all: the fake tensors name the CPU, where
        DTensor would emulate it by a whole all-gather and a chunk."""
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._group_or_group_name(group))

    saved = [(op_utils, "redistribute_cost",
              op_utils.__dict__["redistribute_cost"]),
             (placement_types, "shard_dim_alltoall",
              placement_types.__dict__["shard_dim_alltoall"])]
    op_utils.redistribute_cost = cost(op_utils.redistribute_cost)
    placement_types.shard_dim_alltoall = alltoall
    for owner, name, real, static, memo in patches:
        raw = owner.__dict__[name]
        saved.append((owner, name, raw))
        fn = raw.__func__ if static else raw
        if fn is plan:
            fn = greedy_or_plan
        setattr(owner, name, staticmethod(quiet(fn, real, memo)) if static
                else quiet(fn, real, memo))
    try:
        yield
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)


@contextlib.contextmanager
def _replicate_fallback(audit: set):
    """Where DTensor has no way to shard an op on its inputs' placements
    (no strategy, or a view it cannot split, such as 8 kv heads over a
    16-wide axis), the inputs are replicated but for their batch
    (dim-0) shards, or, where that does not do either, replicated whole
    (an op with no strategy at all gets the all-replicated one), and
    the op runs so on each rank: the collectives and the work that
    takes are counted, and the op is named in ``audit``.  GSPMD
    replicates where it must too; the port's list is in the result's
    ``replicated_ops``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema
    from torch.distributed.tensor._ops.utils import replicate_op_strategy
    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop.propagate_op_sharding_non_cached
    orig_cached = prop.propagate_op_sharding

    def respec(x, keep_batch: bool):
        if isinstance(x, DTensorSpec):
            return DTensorSpec(x.mesh, tuple(
                p if keep_batch and isinstance(p, Shard) and p.dim == 0
                else Replicate() for p in x.placements),
                tensor_meta=x.tensor_meta)
        if isinstance(x, (list, tuple)):
            return type(x)(respec(y, keep_batch) for y in x)
        return x

    memo = _MEMO.setdefault("sharding", {})

    def propagate(op_schema):
        if op_schema not in memo:
            memo[op_schema] = fallback(op_schema)
        out, whole = memo[op_schema]
        if whole:
            audit.add(str(op_schema.op))
        return out

    def fallback(op_schema):
        """(the sharding, whether the op runs replicated)"""
        try:
            return orig(op_schema), False
        except Exception as ex:   # noqa: BLE001 - DTensor's refusal
            refusal = ex
        for keep_batch in (True, False):
            rep = OpSchema(op_schema.op,
                           respec(op_schema.args_schema, keep_batch),
                           respec(op_schema.kwargs_schema, keep_batch),
                           schema_info=op_schema.schema_info)
            if rep.args_schema == op_schema.args_schema and \
                    rep.kwargs_schema == op_schema.kwargs_schema:
                continue
            if not keep_batch and op_schema.op not in prop.op_strategy_funcs:
                prop.register_op_strategy(op_schema.op,
                                          replicate_op_strategy)
            try:
                out = orig(rep)
            except Exception:   # noqa: BLE001 - the next, wider retry
                continue
            if out.redistribute_schema is None:
                out.redistribute_schema = rep
            out.needs_redistribute = True
            return out, True
        raise refusal

    prop.propagate_op_sharding = propagate
    prop.propagate_op_sharding_non_cached = propagate
    try:
        yield
    finally:
        del prop.propagate_op_sharding_non_cached
        prop.propagate_op_sharding = orig_cached


def _register_op_rules() -> None:
    """The DTensor rules of the port's custom ops on the cells' paths."""
    from repro_torch.kernels.flash_attention import ops as attention
    from repro_torch.models import gnn, layers
    attention.register_dtensor_sharding()
    gnn.register_dtensor_sharding()
    layers.register_dtensor_sharding()


def run_cell(cell: Cell, mesh, rules: LogicalRules) -> StepCounter:
    """One step of ``cell`` on fake DTensors over ``mesh``, counted
    (``counter.replicated_ops``: the ops DTensor could not shard)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_op_rules()
    counter = StepCounter()
    counter.replicated_ops = set()
    with _fake_mode():
        _place_params(cell, mesh)
        batch = _make_batch(cell, mesh)
        opt = _make_opt(cell, mesh) if cell.train else None
        for t in tree_leaves([list(cell.model.parameters()), batch,
                              list(opt[1:]) if opt else []]):
            if torch.is_tensor(t):
                counter.hold(t)
        fn = _step_fn(cell)
        with _dtensor_internals(counter), implicit_replication(), \
                _replicate_fallback(counter.replicated_ops), \
                activation_sharding(mesh, rules), counter:
            out = fn(cell.model, opt, batch)
        # the step's results: what it returns, and a training step's
        # weights, updated in place
        res = tensor_leaves([out, list(cell.model.parameters())
                        if cell.train else []])
        counter.output_bytes = sum(_local_bytes(t) for t in
                                   {id(t): t for t in res}.values())
        del out, res
    return counter


def _local_bytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# lower_cell
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank
    0), destroyed on exit; refuses to run where a group exists."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake group; a "
                           "default process group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _costs(counter: StepCounter) -> dict:
    coll = collective_breakdown(counter)
    return {"flops": counter.total_flops,
            "flops_by_dtype": dict(counter.flops),
            "bytes": float(counter.hbm_bytes),
            "coll": float(sum(b for _, b in coll.values())),
            "breakdown": {k: list(v) for k, v in coll.items()},
            "peak": float(counter.peak_bytes),
            "output": float(counter.output_bytes),
            "replicated_ops": sorted(counter.replicated_ops)}


def _affine(p1: dict, p2: dict, blocks: int) -> dict:
    """``f(L) = f(1) + (L - 1) (f(2) - f(1))`` of every count."""
    def ext(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a, b = a or {}, b or {}
            return {k: ext(a.get(k), b.get(k)) for k in set(a) | set(b)}
        if isinstance(a, list) or isinstance(b, list):
            a, b = a or [0, 0], b or [0, 0]
            return [ext(x, y) for x, y in zip(a, b)]
        a, b = a or 0, b or 0
        return a + (blocks - 1) * (b - a)
    return {k: sorted(set(p1[k]) | set(p2[k])) if k == "replicated_ops"
            else ext(p1[k], p2[k]) for k in p1}


def _block(cfg) -> int:
    return cfg.moe_every if getattr(cfg, "is_moe", False) else 1


def _counts(cfg, shape, mesh, rules, include_optimizer,
            n_micro_override, policy=None) -> dict:
    cell = _build_cell(cfg, shape, get_api(cfg), mesh, rules,
                       include_optimizer=include_optimizer,
                       n_micro_override=n_micro_override, policy=policy)
    return _costs(run_cell(cell, mesh, rules))


def _probe(cfg, shape, mesh, rules, include_optimizer,
           n_micro_override, policy=None) -> Tuple[dict, dict]:
    """The step's counts at 1 and 2 blocks, extrapolated to the true
    depth, and the two probes."""
    step = _block(cfg)
    p1 = _counts(dataclasses.replace(cfg, n_layers=step), shape, mesh,
                 rules, include_optimizer, n_micro_override, policy)
    p2 = _counts(dataclasses.replace(cfg, n_layers=2 * step), shape, mesh,
                 rules, include_optimizer, n_micro_override, policy)
    blocks = cfg.n_layers // step
    return _affine(p1, p2, blocks), {
        "probe_l1": p1, "probe_l2": p2,
        "method": f"affine-extrapolation blocks={blocks}"}


def _as_adjusted(c: dict, extra: dict) -> dict:
    return dict({"flops_per_device": c["flops"],
                 "flops_by_dtype": c["flops_by_dtype"],
                 "hbm_bytes_per_device": c["bytes"],
                 "collective_bytes_per_device": c["coll"],
                 "collectives": c["breakdown"],
                 "replicated_ops": c["replicated_ops"]}, **extra)


def _probe_costs(cfg, shape, mesh, rules, include_optimizer,
                 policy=None) -> dict:
    """Costs at one microbatch (the reference's probe): at 1 and 2
    blocks, extrapolated; ``unrolled-direct`` without layers."""
    if not hasattr(cfg, "n_layers"):
        return _as_adjusted(_counts(cfg, shape, mesh, rules,
                                    include_optimizer, 1, policy),
                            {"method": "unrolled-direct"})
    return _as_adjusted(*_probe(cfg, shape, mesh, rules,
                                include_optimizer, 1, policy))


def _memory_run(cfg, shape, mesh, rules, include_optimizer,
                whole_depth: bool, policy=None) -> Tuple[dict, dict]:
    """The step's counts at the cell's own microbatch count: an LM's at
    1 and 2 blocks, extrapolated (its layers are checkpointed one at a
    time, so a block adds the same to every count), unless
    ``whole_depth``; the other families' at their whole depth (a
    GatedGCN checkpoints groups of 4 layers)."""
    if isinstance(cfg, LMConfig) and not whole_depth:
        return _probe(cfg, shape, mesh, rules, include_optimizer, None,
                      policy)
    return _counts(cfg, shape, mesh, rules, include_optimizer, None,
                   policy), {
        "method": "whole-depth" if hasattr(cfg, "n_layers")
        else "unrolled-direct"}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               include_optimizer: bool = True, probe: bool = True,
               mesh_sizes: Optional[MeshShape] = None, cfg=None,
               whole_depth: bool = False, policy=None) -> dict:
    """The dry run of one cell on the production mesh (or on a mesh of
    ``mesh_sizes``), with the reference's result keys.  ``cfg``
    overrides the registry's config of ``arch`` (a cut depth);
    ``whole_depth`` runs an LM's every layer instead of probing;
    ``policy`` overrides the cell's ``param_dtype``,
    ``n_microbatches``, ``optimizer`` or ``accum_dtype``."""
    cfg = cfg or get_arch(arch)
    shape = cfg.shape(shape_name)
    sizes = mesh_sizes or production_mesh_shape(multi_pod)
    rules = rules_for_family(cfg.family, shape.kind)
    t_start = time.time()
    with fake_group(sizes.size):
        # fake tensors name the CPU; they stand for the card's
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu") \
            if mesh_sizes is None else device_mesh(mesh_sizes, "cpu")
        t0 = time.time()
        cell = _build_cell(cfg, shape, get_api(cfg), mesh, rules,
                           include_optimizer=include_optimizer,
                           policy=policy)
        t_lower = time.time() - t0
        t0 = time.time()
        mem, info = _memory_run(cfg, shape, mesh, rules,
                                include_optimizer, whole_depth, policy)
        t_run = time.time() - t0
        adjusted = None
        if probe and cell.n_micro == 1:
            # the memory run counted the step at one microbatch already
            adjusted = _as_adjusted(mem, info)
        elif probe:
            try:
                adjusted = _probe_costs(cfg, shape, mesh, rules,
                                        include_optimizer, policy)
            except Exception as ex:  # noqa: BLE001 - reported, as there
                adjusted = {"error": f"{type(ex).__name__}: {ex}"}
    best = adjusted if adjusted and "flops_per_device" in adjusted else \
        _as_adjusted(mem, {})
    terms = roofline_terms(best["flops_by_dtype"],
                           best["hbm_bytes_per_device"],
                           best["collective_bytes_per_device"], sizes.size)
    arg_bytes = cell.argument_bytes(sizes)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": dict(sizes.shape),
        "multi_pod": multi_pod,
        "kind": shape.kind,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "seconds": round(time.time() - t_start, 2),
        "n_microbatches": cell.n_micro,
        "raw_flops_per_device": mem["flops"],
        "raw_hbm_bytes_per_device": mem["bytes"],
        "raw_collective_bytes_per_device": mem["coll"],
        "collectives": {k: {"count": c, "bytes": b}
                        for k, (c, b) in best["collectives"].items()},
        "adjusted": adjusted,
        "flops_per_device": best["flops_per_device"],
        "flops_by_dtype": best["flops_by_dtype"],
        "hbm_bytes_per_device": best["hbm_bytes_per_device"],
        "collective_bytes_per_device": best["collective_bytes_per_device"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": mem["output"],
            "peak_bytes": mem["peak"],
            "temp_bytes": mem["peak"] - arg_bytes,
            "method": info["method"],
        },
        "roofline": terms,
        "sharding_fallbacks": rules.fallbacks,
        "replicated_ops": sorted(set(mem["replicated_ops"]) | set(
            (adjusted or {}).get("replicated_ops", []))),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for a in archs:
        cfg = get_arch(a)
        names = [s.name for s in cfg.shapes]
        if args.shape:
            names = [n for n in names if n == args.shape]
        for n in names:
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                cells.append((a, n, mp))

    n_fail = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        path = out_dir / f"{tag}.json"
        if args.skip_existing and path.exists():
            print(f"[skip] {tag}")
            continue
        print(f"[cell] {tag} ...", flush=True)
        try:
            res = lower_cell(arch, shape, multi_pod=mp)
            path.write_text(json.dumps(res, indent=2, default=str))
            r = res["roofline"]
            print(f"  ok: {res['seconds']}s "
                  f"flops/dev={res['flops_per_device']:.3e} "
                  f"peak_mem={res['memory']['peak_bytes'] / 2**30:.2f}GiB "
                  f"bottleneck={r['bottleneck']}", flush=True)
        except Exception as ex:  # noqa: BLE001 - each cell reports
            n_fail += 1
            path.with_suffix(".err").write_text(
                f"{ex}\n\n{traceback.format_exc()}")
            print(f"  FAIL: {type(ex).__name__}: {ex}", flush=True)
    print(f"done: {len(cells) - n_fail}/{len(cells)} cells green")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
