"""GatedGCN (Bresson & Laurent; benchmarked in arXiv:2003.00982).

The JAX package's model as torch ops.  Edge update:

    e'_ij = D h_i + E h_j + C e_ij
    eta_ij = sigmoid(e'_ij)
    h'_i  = A h_i + ( sum_j eta_ij * (B h_j) ) / ( sum_j eta_ij + eps )

with residuals + norm on both node and edge streams, which run in bf16
(the norms in fp32 inside).  The weights are a ``ParamTree`` of the
reference's tree; the layers' weights stack on a leading
``(n_layers, ...)`` axis, as the reference's ``vmap``ped init stacks
them.

Message passing runs over ``Segments``: an edge index sorted once a
forward (stable, so edges keep their order within a node), each
segment reduced in that order in fp32 (``torch.segment_reduce``: one
thread a segment and feature, a sequential sum) and rounded once to the
stream's dtype.  The gathers ``h[src]``, ``h[dst]`` have the same
sorted sums as their backward.  No sum uses atomics, so a forward and
a backward on the card repeat bitwise, and recomputing a checkpointed
group gives the bits it gave the first time.  The reference sums with
``jax.ops.segment_sum`` in bf16; the port's single rounding is no less
accurate (``tests/test_torch_gnn.py`` holds both to an fp64 numpy
evaluation).  The plan and the sums are custom ops
(``segment_plan``, ``segment_sum``) with shape contracts and DTensor
rules, so the dry run partitions them by edges: each rank plans and
sums its own edges into partial node sums.

The layers run in groups of ``remat_group`` under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on a
scan of groups): only the groups' boundary (h, e) persist for the
backward.

Includes the fanout neighbor sampler of the ``minibatch_lg`` shape
(GraphSAGE-style, host numpy over CSR), whose draws are the
reference's, bitwise.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import GNNConfig
from repro_torch.common.utils import as_tensor
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import ParamTree, dense_init
from repro_torch.models.sharding_ctx import shard

Batch = Dict[str, Any]
EPS = 1e-6
LAYER_KEYS = ("A", "B", "C", "D", "E", "ln_h", "ln_e")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_params(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                d_feat: int = 128, d_edge_feat: int = 0,
                dtype=torch.float32) -> Tuple[ParamTree, Dict]:
    """(weights, their logical axes) on the generator's device (default:
    a new generator on ``cuda``, seed 0)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device()).manual_seed(0)
    d, dev = cfg.d_hidden, generator.device
    enc_h = dense_init(generator, d_feat, d, dtype=dtype)
    enc_e = dense_init(generator, max(d_edge_feat, 1), d, dtype=dtype)
    per_layer = [{n: dense_init(generator, d, d, dtype=dtype)
                  for n in "ABCDE"} for _ in range(cfg.n_layers)]
    layers = {n: torch.stack([lp[n] for lp in per_layer]) for n in "ABCDE"}
    for n in ("ln_h", "ln_e"):
        layers[n] = torch.ones((cfg.n_layers, d), dtype=dtype, device=dev)
    params = {"enc_h": enc_h, "enc_e": enc_e, "layers": layers,
              "head": dense_init(generator, d, cfg.n_classes, dtype=dtype)}
    axes = {
        "enc_h": (None, "hidden"),
        "enc_e": (None, "hidden"),
        "layers": {n: ("layers", "hidden", "hidden") for n in "ABCDE"}
        | {"ln_h": ("layers", "hidden"), "ln_e": ("layers", "hidden")},
        "head": ("hidden", None),
    }
    return ParamTree(params), axes


def _norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) *
            w.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# segment sums in a fixed order
# ---------------------------------------------------------------------------
class Segments(NamedTuple):
    """An index of rows into ``n`` segments, sorted: ``index`` (E,) the
    segment of each row, ``perm`` the rows in segment order (stable),
    ``lengths`` (n,) the rows of each segment."""

    index: torch.Tensor
    perm: torch.Tensor
    lengths: torch.Tensor


@torch.library.custom_op("repro_torch::segment_plan", mutates_args=())
def _segment_plan(index: torch.Tensor, n: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the rows in segment order (a stable sort), the rows of each of
    the ``n`` segments)."""
    return torch.sort(index, stable=True).indices, \
        torch.bincount(index, minlength=n)


@_segment_plan.register_fake
def _segment_plan_fake(index, n):
    return index.new_empty(index.shape), index.new_empty((n,))


@torch.library.custom_op("repro_torch::segment_sum", mutates_args=())
def _segment_sum_op(x: torch.Tensor, perm: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    xs = x.index_select(0, perm).to(torch.float32)
    return torch.segment_reduce(xs, "sum", lengths=lengths,
                                axis=0).to(x.dtype)


@_segment_sum_op.register_fake
def _segment_sum_fake(x, perm, lengths):
    return x.new_empty((lengths.shape[0],) + tuple(x.shape[1:]))


def register_dtensor_sharding() -> None:
    """DTensor sharding rules of the segment ops (called by the dry
    run): rows sharded, each rank plans and sums its own rows, and the
    segment lengths and sums are partial (their sum over ranks is the
    whole); or features sharded over a replicated plan; or all
    replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.dtensor_rules import register_op_rule
    R, P = Replicate(), Partial()
    register_op_rule(torch.ops.repro_torch.segment_plan.default,
                     lambda: [[R, R, R, None],
                              [Shard(0), P, Shard(0), None]], n_out=2)
    register_op_rule(torch.ops.repro_torch.segment_sum.default,
                     lambda: [[R, R, R, R], [P, Shard(0), Shard(0), P],
                              [Shard(1), Shard(1), R, R]], n_out=1)


def segments(index: torch.Tensor, n: int) -> Segments:
    index = index.to(torch.int64)
    perm, lengths = torch.ops.repro_torch.segment_plan(index, n)
    return Segments(index, perm, lengths)


def _segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(E, ...) -> (n, ...): each segment's rows summed in row order in
    fp32, rounded once to ``x``'s dtype (no autograd)."""
    return torch.ops.repro_torch.segment_sum(x, seg.perm, seg.lengths)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return _segment_sum(x, seg)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg.index), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.index)

    @staticmethod
    def backward(ctx, g):
        return _segment_sum(g, ctx.seg), None


def segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg.index, n)`` in a fixed order, its
    backward a gather."""
    return _SegmentSum.apply(x, seg)


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``x[seg.index]``, its backward the fixed-order segment sum."""
    return _Gather.apply(x, seg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer(lp: Dict[str, torch.Tensor], h: torch.Tensor, e: torch.Tensor,
           src: Segments, dst: Segments
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    h_src = shard(gather(h, src), ("edges", None))        # (E, d)
    h_dst = shard(gather(h, dst), ("edges", None))
    e_new = h_dst @ lp["D"] + h_src @ lp["E"] + e @ lp["C"]
    e_new = shard(e_new, ("edges", None))
    eta = torch.sigmoid(e_new)
    msg = shard(eta * (h_src @ lp["B"]), ("edges", None))  # (E, d)
    agg = segment_sum(msg, dst)
    den = segment_sum(eta, dst)
    agg = shard(agg, ("nodes", None))
    den = shard(den, ("nodes", None))
    h_new = h @ lp["A"] + agg / (den + EPS)
    h = h + torch.relu(_norm(h_new, lp["ln_h"]))          # residual
    h = shard(h, ("nodes", None))
    e = e + torch.relu(_norm(e_new, lp["ln_e"]))
    e = shard(e, ("edges", None))
    return h, e


def _group(h, e, src, dst, *stacks):
    """The layers of one group: ``stacks`` are the group's slices of
    the stacked layer weights, in ``LAYER_KEYS`` order."""
    for i in range(stacks[0].shape[0]):
        h, e = _layer({k: s[i] for k, s in zip(LAYER_KEYS, stacks)},
                      h, e, src, dst)
    return h, e


def forward(params: ParamTree, node_feat, edge_index, cfg: GNNConfig,
            edge_feat=None, remat_group: int = 4) -> torch.Tensor:
    """node_feat: (N, d_feat); edge_index: (2, E) int -> (N, classes)
    fp32 logits.

    Layers run in groups of ``remat_group`` (1 when it does not divide
    the depth), each under ``torch.utils.checkpoint``: only the groups'
    boundary (h, e) persist for the backward.  ``remat_group=0`` runs
    the layers without checkpoints (same bits; more memory)."""
    dev = params["enc_h"].device
    node_feat = as_tensor(node_feat, dev, torch.float32)
    edge_index = as_tensor(edge_index, dev, torch.int64)
    n_nodes = node_feat.shape[0]
    src = segments(edge_index[0], n_nodes)
    dst = segments(edge_index[1], n_nodes)
    # bf16 node/edge streams; norms and softmax stay fp32 internally
    cdt = torch.bfloat16
    h = (node_feat @ params["enc_h"]).to(cdt)
    if edge_feat is None:
        edge_feat = torch.ones((edge_index.shape[1], 1), dtype=cdt,
                               device=dev)
    e = as_tensor(edge_feat, dev, cdt) @ params["enc_e"].to(cdt)
    e = shard(e, ("edges", None))
    stacks = [params["layers"][k].to(cdt) for k in LAYER_KEYS]

    g = remat_group if remat_group and \
        cfg.n_layers % remat_group == 0 else 1
    for i in range(0, cfg.n_layers, g):
        part = [s[i:i + g] for s in stacks]
        if remat_group:
            h, e = checkpoint(_group, h, e, src, dst, *part,
                              use_reentrant=False)
        else:
            h, e = _group(h, e, src, dst, *part)
    return (h @ params["head"].to(cdt)).to(torch.float32)


def loss_fn(params: ParamTree, batch: Batch, cfg: GNNConfig,
            remat_group: int = 4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch["node_feat"], batch["edge_index"],
                     cfg, batch.get("edge_feat"), remat_group)
    labels = as_tensor(batch["labels"], logits.device, torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll = logz - gold
    mask = batch.get("label_mask")
    if mask is not None:
        mask = as_tensor(mask, logits.device, torch.bool)
        nll = torch.where(mask, nll, torch.zeros_like(nll))
        loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    else:
        loss = nll.mean()
    return loss, {"nll": loss}


def batched_graph_forward(params: ParamTree, node_feat, edge_index,
                          graph_ids, cfg: GNNConfig,
                          n_graphs: int) -> torch.Tensor:
    """Batched small graphs (``molecule`` shape): graph-level readout.

    node_feat: (B*n, d); edge_index global over the packed batch;
    graph_ids: (B*n,) graph assignment -> (n_graphs, classes)."""
    h = forward(params, node_feat, edge_index, cfg)
    seg = segments(as_tensor(graph_ids, h.device, torch.int64), n_graphs)
    pooled = segment_sum(h, seg)
    counts = seg.lengths.to(h.dtype)[:, None]
    return pooled / torch.clamp(counts, min=1.0)


# ---------------------------------------------------------------------------
# neighbor sampler (minibatch_lg)
# ---------------------------------------------------------------------------
class NeighborSampler:
    """GraphSAGE fanout sampler over CSR adjacency (host-side)."""

    def __init__(self, n_nodes: int, edge_index: np.ndarray, seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.src_sorted = src[order].astype(np.int64)
        self.indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.n_nodes = n_nodes
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def sample(self, seeds: np.ndarray, fanout: Tuple[int, ...]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (subgraph nodes, local edge_index (2, E'), seed mask).

        Layered sampling: hop h samples ``fanout[h]`` in-neighbors of
        the current frontier; the union becomes the subgraph.
        """
        nodes = list(dict.fromkeys(seeds.tolist()))
        node_set = dict((n, i) for i, n in enumerate(nodes))
        edges_src: list = []
        edges_dst: list = []
        frontier = list(nodes)
        for f in fanout:
            nxt = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                pick = self.rng.choice(deg, size=take, replace=False)
                for u in self.src_sorted[lo + pick]:
                    u = int(u)
                    if u not in node_set:
                        node_set[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    edges_src.append(node_set[u])
                    edges_dst.append(node_set[v])
            frontier = nxt
            if not frontier:
                break
        edge_index = np.asarray([edges_src, edges_dst], dtype=np.int32) \
            if edges_src else np.zeros((2, 0), dtype=np.int32)
        seed_mask = np.zeros(len(nodes), dtype=bool)
        seed_mask[: len(set(seeds.tolist()))] = True
        return np.asarray(nodes, dtype=np.int64), edge_index, seed_mask
