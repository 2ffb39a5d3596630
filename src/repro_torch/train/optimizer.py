"""AdamW + global-norm clipping + schedules, Adafactor, and the train
step.

The JAX package's math, leaf by leaf: master weights are fp32 whatever
the compute dtype, and so are AdamW's moments and Adafactor's
statistics.  Unlike the reference, which returns new arrays, the update
here is in place (parameters and optimizer state), so a step holds one
leaf's temporaries at a time rather than a second copy of the weights.

AdamW is element-wise but for its global clip, so it runs over
``model.parameters()``.  Adafactor's statistics and clip are per leaf of
the reference's parameter tree, whose ``layers`` leaves stack the
layers of a block position on a leading axis: a stacked leaf of 2-D
weights is 3-D (row and column statistics a layer, one RMS clip over
the stack), and the norms' (n_blocks, d) stack is factored too.  So
Adafactor runs over that tree (``convert.param_tree``), each stacked
leaf a ``Stack`` of the port's per-layer parameters, and its state
mirrors the tree: a checkpoint of it has the reference's path keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import param_tree
from repro_torch.models.sharding_ctx import laid_out_as


class AdamWState(NamedTuple):
    step: int                       # updates applied so far
    mu: List[torch.Tensor]          # first moment, one per parameter
    nu: List[torch.Tensor]          # second moment, one per parameter


def adamw_init(params) -> AdamWState:
    mu = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for p in params]
    return AdamWState(step=0, mu=mu, nu=[torch.zeros_like(m) for m in mu])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return [g * scale for g in grads], gnorm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0
                 ) -> Tuple[list, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with weight decay on every leaf (norms and the
    embedding included), in place on ``params`` and the state."""
    params = list(params)
    grads, gnorm = clip_by_global_norm(
        [g.to(torch.float32) for g in grads], max_grad_norm)
    step = state.step + 1
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for i, (p, m, v) in enumerate(zip(params, state.mu, state.nu)):
        g, grads[i] = grads[i], None          # free each leaf when done
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + \
            weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[int], float]:
    """Linear warmup from 0, then a half cosine to 0 at ``total``; in
    fp32, as the reference computes it."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(base_lr) * s / f32(max(warmup, 1)))
        t = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                    f32(0.0), f32(1.0))
        return float(f32(0.5 * base_lr) *
                     (f32(1.0) + np.cos(f32(math.pi) * t)))
    return lr


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern, arXiv:1804.04235)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Stack:
    """One leaf of the reference's parameter tree that the port holds as
    one tensor a block: the leaf is their stack on a new first axis."""

    tensors: Tuple[torch.Tensor, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.tensors),) + tuple(self.tensors[0].shape)

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    def value(self) -> torch.Tensor:
        return torch.stack(self.tensors)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples, in
    ``jax.tree_util``'s order (dict keys sorted; None is empty)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


class AdafactorState(NamedTuple):
    step: int       # updates applied so far
    vr: Any         # row second moment (last axis reduced), per leaf
    vc: Any         # column second moment (second-to-last reduced)
    v: Any          # full second moment, leaves of fewer than 2 axes


def adafactor_init(params: Any) -> AdafactorState:
    """Zeroed statistics for a tree of tensors and ``Stack``s: a leaf of
    2 or more axes gets fp32 rows (its shape but the last axis) and
    columns (but the second to last) and a scalar ``v``; a smaller leaf
    a full fp32 ``v`` and scalar rows and columns."""
    def zeros(shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def rows(p):
        return zeros(p.shape[:-1] if len(p.shape) >= 2 else (), p.device)

    def cols(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if len(p.shape) >= 2
                     else (), p.device)

    def full(p):
        return zeros(p.shape if len(p.shape) < 2 else (), p.device)

    return AdafactorState(step=0, vr=tree_map(rows, params),
                          vc=tree_map(cols, params),
                          v=tree_map(full, params))


def _put(p, new: torch.Tensor) -> None:
    """Write a leaf's new value into its tensor, or a ``Stack``'s."""
    if isinstance(p, Stack):
        for t, n in zip(p.tensors, new):
            t.copy_(n)
    else:
        p.copy_(new)


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, state: AdafactorState, *,
                     lr: float, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     update_dtype: torch.dtype = torch.float32
                     ) -> Tuple[Any, AdafactorState, Dict]:
    """One Adafactor step, in place on ``params`` (a tree of tensors and
    ``Stack``s) and the state; ``grads`` is the same tree (a ``Stack``'s
    gradient a tensor or a ``Stack``, stacked when its leaf's turn
    comes, so one leaf's copies are held at a time).
    ``update_dtype=bfloat16`` keeps the update's per-element
    temporaries, and the weights as they are updated, in bf16 (the
    factored statistics stay fp32), as the reference's large-MoE policy
    does."""
    step = state.step + 1
    f32 = np.float32
    beta2 = float(f32(1.0) - f32(step) ** f32(-decay))
    keep = float(f32(1.0) - f32(beta2))

    def upd(p, g, vr, vc, v):
        value = p.value() if isinstance(p, Stack) else p
        g = g.value() if isinstance(g, Stack) else g
        if g.dim() >= 2:
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            vr.copy_(beta2 * vr + keep * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + keep * g2.mean(dim=-2))
            # u = g / sqrt(outer(vr, vc) / mean(vr))
            r = vr / vr.mean(dim=-1, keepdim=True).clamp_min(eps)
            fac_r = torch.rsqrt(r.clamp_min(eps)).to(update_dtype)
            fac_c = torch.rsqrt(vc.clamp_min(eps)).to(update_dtype)
            del gf, g2, r
            u = g.to(update_dtype) * fac_r[..., None] * fac_c[..., None, :]
            rms = torch.sqrt(torch.mean(u.to(torch.float32) ** 2) + eps)
            u = u * (1.0 / torch.clamp(rms / clip_threshold, min=1.0)
                     ).to(update_dtype)
            lr_t = torch.tensor(lr, dtype=update_dtype, device=u.device)
            _put(p, (value.to(update_dtype) - lr_t * u).to(value.dtype))
            return
        g = g.to(torch.float32)
        v.copy_(beta2 * v + keep * (g * g + eps))
        u = g * torch.rsqrt(v)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        _put(p, (value.to(torch.float32) - lr * u).to(value.dtype))

    for p, g, vr, vc, v in zip(tree_leaves(params), tree_leaves(grads),
                               tree_leaves(state.vr), tree_leaves(state.vc),
                               tree_leaves(state.v)):
        upd(p, g, vr, vc, v)
    return params, AdafactorState(step, state.vr, state.vc, state.v), {}


def adafactor_params(model: torch.nn.Module) -> Dict:
    """``model``'s parameters as the reference's parameter tree, each
    stacked leaf a ``Stack`` (see ``convert.param_tree``)."""
    return param_tree(model, lambda ps, stacked: Stack(tuple(ps))
                      if stacked else ps[0])


def opt_init(model: torch.nn.Module, kind: str = "adamw"):
    if kind == "adamw":
        return adamw_init(list(model.parameters()))
    if kind == "adafactor":
        return adafactor_init(adafactor_params(model))
    raise ValueError(f"unknown optimizer {kind!r}")


def opt_update(model: torch.nn.Module, grads: List[torch.Tensor], state,
               *, lr, kind: str = "adamw",
               update_dtype: torch.dtype = torch.float32):
    """One step of ``kind`` on ``model``, in place, from ``grads`` (one
    a parameter, in ``model.parameters()`` order)."""
    params = list(model.parameters())
    if kind == "adamw":
        return adamw_update(params, grads, state, lr=lr)
    if kind != "adafactor":
        raise ValueError(f"unknown optimizer {kind!r}")
    grad_of = {id(p): g for p, g in zip(params, grads)}
    tree = adafactor_params(model)
    gtree = tree_map(lambda p: Stack(tuple(grad_of[id(t)] for t in
                                           p.tensors))
                     if isinstance(p, Stack) else grad_of[id(p)], tree)
    return adafactor_update(tree, gtree, state, lr=lr,
                            update_dtype=update_dtype)


def microbatch(batch: Any, i: int, n: int) -> Any:
    """Slice ``i`` of ``n`` of every leaf of a batch (dicts, lists and
    tuples of arrays), each cut along its own leading axis into equal
    slices, as the reference's ``dynamic_slice_in_dim`` cuts them."""
    if isinstance(batch, dict):
        return {k: microbatch(v, i, n) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(microbatch(v, i, n) for v in batch)
    size = batch.shape[0] // n
    return batch[i * size:(i + 1) * size]


def make_train_step(loss_fn: Callable, *,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    base_lr: float = 3e-4, n_microbatches: int = 1,
                    optimizer: str = "adamw",
                    accum_dtype: torch.dtype = torch.float32):
    """(model, opt_state, batch) -> (model, opt_state, metrics), with
    ``loss_fn(model, batch) -> (loss, metrics)``.

    ``n_microbatches > 1`` splits every batch leaf's leading axis into
    equal slices (``microbatch``), runs forward and backward on each in
    turn (saved activations bound to one slice), sums their gradients
    in ``accum_dtype`` (each slice's cast to it; in ``.grad`` itself
    where that is its dtype) and divides the sum by the count; the reported loss and metrics are the
    slices' means.  One microbatch keeps its gradients as they are.  The
    update runs in ``accum_dtype`` too (Adafactor's ``update_dtype``).
    The learning rate is ``lr_schedule(opt_state.step)``, read before
    the step's increment (so with warmup, step 0's rate is 0).
    """
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def train_step(model, opt_state, batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if n_microbatches == 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            loss, metrics = loss.detach(), \
                {k: v.detach() for k, v in metrics.items()}
            grads = [p.grad for p in params]
        else:
            losses, ms = [], []
            acc: List[Optional[torch.Tensor]] = [None] * len(params)
            for i in range(n_microbatches):
                mb = microbatch(batch, i, n_microbatches)
                loss_i, m = loss_fn(model, mb)
                loss_i.backward()       # sums into .grad
                losses.append(loss_i.detach())
                ms.append({k: v.detach() for k, v in m.items()})
                for j, p in enumerate(params):
                    if p.grad.dtype != accum_dtype:
                        g, p.grad = p.grad.to(accum_dtype), None
                        acc[j] = g if acc[j] is None else acc[j].add_(g)
            grads = [a if a is not None else p.grad
                     for a, p in zip(acc, params)]
            for g in grads:
                g.div_(n_microbatches)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads = [laid_out_as(g, p) for g, p in zip(grads, params)]
        lr = lr_schedule(opt_state.step) if lr_schedule else base_lr
        _, opt_state, om = opt_update(model, grads, opt_state, lr=lr,
                                      kind=optimizer,
                                      update_dtype=accum_dtype)
        for p in params:
            p.grad = None
        return model, opt_state, dict(metrics, loss=loss, **om)
    return train_step
