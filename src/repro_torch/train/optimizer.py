"""AdamW + global-norm clipping + schedules, and the train step.

The JAX package's math, leaf by leaf in fp32: master weights and both
moments are fp32 whatever the compute dtype.  Unlike the reference,
which returns new arrays, the update here is in place (parameters and
moments), so a step holds one leaf's temporaries at a time rather than
a second copy of the weights.

Adafactor (and the reduced-precision accumulation that goes with it)
is not ported yet and raises.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import not_ported

ADAFACTOR_ITEM = "12. Adafactor"


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


def opt_init(model: torch.nn.Module, kind: str = "adamw") -> AdamWState:
    if kind != "adamw":
        raise not_ported(f"the {kind} optimizer", ADAFACTOR_ITEM)
    return adamw_init(list(model.parameters()))


def opt_update(params, grads, state, *, lr, kind: str = "adamw"):
    if kind != "adamw":
        raise not_ported(f"the {kind} optimizer", ADAFACTOR_ITEM)
    return adamw_update(params, grads, state, lr=lr)


def make_train_step(loss_fn: Callable, *,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    base_lr: float = 3e-4, n_microbatches: int = 1,
                    optimizer: str = "adamw",
                    accum_dtype: torch.dtype = torch.float32):
    """(model, opt_state, batch) -> (model, opt_state, metrics), with
    ``loss_fn(model, batch) -> (loss, metrics)``.

    ``n_microbatches > 1`` splits the batch's leading axis into equal
    slices, runs forward and backward on each in turn (saved activations
    bound to one slice), sums their fp32 gradients and divides by the
    count; the reported loss and metrics are the slices' means.  The
    learning rate is ``lr_schedule(opt_state.step)``, read before the
    step's increment (so with warmup, step 0's rate is 0).
    """
    if optimizer != "adamw":
        raise not_ported(f"the {optimizer} optimizer", ADAFACTOR_ITEM)
    if accum_dtype != torch.float32:
        raise not_ported(f"gradient accumulation in {accum_dtype}",
                         ADAFACTOR_ITEM)

    def train_step(model, opt_state, batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if n_microbatches == 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            loss, metrics = loss.detach(), \
                {k: v.detach() for k, v in metrics.items()}
        else:
            losses, ms = [], []
            mb_size = len(batch["tokens"]) // n_microbatches
            for i in range(n_microbatches):
                mb = {k: x[i * mb_size:(i + 1) * mb_size]
                      for k, x in batch.items()}
                loss_i, m = loss_fn(model, mb)
                loss_i.backward()       # sums into the fp32 .grad
                losses.append(loss_i.detach())
                ms.append({k: v.detach() for k, v in m.items()})
            for p in params:
                p.grad.div_(n_microbatches)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        lr = lr_schedule(opt_state.step) if lr_schedule else base_lr
        _, opt_state, om = opt_update(params, [p.grad for p in params],
                                      opt_state, lr=lr, kind=optimizer)
        for p in params:
            p.grad = None
        return model, opt_state, dict(metrics, loss=loss, **om)
    return train_step
