"""Training loop with checkpoint/restart and straggler accounting.

As the JAX package's loop:

- the data pipeline is a pure function of (seed, step, shard);
- with ``ckpt_dir``, the model's tensors and the optimizer state are
  written asynchronously every ``ckpt_every`` steps and once more,
  blocking, at the end; ``resume=True`` loads the latest checkpoint
  into the model and the optimizer in place, on their device, and the
  run goes on from its step bit for bit as if it had not stopped;
- per-step wall times feed a straggler monitor (steps slower than
  ``straggler_factor`` x the running median are counted and logged);
- ``max_steps`` ends the run (the tests stop a run there and resume
  it).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager, \
    load_checkpoint
from repro_torch.train.optimizer import make_train_step, opt_init, \
    tree_leaves

logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    params: Any          # the model (updated in place)
    opt_state: Any
    step: int = 0


@dataclass
class LoopConfig:
    max_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    optimizer: str = "adamw"
    n_microbatches: int = 1
    base_lr: float = 3e-4


@dataclass
class LoopResult:
    final_step: int
    losses: List[float] = field(default_factory=list)
    straggler_steps: int = 0
    wall_time_s: float = 0.0
    step_s: List[float] = field(default_factory=list)   # per-step wall


def _ckpt_tree(state: TrainState) -> dict:
    """``{"params": {name: tensor}, "opt": AdamWState or
    AdafactorState}``: what a checkpoint holds, the optimizer's step as
    the reference's int32."""
    opt = state.opt_state
    return {"params": dict(state.params.named_parameters()),
            "opt": opt._replace(step=np.int32(opt.step))}


def _state_tensors(opt) -> list:
    return tree_leaves([getattr(opt, f) for f in opt._fields
                        if f != "step"])


@torch.no_grad()
def _load_into(state: TrainState, path: Path, step: int) -> None:
    """Copy checkpoint ``step`` into the model and the optimizer state
    in place (each tensor on its own device)."""
    _, tree, extra = load_checkpoint(path, step,
                                     template=_ckpt_tree(state))
    named = dict(state.params.named_parameters())
    for name, value in tree["params"].items():
        named[name].copy_(value)
    opt = state.opt_state
    for dst, src in zip(_state_tensors(opt), _state_tensors(tree["opt"])):
        dst.copy_(src)
    # both optimizers read the step (bias correction, beta2): it must
    # round-trip exactly
    state.opt_state = opt._replace(step=int(tree["opt"].step))
    state.step = int(extra["step"])


def run_training(loss_fn: Callable, params: Any,
                 make_batch: Callable[[int], Dict[str, np.ndarray]],
                 cfg: LoopConfig, *, resume: bool = False,
                 lr_schedule=None) -> LoopResult:
    """Train ``params`` (an ``LM``, updated in place) up to step
    ``max_steps`` of ``make_batch(step)``, from the latest checkpoint in
    ``ckpt_dir`` under ``resume=True``.  A step's wall time ends when
    its loss reaches the host, which waits for the device."""
    state = TrainState(params=params,
                       opt_state=opt_init(params, cfg.optimizer))
    manager = None
    if cfg.ckpt_dir:
        manager = CheckpointManager(Path(cfg.ckpt_dir), keep=cfg.keep)
        if resume:
            latest = manager.latest_step()
            if latest is not None:
                _load_into(state, manager.path, latest)
                logger.info("resumed from step %d", state.step)
    step_fn = make_train_step(
        loss_fn, n_microbatches=cfg.n_microbatches,
        optimizer=cfg.optimizer, base_lr=cfg.base_lr,
        lr_schedule=lr_schedule)

    result = LoopResult(final_step=state.step)
    t_start = time.perf_counter()
    while state.step < cfg.max_steps:
        batch = make_batch(state.step)
        t0 = time.perf_counter()
        state.params, state.opt_state, metrics = step_fn(
            state.params, state.opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        state.step += 1
        result.losses.append(loss)
        # straggler monitor
        if len(result.step_s) >= 5:
            med = float(np.median(result.step_s))
            if dt > cfg.straggler_factor * med:
                result.straggler_steps += 1
                logger.warning("straggler step %d: %.3fs vs median "
                               "%.3fs", state.step, dt, med)
        result.step_s.append(dt)
        if cfg.log_every and state.step % cfg.log_every == 0:
            logger.info("step %d loss %.4f (%.3fs)", state.step, loss,
                        dt)
        if manager and state.step % cfg.ckpt_every == 0:
            manager.save_async(state.step, _ckpt_tree(state),
                               extra={"step": state.step})
    if manager:
        manager.save(state.step, _ckpt_tree(state),
                     extra={"step": state.step})
    result.final_step = state.step
    result.wall_time_s = time.perf_counter() - t_start
    return result
