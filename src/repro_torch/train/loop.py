"""Training loop with straggler accounting.

As the JAX package's loop: the data pipeline is a pure function of
(seed, step, shard), per-step wall times feed a straggler monitor
(steps slower than ``straggler_factor`` x the running median are
counted and logged), and ``max_steps`` ends the run.  Checkpoints and
resume are not ported yet and raise.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.common.config import not_ported
from repro_torch.train.optimizer import make_train_step, opt_init

logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    params: Any          # the model (updated in place)
    opt_state: Any
    step: int = 0


@dataclass
class LoopConfig:
    max_steps: int = 100
    ckpt_dir: Optional[str] = None   # not ported: must stay None
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


def run_training(loss_fn: Callable, params: Any,
                 make_batch: Callable[[int], Dict[str, np.ndarray]],
                 cfg: LoopConfig, *, resume: bool = False,
                 lr_schedule=None) -> LoopResult:
    """Train ``params`` (an ``LM``, updated in place) for ``max_steps``
    steps of ``make_batch(step)``.  A step's wall time ends when its
    loss reaches the host, which waits for the device."""
    if cfg.ckpt_dir or resume:
        raise not_ported("checkpointed training (ckpt_dir, resume)",
                         "6. Lifecycle and checkpoint")
    state = TrainState(params=params,
                       opt_state=opt_init(params, cfg.optimizer))
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
    result.final_step = state.step
    result.wall_time_s = time.perf_counter() - t_start
    return result
