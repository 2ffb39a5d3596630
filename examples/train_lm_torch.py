"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch port.

The counterpart of ``examples/train_lm.py``, on ``repro_torch``: data
pipeline -> transformer (bf16 attention on the card's hand-written
``flash_attention`` kernels) -> AdamW + cosine schedule ->
checkpoints, with ``--resume`` (which continues from the latest
checkpoint up to ``--steps``).  The weights are drawn by the port's
``init_params`` from seed 0.  As in the reference, a run from the first
step asserts that its loss fell.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--device cpu] [--ckpt DIR] [--resume]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.common.config import LMConfig
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.optimizer import cosine_schedule


def small_lm() -> LMConfig:
    """~100M params: 8L x 512d x 8H, vocab 32k."""
    return LMConfig(
        name="demo-100m", family="lm-dense", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        max_seq_len=512)


def main(argv=None) -> LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro-torch-ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = small_lm()
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {n_params / 1e6:.1f}M params")

    make_batch = synthetic_lm_batches(cfg.vocab_size, args.batch,
                                      args.seq, seed=0)
    result = run_training(
        lambda p, b: T.loss_fn(p, b, cfg),
        params, make_batch,
        LoopConfig(max_steps=args.steps, ckpt_every=100,
                   ckpt_dir=args.ckpt, log_every=20,
                   n_microbatches=2),
        resume=args.resume,
        lr_schedule=cosine_schedule(3e-4, warmup=20,
                                    total=args.steps))
    start = result.final_step - len(result.losses)
    if not result.losses:
        print(f"nothing to train: the checkpoint is at step {start}")
        return result
    if start:
        print(f"resumed from step {start}")
    print(f"finished at step {result.final_step}: "
          f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f} "
          f"({result.wall_time_s:.1f}s, "
          f"{result.straggler_steps} straggler steps)")
    if not start:
        # a resumed run's few last steps are noise on random tokens:
        # the loss must fall over a run from the first step
        assert result.losses[-1] < result.losses[0]
    return result


if __name__ == "__main__":
    main()
