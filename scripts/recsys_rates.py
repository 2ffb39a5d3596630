"""AdamW rates of the RecSys training step: the loss over 5 steps on one
fixed batch, through the JAX package and the port, on the CPU.

Each architecture runs at its published widths (embedding width, MLP,
cross layers, GRU width, history length, interests) with its vocab cut
to at most ``--vocab`` rows a field and a batch of ``--batch`` rows
(DIEN a quarter of it), drawn as ``chip_smoke.py``'s ``recsys`` phase
draws its batches: ids uniform over each field's vocab or the whole
table, history lengths 1..S, labels 0/1, dense features N(0, 1).  Both
packages start from the reference's ``init_params`` (key 0) and step
with their own ``make_train_step`` at each rate.  One JSON line per
(architecture, rate): both packages' losses, and whether each fell.

    PYTHONPATH=src python scripts/recsys_rates.py
    PYTHONPATH=src python scripts/recsys_rates.py --archs dcn-v2 \
        --rates 1e-4 3e-4 1e-3

It imports JAX: a CPU tool beside the tests, not part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.common.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.train.optimizer import make_train_step as jax_train_step  # noqa
from repro.train.optimizer import opt_init as jax_opt_init  # noqa: E402
from repro_torch.common.registry import get_arch  # noqa: E402
from repro_torch.models import api as A  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train.optimizer import make_train_step, opt_init  # noqa

STEPS = 5


def batch_of(cfg, specs, rng):
    """Numpy inputs of the shapes ``specs`` gives, drawn as the card's
    ``recsys`` phase draws them."""
    total = int(sum(cfg.vocab_sizes))
    out = {}
    for key, spec in specs.items():
        shape = tuple(spec.shape)
        if key == "sparse":
            hi = np.asarray(cfg.vocab_sizes)
            out[key] = np.minimum((rng.random(shape) * hi).astype(np.int64),
                                  hi - 1).astype(np.int32)
        elif key in ("hist", "target", "candidates"):
            out[key] = rng.integers(0, total, shape).astype(np.int32)
        elif key == "hist_len":
            out[key] = rng.integers(1, cfg.seq_len + 1, shape
                                    ).astype(np.int32)
        elif key == "labels":
            out[key] = rng.integers(0, 2, shape).astype(np.float32)
        else:
            out[key] = rng.standard_normal(shape).astype(np.float32)
    return out


def run(name, rates, vocab, batch_rows, seed):
    cut = dict(vocab_sizes=tuple(min(v, vocab)
                                 for v in jax_get_arch(name).vocab_sizes))
    cfg_j = dataclasses.replace(jax_get_arch(name), **cut)
    cfg = dataclasses.replace(get_arch(name), **cut)
    b = batch_rows // 4 if cfg.interaction == "augru" else batch_rows
    shape_j = dataclasses.replace(cfg_j.shape("train_batch"),
                                  batch=b)
    shape = dataclasses.replace(cfg.shape("train_batch"), batch=b)
    japi, api = JA.get_api(cfg_j), A.get_api(cfg)
    batch = batch_of(cfg, api.input_specs(shape),
                     np.random.default_rng(seed))
    params0, _, _ = JR.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for lr in rates:
        t0 = time.perf_counter()
        jstep = jax.jit(jax_train_step(japi.step_fn(shape_j), base_lr=lr))
        params = jax.tree.map(jnp.asarray, tree)
        jopt = jax_opt_init(params)
        model = params_from_numpy(tree, cfg, device=torch.device("cpu"))
        step = make_train_step(api.step_fn(shape), base_lr=lr)
        opt = opt_init(model)
        ref, port = [], []
        for _ in range(STEPS):
            params, jopt, jm = jstep(params, jopt, batch)
            model, opt, m = step(model, opt, tbatch)
            ref.append(float(jm["loss"]))
            port.append(float(m["loss"]))
        print(json.dumps({
            "arch": name, "base_lr": lr, "rows": b,
            "vocab_rows": int(sum(cfg.vocab_sizes)),
            "reference": ref, "port": port,
            "max_abs_diff": max(abs(a - c) for a, c in zip(ref, port)),
            "reference_fell": ref[-1] < ref[0],
            "port_fell": port[-1] < port[0],
            "seconds": time.perf_counter() - t0}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+",
                    default=["dcn-v2", "deepfm", "dien", "mind"])
    ap.add_argument("--rates", nargs="+", type=float,
                    default=[1e-4, 3e-4, 1e-3])
    ap.add_argument("--vocab", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    torch.manual_seed(0)
    for name in args.archs:
        run(name, args.rates, args.vocab, args.batch, args.seed)


if __name__ == "__main__":
    main()
