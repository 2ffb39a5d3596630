"""DIEN's GRU counted both ways, on the CPU: XLA's cost analysis of the
JAX package's ``_gru_cell`` and the port's ``StepCounter`` on its
``_gru_cell``, at DIEN's widths (embed 18, GRU 108) for one batch of
rows: one step forward, one step forward and backward, and the
reference's ``lax.scan`` of ``--steps`` steps (a rolled loop, and
unrolled) against the port's Python loop of the same steps, forward
and backward.  The dry run's DIEN ``train_batch`` cell runs two such
loops of 100 steps; this says whether a count misses work or XLA's
count of the scan adds some.

    PYTHONPATH=src python scripts/gru_step_flops.py [--rows 256]
        [--steps 100]

Prints one JSON object: flops (less dtype conversions, which fp32 has
none of) by route.
"""
import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import recsys as JR  # noqa: E402
from repro_torch.distributed.comm_analysis import StepCounter  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

D_IN, D_H = 18, 108


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost["flops"])


def reference(rows: int, steps: int) -> dict:
    rng = np.random.default_rng(0)
    p = {"wi": jnp.asarray(rng.standard_normal((D_IN, 3 * D_H)), jnp.float32),
         "wh": jnp.asarray(rng.standard_normal((D_H, 3 * D_H)), jnp.float32),
         "b": jnp.zeros((3 * D_H,), jnp.float32)}
    h = jnp.zeros((rows, D_H), jnp.float32)
    x = jnp.asarray(rng.standard_normal((rows, D_IN)), jnp.float32)
    xs = jnp.asarray(rng.standard_normal((steps, rows, D_IN)), jnp.float32)

    def step(p, h, x):
        return JR._gru_cell(p, h, x).sum()

    def scan(p, xs, unroll):
        def body(h, x):
            h = JR._gru_cell(p, h, x)
            return h, None
        return jax.lax.scan(body, jnp.zeros((rows, D_H)), xs,
                            unroll=unroll)[0].sum()
    out = {"step_fwd": _xla_flops(step, p, h, x),
           "step_fwd_bwd": _xla_flops(jax.value_and_grad(step), p, h, x)}
    for name, unroll in (("scan", 1), ("scan_unrolled", True)):
        out[f"{name}_fwd"] = _xla_flops(
            lambda p, xs: scan(p, xs, unroll), p, xs)
        out[f"{name}_fwd_bwd"] = _xla_flops(jax.value_and_grad(
            lambda p, xs: scan(p, xs, unroll)), p, xs)
    return out


def port(rows: int, steps: int) -> dict:
    def params():
        g = torch.Generator().manual_seed(0)
        return {k: v.requires_grad_() for k, v in
                R._gru_init(g, D_IN, D_H).items()}

    def count(fn, backward: bool) -> float:
        p = params()
        with StepCounter() as counter:
            out = fn(p).sum()
            if backward:
                out.backward()
        return counter.total_flops - counter.flops.get("convert", 0)

    x = torch.randn(rows, D_IN)
    xs = torch.randn(steps, rows, D_IN)

    def step(p):
        return R._gru_cell(p, torch.zeros(rows, D_H), x)

    def loop(p):
        h = torch.zeros(rows, D_H)
        for t in range(steps):
            h = R._gru_cell(p, h, xs[t])
        return h
    return {"step_fwd": count(step, False), "step_fwd_bwd": count(step, True),
            "loop_fwd": count(loop, False), "loop_fwd_bwd": count(loop, True)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    print(json.dumps({"rows": args.rows, "steps": args.steps,
                      "d_in": D_IN, "d_h": D_H,
                      "reference_xla": reference(args.rows, args.steps),
                      "port_step_counter": port(args.rows, args.steps)}))


if __name__ == "__main__":
    main()
