"""The JAX package's dry run of chosen cells, on Auto mesh axes.

``repro.launch.dryrun.lower_cell`` fails under JAX 0.9 on every cell
with its own mesh: ``jax.make_mesh`` now makes *Explicit* axes, where
the models' gathers raise ``ShardingTypeError`` (reference gap 7 in
ROADMAP.md).  This script swaps in a production mesh with *Auto* axes,
without editing the JAX package, and writes one JSON object a cell:
the reference's figures that the port's dry run
(``repro_torch.launch.dryrun``) stands beside, with the elements of the
fp32 conversions XLA on the CPU adds (``convert_elements``), which its
cost analysis counts as flops.

Run it in a fresh process (it forces 512 host devices before JAX
starts), on the CPU:

    PYTHONPATH=src python scripts/dryrun_reference.py \\
        deepfm:serve_p99 llama3-8b:decode_32k [--multi-pod] [--no-probe] \\
        [--all] [--out results/dryrun_reference] [--dots]
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.common.registry import get_arch, list_archs  # noqa: E402
from repro.launch import dryrun  # noqa: E402


_CONVERT_RE = re.compile(r"=\s*\w+\[([\d,]*)\][^ ]*\s+convert\(")


def convert_elements(hlo_text: str) -> int:
    """Elements of every ``convert`` in an HLO module, fused ones
    included.  XLA's cost analysis counts each as one flop; on the CPU
    it converts every bf16 operand of a product to fp32."""
    total = 0
    for dims in _CONVERT_RE.findall(hlo_text):
        n = 1
        for d in dims.split(",") if dims else ():
            n *= int(d)
        total += n
    return total


_DEF_RE = re.compile(r"(%[\w.\-]+) = \w+\[([\d,]*)\]")
_DOT_RE = re.compile(r"= \w+\[([\d,]*)\][^ ]* dot\((%[\w.\-]+), "
                     r"(%[\w.\-]+)\).*?lhs_contracting_dims=\{([\d,]*)\}")


def dot_flops(hlo_text: str) -> dict:
    """Every ``dot`` of an HLO module as "lhs x rhs -> out" -> flops
    (2 x output elements x contracted size), summed over equal shapes:
    the products a rank runs, to set beside the port's."""
    def dims(text):
        return [int(d) for d in text.split(",")] if text else []
    shapes = dict(_DEF_RE.findall(hlo_text))
    out: dict = {}
    for o, lhs, rhs, contracting in _DOT_RE.findall(hlo_text):
        n = 2
        for d in dims(o):
            n *= d
        for i in dims(contracting):
            n *= dims(shapes[lhs])[i]
        key = f"[{shapes[lhs]}] x [{shapes[rhs]}] -> [{o}]"
        out[key] = out.get(key, 0) + n
    return out


def count_converts(calls: list, dots=None) -> None:
    """Have ``dryrun._cost_dict`` note each compiled program's convert
    elements in ``calls``, in call order (the full cell, then its
    probes), and with ``dots`` (a list) each program's ``dot_flops``."""
    orig = dryrun._cost_dict

    def cost_dict(compiled):
        text = compiled.as_text()
        calls.append(convert_elements(text))
        if dots is not None:
            dots.append(dot_flops(text))
        return orig(compiled)
    dryrun._cost_dict = cost_dict


def with_converts(res: dict, calls: list) -> dict:
    """``res`` with ``convert_elements``: the full program's and, like
    ``adjusted``, the probes' extrapolated to the true depth."""
    raw, probes = calls[0], calls[1:]
    adj = res.get("adjusted") or {}
    method = adj.get("method", "")
    if len(probes) == 2 and method.startswith("affine"):
        blocks = int(method.split("blocks=")[1])
        adjusted = probes[0] + (blocks - 1) * (probes[1] - probes[0])
    else:
        adjusted = probes[0] if probes else raw
    res["convert_elements"] = {"raw": raw, "adjusted": adjusted}
    return res


def auto_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(axes))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", help="arch:shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dots", action="store_true",
                    help="add each probe program's dot products "
                         "(\"dots\": shapes -> flops), the last probe's "
                         "first: the depth a probe adds")
    args = ap.parse_args()
    dryrun.make_production_mesh = auto_production_mesh
    calls: list = []
    dots: list = [] if args.dots else None
    count_converts(calls, dots)
    cells = [tuple(c.split(":")) for c in args.cells]
    if args.all:
        cells = [(a, s.name) for a in list_archs()
                 for s in get_arch(a).shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out_dir = Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            t0 = time.time()
            calls.clear()
            if dots is not None:
                dots.clear()
            try:
                res = with_converts(dryrun.lower_cell(
                    arch, shape, multi_pod=mp, probe=not args.no_probe),
                    calls)
            except Exception as ex:  # noqa: BLE001 - each cell reports
                n_fail += 1
                print(json.dumps({"arch": arch, "shape": shape,
                                  "multi_pod": mp,
                                  "error": f"{type(ex).__name__}: {ex}"}))
                traceback.print_exc(file=sys.stderr)
                continue
            res["seconds"] = round(time.time() - t0, 2)
            if dots:
                res["dots"] = dict(sorted(dots[-1].items(),
                                          key=lambda kv: -kv[1]))
                res["probe_convert_elements"] = calls[1:]
            line = json.dumps(res, default=str)
            print(line, flush=True)
            if out_dir:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                (out_dir / f"{tag}.json").write_text(line)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
