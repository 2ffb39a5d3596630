"""Where the ``mips_topk`` scan's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.mips_topk.breakdown

Builds ``csrc/mips_topk.cu`` and instrumented copies of it, each with one
part of the scan switched off, and times every build's launcher at
n = 2^22 rows of d = 259 (b = 64 and b = 1) and at the main path's
n = 32768, b = 64, k = 8.  The variants are:

- ``full``          the kernel as shipped;
- ``no_fold``       no top-k fold (the scores are summed so that the
                    FMAs stay);
- ``fma_only``      no fold and no row staging (the FMAs on whatever the
                    stages hold);
- ``fma_registers`` ``fma_only`` with both operands from registers, not
                    shared memory: the FMA loop's own ceiling;
- ``loads_only``    no fold and no FMAs: the staging pipeline alone.

Only ``full`` computes the right answer; the others are timed, not
checked.  Prints one JSON object per shape, and the card's name and power
limit first.  The copies are built into ``build/mips_topk_breakdown/``
(``kernels/timing.py`` builds and times them).
"""
from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict, Tuple

# Each switch: (the source text it replaces, the replacement).  A switch
# whose text is missing from the source raises: the copy must be the
# shipped kernel with exactly these parts cut.
SWITCHES: Dict[str, Tuple[str, str]] = {
    "NO_LOAD": (
        "        if (t0 + r >= r_end) continue;\n",
        "        continue;\n"),
    "NO_FMA": (
        "    if (len == kChunk) {\n",
        "    acc[0][0] += rows_s[0];\n    if (false) {\n"),
    "NO_FMA_TAIL": (
        "#pragma unroll 1\n      for (int c = 0; c < len; ++c)\n",
        "#pragma unroll 1\n      for (int c = 0; c < 0; ++c)\n"),
    "NO_FOLD": (
        "    if (chunk != n_chunks - 1) continue;\n",
        "    if (chunk != n_chunks - 1) continue;\n"
        "    {\n      float sum = 0.f;\n"
        "#pragma unroll\n      for (int i = 0; i < M; ++i)\n"
        "#pragma unroll\n"
        "        for (int t = 0; t < N; ++t) sum += acc[i][t];\n"
        "      if (sum == 12345.678f) part_v[0] = sum;\n"
        "      continue;\n    }\n"),
    "REG_ROWS": (
        "  for (int i = 0; i < M; ++i) x[i] = rows[i * 8 * kPitchR];\n",
        "  for (int i = 0; i < M; ++i)\n"
        "    x[i] = __int_as_float(0x3f800000 + threadIdx.x + i);\n"),
    "REG_QUERIES": (
        "    w[h] = *reinterpret_cast<const float4*>(qs + h * 16);\n",
        "    w[h] = make_float4(\n"
        "        __int_as_float(0x3f800000 + threadIdx.x + h),\n"
        "        __int_as_float(0x3f800001 + threadIdx.x + h),\n"
        "        __int_as_float(0x3f800002 + threadIdx.x + h),\n"
        "        __int_as_float(0x3f800003 + threadIdx.x + h));\n"),
}

VARIANTS: Dict[str, Tuple[str, ...]] = {
    "full": (),
    "no_fold": ("NO_FOLD",),
    "fma_only": ("NO_FOLD", "NO_LOAD"),
    "fma_registers": ("NO_FOLD", "NO_LOAD", "REG_ROWS", "REG_QUERIES"),
    "loads_only": ("NO_FOLD", "NO_FMA", "NO_FMA_TAIL"),
}

SHAPES = ((64, 1 << 22, 259), (1, 1 << 22, 259), (64, 32768, 259))


def main() -> int:
    import torch

    from repro_torch.kernels.common import mips_scan_grid, sm_count
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.timing import build_variants, card, time_ms

    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    libs = build_variants("mips_topk", SWITCHES, VARIANTS, ops._SIGNATURES)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 8
    for b, n, d in SHAPES:
        db = torch.nn.functional.normalize(
            torch.randn(n, d, device=dev, generator=gen), dim=1)
        q = torch.nn.functional.normalize(
            torch.randn(b, d, device=dev, generator=gen), dim=1)
        grid = mips_scan_grid(b, n, sm_count(dev))
        n_ranges = grid[-1]
        part_v = torch.empty((b, n_ranges, k), device=dev)
        part_i = torch.empty((b, n_ranges, k), dtype=torch.int32,
                             device=dev)
        vals = torch.empty((b, k), device=dev)
        idx = torch.empty((b, k), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        want = ops.mips_topk(q, db, k)
        row = {"shape": {"b": b, "n": n, "d": d, "k": k},
               "scan_grid": grid, "ms": {}}
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.mips_topk_launch(
                    q.data_ptr(), db.data_ptr(), part_v.data_ptr(),
                    part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), b,
                    n, d, k, *grid, stream)
                if err:
                    raise RuntimeError(f"breakdown {name}: error {err}")
            row["ms"][name] = time_ms(call)
            if name == "full":
                torch.cuda.synchronize()
                row["full_equals_kernel"] = bool(
                    torch.equal(vals, want[0]) and torch.equal(idx, want[1]))
        flop = 2.0 * b * n * d
        row["tflop_per_s"] = {name: flop / ms / 1e9
                              for name, ms in row["ms"].items()
                              if name != "loads_only"}
        row["loads_only_tb_per_s"] = 4.0 * n * d / row["ms"]["loads_only"] \
            / 1e9
        print(json.dumps(row), flush=True)
        del db, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
