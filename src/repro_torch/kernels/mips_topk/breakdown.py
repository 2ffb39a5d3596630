"""Where the time of the ``mips_topk`` scan and of ``mips_rescore`` goes,
on the card.

    PYTHONPATH=src python -m repro_torch.kernels.mips_topk.breakdown [scan|rescore]

Builds ``csrc/mips_topk.cu`` and instrumented copies of it, each with one
part of a kernel switched off (both kernels unless one is named).  The
scan's builds are timed at n = 2^22 rows of d = 259 (b = 64 and b = 1)
and at the main path's n = 32768, b = 64, k = 8.  Its variants are:

- ``full``          the kernel as shipped;
- ``no_fold``       no top-k fold (the scores are summed so that the
                    FMAs stay);
- ``fma_only``      no fold and no row staging (the FMAs on whatever the
                    stages hold);
- ``fma_registers`` ``fma_only`` with both operands from registers, not
                    shared memory: the FMA loop's own ceiling;
- ``loads_only``    no fold and no FMAs: the staging pipeline alone.

The rescore's builds (``RESCORE_VARIANTS``) are timed, device-only, at
b = 64, k = 8, d = 259 on C random distinct candidates: n = 32768 with
C = 32 (the main path's shape, candidates among 1157 rows as there) and
n = 2^22 with C = 32 and 4096:

- ``full``          the kernel as shipped;
- ``no_select``     no sort and no top-k offer (the scores stay live);
- ``loads_only``    no FMAs and no selection: the staging pipeline alone;
- ``no_rows``       no row copies (the FMAs and selection on whatever
                    the stages hold);
- ``empty``         none of the three: the launch, the candidate loads
                    and the query copies;
- ``stages_3``, ``stages_6``  the kernel with a ring of 3 or 6 stages
                    instead of 2 (6: blocks of at most 4 warps).

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

# the rescore's switches (mips_rescore_kernel)
SWITCHES.update({
    "NO_ROWS": (
        "                       4 * max(0, min(4, left)));\n",
        "                       0);\n"),
    "NO_RESCORE_FMA": (
        "    const int len = min(kRescoreChunk, d - c * kRescoreChunk);\n",
        "    const int len = 0;\n    acc += x[0];\n"),
    "NO_RESCORE_SELECT": (
        "    if (c == n_chunks - 1) {\n      float v",
        "    if (c == n_chunks - 1 && acc == 12345.678f) {\n      float v"),
    "STAGES_3": (
        "constexpr int kRescoreStages = 2;",
        "constexpr int kRescoreStages = 3;"),
    "STAGES_6": (
        "constexpr int kRescoreStages = 2;",
        "constexpr int kRescoreStages = 6;"),
    "MAX_WARPS_4": (
        "constexpr int kRescoreMaxWarps = 8;",
        "constexpr int kRescoreMaxWarps = 4;"),
})

VARIANTS: Dict[str, Tuple[str, ...]] = {
    "full": (),
    "no_fold": ("NO_FOLD",),
    "fma_only": ("NO_FOLD", "NO_LOAD"),
    "fma_registers": ("NO_FOLD", "NO_LOAD", "REG_ROWS", "REG_QUERIES"),
    "loads_only": ("NO_FOLD", "NO_FMA", "NO_FMA_TAIL"),
}

RESCORE_VARIANTS: Dict[str, Tuple[str, ...]] = {
    "full": (),
    "no_select": ("NO_RESCORE_SELECT",),
    "loads_only": ("NO_RESCORE_SELECT", "NO_RESCORE_FMA"),
    "no_rows": ("NO_ROWS",),
    "empty": ("NO_ROWS", "NO_RESCORE_FMA", "NO_RESCORE_SELECT"),
    "stages_3": ("STAGES_3",),
    "stages_6": ("STAGES_6", "MAX_WARPS_4"),
}

SHAPES = ((64, 1 << 22, 259), (1, 1 << 22, 259), (64, 32768, 259))
# (b, n, C, distinct rows the candidates are drawn from)
RESCORE_SHAPES = ((64, 32768, 32, 1157), (64, 1 << 22, 32, 1 << 22),
                  (64, 1 << 22, 4096, 1 << 22))


def main() -> int:
    import torch

    from repro_torch.kernels.timing import card

    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    which = sys.argv[1:] or ["scan", "rescore"]
    if "scan" in which:
        scan()
    if "rescore" in which:
        rescore()
    return 0


def rescore() -> None:
    import torch

    from repro_torch.kernels.common import rescore_grid, sm_count
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.timing import build_variants, kernel_ms

    # built beside the scan's copies, so named apart from them
    libs = build_variants("mips_topk", SWITCHES,
                          {f"rescore_{name}": switches for name, switches
                           in RESCORE_VARIANTS.items()}, ops._SIGNATURES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, d = 8, 259
    for b, n, c, pool in RESCORE_SHAPES:
        db = torch.nn.functional.normalize(
            torch.randn(n, d, device=dev, generator=gen), dim=1)
        q = torch.nn.functional.normalize(
            torch.randn(b, d, device=dev, generator=gen), dim=1)
        # each query's C distinct rows, spread over the pool's span
        cand = torch.stack([
            torch.randperm(pool, device=dev, generator=gen)[:c]
            for _ in range(b)]) * (n // pool)
        cand = cand.to(torch.int32)
        grid = rescore_grid(b, c, sm_count(dev))
        vals = torch.empty((b, k), device=dev)
        idx = torch.empty((b, k), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        want = ops.mips_rescore(q, db, cand, k)
        rows = int(torch.unique(cand).numel())
        bound_ms = 4.0 * (rows * d + b * d + b * c) / 3.35e12 * 1e3
        row = {"kernel": "mips_rescore",
               "shape": {"b": b, "n": n, "C": c, "d": d, "k": k,
                         "distinct_rows": rows},
               "grid": grid._asdict(), "bound_ms": bound_ms,
               "variant_device_ms": {}}
        for name in RESCORE_VARIANTS:
            def call(lib=libs[f"rescore_{name}"], name=name):
                err = lib.mips_rescore_launch(
                    q.data_ptr(), db.data_ptr(), cand.data_ptr(),
                    vals.data_ptr(), idx.data_ptr(), b, n, d, c, k, *grid,
                    stream)
                if err:
                    raise RuntimeError(f"breakdown {name}: error {err}")
            ms = kernel_ms(call)
            row["variant_device_ms"][name] = ms.get("mips_rescore_kernel")
            if name == "full":
                torch.cuda.synchronize()
                row["full_equals_wrapper"] = bool(
                    torch.equal(vals, want[0]) and torch.equal(idx, want[1]))
        full = row["variant_device_ms"]["full"]
        row["full_bound_share"] = bound_ms / full if full else None
        if grid.cluster > 1:
            # the same clusters with 1 to 4 warps a block (each warp
            # takes more tiles with fewer)
            row["warps_per_block_sweep"] = {}
            for name in ("full", "stages_3"):
                times = {}
                for wq in range(1, 5):
                    def call(lib=libs[f"rescore_{name}"], wq=wq):
                        err = lib.mips_rescore_launch(
                            q.data_ptr(), db.data_ptr(), cand.data_ptr(),
                            vals.data_ptr(), idx.data_ptr(), b, n, d, c, k,
                            1, wq, grid.cands_per_block, grid.cluster,
                            stream)
                        if err:
                            raise RuntimeError(f"breakdown {name}: error "
                                               f"{err}")
                    times[wq] = kernel_ms(call).get("mips_rescore_kernel")
                row["warps_per_block_sweep"][name] = times
        print(json.dumps(row), flush=True)
        del db, q, cand
        torch.cuda.empty_cache()


def scan() -> None:
    import torch

    from repro_torch.kernels.common import mips_scan_grid, sm_count
    from repro_torch.kernels.mips_topk import ops
    from repro_torch.kernels.timing import build_variants, time_ms

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


if __name__ == "__main__":
    sys.exit(main())
