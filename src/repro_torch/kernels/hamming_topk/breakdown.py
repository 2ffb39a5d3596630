"""Where ``hamming_topk``'s list-route time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.hamming_topk.breakdown

Builds ``csrc/hamming_topk.cu`` and instrumented copies of it, each with
one part of the list route's scan switched off, and times every build's
``hamming_list_launch`` on random codes at n = 2^22 rows of w = 11
words (b = 64 and b = 1, C = 32) and at the main path's n = 32768,
b = 64, C = 32 and C = 128.  The variants are:

- ``full``        the kernels as shipped;
- ``no_select``   no warp-select in the scan (every key is compared with
                  a constant, so the popcounts stay);
- ``popc_only``   ``no_select`` and no row staging (the popcounts on
                  whatever the stages hold);
- ``loads_only``  no popcounts and no select in the scan: the staging
                  and the step loop around them.

Each row holds every build's launcher time (CUDA events, buffers
allocated beforehand) and each kernel's device time (``torch.profiler``);
for the shipped build, the host time of one wrapper call and of one
launcher call (no synchronize) and the scan's popcounts per second; at
2^22, b = 64, the SM clock and power under a second of back-to-back
calls; and the counting route (``hamming_topk_launch``, the kernels that
served every C before the list route) at the same shape.  Only ``full``
and the counting route compute the right answer (both are checked
against the wrapper); the others are timed, not checked.  Prints the
card's name and power limit, then one JSON object per shape.  The copies
are built into ``build/hamming_topk_breakdown/`` (``kernels/timing.py``
builds and times them).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, Tuple

# Each switch: (the source text it replaces, the replacement).  A switch
# whose text is missing from the source raises: the copy must be the
# shipped kernel with exactly these parts cut.
SWITCHES: Dict[str, Tuple[str, str]] = {
    "NO_SELECT": (
        "static_cast<unsigned>(key[qi] < sel[qi].thr) << qi;\n",
        "static_cast<unsigned>(key[qi] == K(12345)) << qi;\n"),
    "NO_LOAD": (
        "    if (t < n_tiles) {\n      const int rows",
        "    if (false) {\n      const int rows"),
    "NO_POPC": (
        "    row_dists<W>(stage + r * w, wqs, wq, w, nq, qw, dist);\n",
        "#pragma unroll\n"
        "    for (int qi = 0; qi < kQ; ++qi)\n"
        "      dist[qi] = static_cast<int>(stage[r * w + qi % w]);\n"),
}

VARIANTS: Dict[str, Tuple[str, ...]] = {
    "full": (),
    "no_select": ("NO_SELECT",),
    "popc_only": ("NO_SELECT", "NO_LOAD"),
    "loads_only": ("NO_SELECT", "NO_POPC"),
}

SHAPES = ((64, 1 << 22, 11, 32), (1, 1 << 22, 11, 32),
          (64, 32768, 11, 32), (64, 32768, 11, 128))


def main() -> int:
    import torch

    from repro_torch.kernels.common import scan_ranges, sm_count
    from repro_torch.kernels.hamming_topk import ops
    from repro_torch.kernels.timing import build_variants, card, \
        kernel_ms, time_ms

    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    libs = build_variants("hamming_topk", SWITCHES, VARIANTS,
                          ops._SIGNATURES)

    def host_us(fn, reps=20):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, n, w, c in SHAPES:
        dbc = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                            device=dev, generator=gen)
        qc = torch.randint(-2**31, 2**31 - 1, (b, w), dtype=torch.int32,
                           device=dev, generator=gen)
        grid = ops.hamming_route(b, n, w, c, sm_count(dev))
        part = torch.empty((b, grid.n_ranges, c), dtype=torch.int32
                           if grid.key_bits == 32 else torch.int64,
                           device=dev)
        dist = torch.empty((b, c), dtype=torch.int32, device=dev)
        idx = torch.empty((b, c), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        want = ops.hamming_topk(qc, dbc, c)
        row = {"shape": {"b": b, "n": n, "w": w, "C": c},
               "grid": grid._asdict(), "launcher_ms": {},
               "variant_device_ms": {}}
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                err = lib.hamming_list_launch(
                    qc.data_ptr(), dbc.data_ptr(), part.data_ptr(),
                    dist.data_ptr(), idx.data_ptr(), b, n, w, c,
                    grid.query_tile, grid.tile_rows, grid.rows_per_range,
                    grid.n_ranges, grid.key_bits, stream)
                if err:
                    raise RuntimeError(f"breakdown {name}: error {err}")
            row["launcher_ms"][name] = time_ms(call)
            if name == "full":
                torch.cuda.synchronize()
                row["full_equals_wrapper"] = bool(
                    torch.equal(dist, want[0]) and torch.equal(idx, want[1]))
                full = call
            row["variant_device_ms"][name] = kernel_ms(call)
        if n == 1 << 22 and b == 64:
            # one nvidia-smi reading a third of the way into a second of
            # back-to-back calls
            t_end = time.perf_counter() + 1.0
            smi = None
            while time.perf_counter() < t_end:
                for _ in range(20):
                    full()
                if smi is None and time.perf_counter() > t_end - 0.7:
                    smi = subprocess.Popen(
                        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                         "--format=csv,noheader"], stdout=subprocess.PIPE,
                        text=True)
                torch.cuda.synchronize()
            row["sm_clock_power_under_load"] = smi.communicate()[0].strip()
        row["wrapper_host_us"] = host_us(
            lambda: ops.hamming_topk(qc, dbc, c))
        row["launcher_host_us"] = host_us(full)
        scan = row["variant_device_ms"]["full"].get(
            "hamming_list_scan_kernel")
        row["scan_popc_per_s"] = b * n * w / scan * 1e3 if scan else None

        # the counting route at the same C: the kernels that served it
        # before the list route (unchanged since they were ported)
        rows, ranges = scan_ranges(b, n, sm_count(dev))
        hist = torch.empty((b, ranges, 32 * w + 1), dtype=torch.int32,
                           device=dev)
        thresh = torch.empty((b,), dtype=torch.int32, device=dev)

        def count_call():
            err = libs["full"].hamming_topk_launch(
                qc.data_ptr(), dbc.data_ptr(), hist.data_ptr(),
                thresh.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, w,
                c, rows, ranges, stream)
            if err:
                raise RuntimeError(f"breakdown count route: error {err}")
        row["count_route_ms"] = time_ms(count_call)
        torch.cuda.synchronize()
        row["count_route_equal"] = bool(
            torch.equal(dist, want[0]) and torch.equal(idx, want[1]))
        print(json.dumps(row), flush=True)
        del dbc, qc, part, hist
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
