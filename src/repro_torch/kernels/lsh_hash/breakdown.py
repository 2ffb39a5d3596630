"""Where the time of ``lsh_hash`` goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.lsh_hash.breakdown

Builds ``csrc/lsh_hash.cu`` and instrumented copies of it, each with one
part of the kernel switched off, and times every build's launcher,
device-only (``torch.profiler``), at the shapes of the port's paths
(d = 256):

- the main path's build, n = 12510 rows at k = 12;
- a growth round's chunk batch, n = 2501 at k = 12;
- the quantized path's query encoding, b = 64 queries at k = 64;
- the quantized store's code plane, n = 30189 at k = 64;
- the build's rows under two groups of 64 planes, n = 12510 at k = 128;
- the deployment scale, n = 2^22 at k = 12.

The variants are:

- ``full``        the kernel as shipped;
- ``loads_only``  the row staging without the FMAs;
- ``no_rows``     the FMAs on rows that were never staged;
- ``empty``       neither: the launch, the ring's barriers, the
                  hyperplanes' staging and the codes' stores;
- ``prologue``    the launch and the block's set-up alone (barriers,
                  zeroed words), then return.

Only ``full`` computes the right answer (it is checked against the
wrapper); the others are timed, not checked.  The shipped kernel is also
timed on the other grids it takes (``sweep``: every (planes, rows) a
thread may hold, and each ring depth that fits), each checked bitwise
against ``lsh_grid``'s codes.  Each shape's line also holds the
bound (each input read once, the codes written once, over 3.35 TB/s; or
2 n d k operations over 67 TFLOP/s, whichever is larger).
Prints the card's name and power limit, then one JSON object per shape.
The copies are built into ``build/lsh_hash_breakdown/``
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
    "NO_ROWS": (
        "        a.tma_rows ? L.row_boxes * L.box_rows * kChunk * 4 : 0;\n",
        "        0;\n"),
    "NO_ROWS_TMA": (
        "        if (a.tma_rows)\n          for (int b = 0;",
        "        if (false)\n          for (int b = 0;"),
    "NO_ROWS_COPY": (
        "      if (!a.tma_rows) {\n",
        "      if (false) {\n"),
    "NO_FMA": (
        "    const int len4 = active ? len & ~3 : 0;\n",
        "    const int len4 = 0;\n"
        "    if (active) acc[0][0] += x0[0] + hs[0];\n"),
    "NO_FMA_TAIL": (
        "    for (int c = len4; c < (active ? len : 0); ++c) {\n",
        "    for (int c = len; c < len; ++c) {\n"),
    "PROLOGUE": (
        "  if (tid >= consumers) {\n",
        "  if (a.n > 0) return;\n  if (tid >= consumers) {\n"),
}

VARIANTS: Dict[str, Tuple[str, ...]] = {
    "full": (), "loads_only": ("NO_FMA", "NO_FMA_TAIL"),
    "no_rows": ("NO_ROWS", "NO_ROWS_TMA", "NO_ROWS_COPY"),
    "empty": ("NO_ROWS", "NO_ROWS_TMA", "NO_ROWS_COPY", "NO_FMA",
              "NO_FMA_TAIL"),
    "prologue": ("PROLOGUE",),
}

# (label, n, k) at d = 256
SHAPES = (("main_path", 12510, 12), ("growth_round", 2501, 12),
          ("query_encoding", 64, 64), ("code_plane", 30189, 64),
          ("k_128", 12510, 128), ("at_2_22", 1 << 22, 12))
D = 256


def sweep_grids(n: int, k: int, n_sms: int):
    """The grids the sweep times beside ``lsh_grid``'s: every (planes,
    rows) a thread may hold (``LSH_KERNELS``) with the rest laid out by
    ``lsh_layout``, and the chosen grid at each ring depth of
    ``LSH_STAGES`` that fits."""
    from repro_torch.kernels.common import LSH_KERNELS, LSH_STAGES, \
        SMEM_MAX, lsh_grid, lsh_layout, lsh_smem_bytes

    chosen = lsh_grid(n, k, n_sms)
    grids = {}
    for kp, r in LSH_KERNELS:
        if kp == 12 and k > 12:
            continue
        try:
            grids[f"kp{kp}_r{r}"] = lsh_layout(n, k, n_sms, kp, r)
        except ValueError:   # no grid of these fits
            pass
    for stages in LSH_STAGES:
        g = chosen._replace(stages=stages)
        if lsh_smem_bytes(g, k) <= SMEM_MAX:
            grids[f"stages{stages}"] = g
    return chosen, grids


def main() -> int:
    import torch

    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.lsh_hash import ops
    from repro_torch.kernels.timing import build_variants, card, kernel_ms

    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    libs = build_variants("lsh_hash", SWITCHES, VARIANTS, ops._SIGNATURES)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for label, n, k in SHAPES:
        v = torch.nn.functional.normalize(
            torch.randn(n, D, device=dev, generator=gen), dim=1)
        h = torch.randn(D, k, device=dev, generator=gen)
        n_words = -(-k // 32)
        out = torch.empty((n, n_words), dtype=torch.int32, device=dev)
        want = ops.lsh_hash(v, h)
        by_bytes = 4.0 * (n * D + D * k + n * n_words) / 3.35e12 * 1e3
        by_ops = 2.0 * n * D * k / 67e12 * 1e3
        chosen, grids = sweep_grids(n, k, sm_count(dev))
        row = {"shape": {"label": label, "n": n, "d": D, "k": k},
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "grid": chosen._asdict(), "variant_device_ms": {}}

        def launcher(lib, name, grid):
            def call():
                err = lib.lsh_hash_launch(v.data_ptr(), h.data_ptr(),
                                          out.data_ptr(), n, D, k, *grid,
                                          stream)
                if err:
                    raise RuntimeError(f"breakdown {name}: error {err}")
            return call

        for name in VARIANTS:
            ms = kernel_ms(launcher(libs[name], name, chosen))
            row["variant_device_ms"][name] = sum(ms.values()) or None
            if name == "full":
                torch.cuda.synchronize()
                row["full_equals_wrapper"] = bool(torch.equal(out, want))
        full = row["variant_device_ms"]["full"]
        row["full_bound_share"] = row["bound_ms"] / full if full else None
        # the full kernel on the other grids (each checked bitwise: a
        # code never depends on the grid)
        row["sweep_device_ms"], row["sweep_equal"] = {}, True
        for name, grid in grids.items():
            out.zero_()
            call = launcher(libs["full"], name, grid)
            row["sweep_device_ms"][name] = sum(kernel_ms(call).values())
            torch.cuda.synchronize()
            row["sweep_equal"] &= bool(torch.equal(out, want))
        print(json.dumps(row), flush=True)
        del v, h, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
