"""Shared kernel utilities: ``cdiv``, the scan grids (``scan_ranges``,
``mips_scan_grid``), the card's SM count (``sm_count``), the device
resolver, and the builder/loader for the hand-written CUDA kernels under
``csrc/``; and the rescore's grid (``rescore_grid``).

Build route: each ``csrc/<name>.cu`` is compiled on first use by one
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ``ctypes``.  Libraries land in ``<repo>/build/`` under
a name that carries a digest of the source and flags, so an edited
source never loads a stale library.  ``build_kernels`` starts one
``nvcc`` per source, all together, and waits for all of them.

Dispatch rule (every wrapper in ``kernels/*/ops.py``): a CUDA tensor
goes to the kernel, or the wrapper raises; the plain PyTorch version
runs only for a tensor that lies on the CPU.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

# The counting route's scan grid (hamming_topk)
SCAN_ROWS = 128         # rows per block tile (kThreads in hamming_topk.cu)
SCAN_BQ = 16            # queries per block (kBQ in hamming_topk.cu)
_BLOCKS_PER_SM = 4      # scan blocks aimed at per SM when choosing ranges

# The mips_topk scan's variants (csrc/mips_topk.cu), one block per SM:
# queries per block, and rows per tile (the first where those tiles fill
# the card, else the second)
MIPS_QUERY_TILES = (16, 64)
MIPS_TILE_ROWS = (512, 256)

# The rescore (mips_rescore_kernel in csrc/mips_topk.cu): candidates per
# warp tile, warps per block, blocks per cluster (the portable maximum),
# and the warps of a block that holds a cluster's share of one query
RESCORE_TILE = 32
RESCORE_MAX_WARPS = 8
RESCORE_MAX_CLUSTER = 8
RESCORE_CLUSTER_WARPS = 2

_SM_COUNTS: Dict[int, int] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_ranges(b: int, n: int, n_sms: int, *,
                queries_per_block: int = SCAN_BQ) -> Tuple[int, int]:
    """(rows_per_range, n_ranges) of the scan grid: enough n-ranges
    that the query tiles times the ranges give every SM a few blocks,
    each range a whole number of 128-row tiles."""
    tiles = cdiv(n, SCAN_ROWS)
    want = max(1, cdiv(_BLOCKS_PER_SM * n_sms,
                       cdiv(b, queries_per_block)))
    rows_per_range = cdiv(tiles, min(tiles, want)) * SCAN_ROWS
    return rows_per_range, cdiv(n, rows_per_range)


def mips_scan_grid(b: int, n: int,
                   n_sms: int) -> Tuple[int, int, int, int]:
    """(query_tile, tile_rows, rows_per_range, n_ranges) of the
    ``mips_topk`` scan: the narrowest query tile that holds b (larger b
    is cut into tiles of 64); the variant's large row tile unless its
    tiles would leave SMs idle; and about one block per SM over the
    query tiles, each block a contiguous range of whole tiles that it
    walks in order."""
    tile = next((t for t in MIPS_QUERY_TILES if b <= t),
                MIPS_QUERY_TILES[-1])
    q_tiles = cdiv(b, tile)
    large, small = MIPS_TILE_ROWS
    tile_rows = large if cdiv(n, large) * q_tiles >= n_sms else small
    tiles = cdiv(n, tile_rows)
    want = max(1, n_sms // q_tiles)
    rows_per_range = cdiv(tiles, min(tiles, want)) * tile_rows
    return tile, tile_rows, rows_per_range, cdiv(n, rows_per_range)


class RescoreGrid(NamedTuple):
    """The launch grid of ``mips_rescore``: each block holds
    ``queries_per_block`` queries of ``warps_per_query`` warps each, and
    ``cands_per_block`` candidates of each; a query spans ``cluster``
    blocks (1: one block, no cluster)."""
    queries_per_block: int
    warps_per_query: int
    cands_per_block: int
    cluster: int


def rescore_grid(b: int, c: int, n_sms: int) -> RescoreGrid:
    """The rescore's grid for b queries of c candidates each.  Up to
    ``RESCORE_MAX_WARPS`` tiles of 32, a query's candidates sit in one
    block, one warp a tile, and a block takes several queries only where
    the queries alone outnumber the SMs.  Above that a query gets a
    cluster of up to ``RESCORE_MAX_CLUSTER`` blocks of
    ``RESCORE_CLUSTER_WARPS`` warps, each block a contiguous share of
    whole tiles."""
    tiles = cdiv(c, RESCORE_TILE)
    if tiles <= RESCORE_MAX_WARPS:
        per_block = max(1, min(RESCORE_MAX_WARPS // tiles, b // n_sms))
        return RescoreGrid(per_block, tiles, c, 1)
    cluster = min(RESCORE_MAX_CLUSTER, cdiv(tiles, RESCORE_CLUSTER_WARPS))
    block_tiles = cdiv(tiles, cluster)
    return RescoreGrid(1, min(RESCORE_CLUSTER_WARPS, block_tiles),
                       block_tiles * RESCORE_TILE,
                       cdiv(tiles, block_tiles))


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device (the property query
    costs host time on every small call)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SM_COUNTS.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = n
    return n


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another one.  With no CUDA and no explicit request this
    raises — the package never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                          digest_size=6).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_kernels(names: Iterable[str],
                  force: bool = False) -> Dict[str, float]:
    """Compile every named source that has no current library (every
    one with ``force``), one ``nvcc`` per source started together;
    returns the seconds each build took (0.0 when the library was
    already current).  The compiler's ``-Xptxas -v`` report is kept
    beside each library as ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took: Dict[str, float] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and not force:
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load_kernel(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with ``signatures`` (``{function: (argtypes, restype)}``) applied
    once.  Every source also exports ``<name>_error_string``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA
    error (a refused launch never runs, and a later synchronize would
    not report it)."""
    if err != 0:
        what = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
