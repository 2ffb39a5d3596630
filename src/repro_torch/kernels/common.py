"""Shared kernel utilities: ``cdiv``, the scan grids (``scan_ranges``,
``mips_scan_grid``), the card's SM count (``sm_count``), the device
resolver, and the builder/loader for the hand-written CUDA kernels under
``csrc/``; the rescore's grid (``rescore_grid``) and ``lsh_hash``'s
(``lsh_grid``).

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

# lsh_hash (csrc/lsh_hash.cu): the (planes, rows) a thread may hold
# (the kernel's instantiations), a block's shared memory, the features of
# a stage, the rows and planes of a TMA box, the alignment of the
# swizzle, the row lanes of a tile that a block walks, the ring depths
# tried deepest first, and the thread counts lsh_grid aims at
LSH_KERNELS = ((8, 1), (8, 2), (8, 4), (8, 8), (12, 1), (12, 2), (12, 4))
SMEM_MAX = 232448
LSH_CHUNK = 32
LSH_BOX = 256
LSH_ALIGN = 1024
LSH_TILE_LANES = 128
LSH_STAGES = (4, 3, 2)
LSH_THREADS_PER_SM = 192

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


class LshGrid(NamedTuple):
    """The launch grid of ``lsh_hash``: a thread holds
    ``rows_per_thread`` rows x ``planes_per_thread`` planes of fp32
    accumulators; ``plane_groups`` threads share a row (one group of
    planes each), ``row_lanes`` threads a group, and a producer warp
    stages the rows; a tile is ``rows_per_thread * row_lanes`` rows,
    staged 32 features at a time, with the same features of every plane,
    through a ring of ``stages`` buffers; block b takes rows
    ``[b * rows_per_block, (b + 1) * rows_per_block)`` tile by tile."""
    planes_per_thread: int
    rows_per_thread: int
    plane_groups: int
    row_lanes: int
    stages: int
    rows_per_block: int


def lsh_max_threads(kp: int, r: int) -> int:
    """A block's threads, its producer warp included, for ``r`` rows x
    ``kp`` planes a thread, so that the accumulators stay in registers
    (``max_threads`` in ``csrc/lsh_hash.cu``)."""
    return 1024 if r * kp <= 8 else 512 if r * kp <= 32 else \
        320 if r * kp <= 64 else 256


def lsh_smem_bytes(grid: LshGrid, k: int) -> int:
    """A block's dynamic shared memory under ``grid`` (``Layout`` in
    ``csrc/lsh_hash.cu``), each part aligned to 1024 bytes: the
    mbarriers; the ring of buffers, each a tile's rows x 32 features in
    boxes of up to 256 rows and the chunk's planes in boxes of up to 256;
    the code words of a tile where several threads share a row's words;
    and the slack that aligns the base."""
    def up(x):
        return cdiv(x, LSH_ALIGN) * LSH_ALIGN
    tile = grid.rows_per_thread * grid.row_lanes
    box_rows = min(tile, LSH_BOX)
    kpad = grid.plane_groups * grid.planes_per_thread
    hbox = min(kpad, LSH_BOX)
    plane_boxes = cdiv(kpad, hbox)
    stage = up(cdiv(tile, box_rows) * box_rows * LSH_CHUNK * 4) + \
        up(plane_boxes * LSH_CHUNK * hbox * 4)
    words = tile * cdiv(k, 32) * 4 if grid.plane_groups > 1 else 0
    return LSH_ALIGN + grid.stages * stage + words + LSH_ALIGN


def lsh_layout(n: int, k: int, n_sms: int, kp: int, r: int) -> LshGrid:
    """The rest of ``lsh_hash``'s grid once a thread's planes ``kp`` and
    rows ``r`` are chosen.  A block holds one tile of an SM's share of
    rows, with row lanes enough for it, up to twice ``LSH_TILE_LANES``
    (and the block's thread limit, ``lsh_max_threads``) and 256 rows; a
    larger share is walked in tiles of ``LSH_TILE_LANES`` lanes (whole
    TMA boxes of 256 rows).  The deepest ring of ``LSH_STAGES`` that fits
    the shared memory, in the largest such tile."""
    g = cdiv(k, kp)
    rows_sm = cdiv(n, n_sms)
    lanes = cdiv(rows_sm, r)
    most = (lsh_max_threads(kp, r) - 32) // g   # a producer warp besides
    if most < 1:
        raise ValueError(f"lsh_hash: {g} plane groups of {kp} exceed a "
                         f"block")
    if lanes > min(2 * LSH_TILE_LANES, most) or r * lanes > LSH_BOX:
        lanes = min(LSH_TILE_LANES, most)
        if r * lanes > LSH_BOX:   # tiles of whole boxes
            lanes = r * lanes // LSH_BOX * LSH_BOX // r
    while True:
        tile = r * lanes
        for stages in LSH_STAGES:
            grid = LshGrid(kp, r, g, lanes, stages, max(tile, rows_sm))
            if lsh_smem_bytes(grid, k) <= SMEM_MAX:
                return grid
        if lanes == 1:
            raise ValueError(f"lsh_hash: no grid fits n={n}, k={k}")
        # a smaller tile: one box of rows fewer, then half the rows
        lanes = max(1, (tile - LSH_BOX if tile > LSH_BOX else tile // 2)
                    // r)


def lsh_grid(n: int, k: int, n_sms: int) -> LshGrid:
    """``lsh_hash``'s grid for n rows under k planes (of any d: the
    features stream 32 at a time, so d does not enter the grid).  A
    thread takes 12 planes where k <= 12 (one thread a row's planes),
    else 8 (``cdiv(k, 8)`` threads a row), and as many rows as the
    kernel is built for with them (``LSH_KERNELS``) that keep
    ``LSH_THREADS_PER_SM`` threads on each SM."""
    rows_sm = cdiv(n, n_sms)
    kp = 12 if k <= 12 else 8
    g = cdiv(k, kp)
    r = next((r for p, r in LSH_KERNELS[::-1] if p == kp and
              rows_sm * g >= LSH_THREADS_PER_SM * r), 1)
    return lsh_layout(n, k, n_sms, kp, r)


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
