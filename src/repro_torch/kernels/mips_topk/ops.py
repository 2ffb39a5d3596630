"""Public MIPS top-k ops: the local scan and the flag-masked scan.

``mips_topk`` sends a CUDA tensor to the kernel (``csrc/mips_topk.cu``)
or raises, and a CPU tensor to the plain version.  Both order by
(score descending, row index ascending).  ``flagged_mips_topk`` folds
the store's per-flag biases into the queries (``augment_queries``), so
the kernel stays a plain MIPS top-k.

The launch counter lives on the process-global obs registry
(``kernels.mips_topk.launches``) and counts CUDA kernel launches only;
per-store attribution of scans is ``StoreStats.kernel_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.common import cdiv, check_launch, load_kernel, \
    stream_ptr
from repro_torch.kernels.mips_topk import ref
from repro_torch.obs.metrics import global_registry

MAX_K = 64          # k the CUDA kernel takes
_ROWS = 128         # rows per block tile (kThreads in the source)
_BQ = 16            # queries per block (kBQ in the source)
_BLOCKS_PER_SM = 4  # scan blocks aimed at per SM when choosing ranges

_LAUNCHES = global_registry().counter("kernels.mips_topk.launches")

_SIGNATURES = {
    "mips_topk_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p], ctypes.c_int),
}


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def launch_count() -> int:
    """CUDA kernel launches since the last reset."""
    return _LAUNCHES.count


def scan_ranges(b: int, n: int, n_sms: int) -> Tuple[int, int]:
    """(rows_per_range, n_ranges) of the scan grid: enough n-ranges
    that the query tiles times the ranges give every SM a few blocks,
    each range a whole number of 128-row tiles."""
    tiles = cdiv(n, _ROWS)
    want = max(1, cdiv(_BLOCKS_PER_SM * n_sms, cdiv(b, _BQ)))
    rows_per_range = cdiv(tiles, min(tiles, want)) * _ROWS
    return rows_per_range, cdiv(n, rows_per_range)


def mips_topk_cuda(q: torch.Tensor, db: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/mips_topk.cu`` on fp32 contiguous CUDA tensors."""
    b, d = q.shape
    n = db.shape[0]
    if k > MAX_K:
        raise ValueError(f"mips_topk kernel takes k <= {MAX_K}, got {k}")
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise TypeError("mips_topk kernel takes float32 inputs")
    if not (q.is_contiguous() and db.is_contiguous()):
        raise ValueError("mips_topk kernel takes contiguous inputs")
    dev = q.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_range, n_ranges = scan_ranges(b, n, n_sms)
    part_v = torch.empty((b, n_ranges, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((b, n_ranges, k), dtype=torch.int32, device=dev)
    lib = load_kernel("mips_topk", _SIGNATURES)
    err = lib.mips_topk_launch(
        q.data_ptr(), db.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), b, n, d, k, rows_per_range,
        n_ranges, stream_ptr(dev))
    check_launch(lib, "mips_topk", err)
    _LAUNCHES.inc()
    return vals, idx


def mips_topk(q: torch.Tensor, db: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query row against the DB rows:
    (vals (b, k) f32, idx (b, k) int32), ties to the lowest index."""
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"expected (b, d) and (n, d), got "
                         f"{tuple(q.shape)} and {tuple(db.shape)}")
    if not 1 <= k <= db.shape[0]:
        raise ValueError(f"need 1 <= k <= n, got k={k}, "
                         f"n={db.shape[0]}")
    if q.device != db.device:
        raise ValueError(f"inputs on {q.device} and {db.device}")
    if q.device.type == "cuda":
        return mips_topk_cuda(q, db, k)
    if q.device.type == "cpu":
        return ref.mips_topk_ref(q, db, k)
    raise ValueError(f"mips_topk: no route for device {q.device}")


# Additive score bias that pushes a row below every real candidate
# (unit-norm embeddings score in [-1, 1]) while staying far above the
# kernel's empty-slot sentinel (-inf), so masked rows rank after real
# rows.
MASK_BIAS = -3.0e30


@functools.lru_cache(maxsize=64)
def _bias_row(flag_bias: Tuple[float, ...],
              device: torch.device) -> torch.Tensor:
    """The (1, F) bias row on ``device``, copied to the card once per
    (flag_bias, device) rather than once per query batch."""
    return torch.tensor([flag_bias], dtype=torch.float32, device=device)


def augment_queries(q: torch.Tensor,
                    flag_bias: Tuple[float, ...]) -> torch.Tensor:
    """Concatenate the per-flag bias columns onto a ``(B, d)`` block."""
    bias = _bias_row(tuple(float(b) for b in flag_bias), q.device)
    return torch.cat([q.to(torch.float32),
                      bias.expand(q.shape[0], len(flag_bias))], dim=1)


def flagged_mips_topk(q: torch.Tensor, db_flagged: torch.Tensor, k: int,
                      flag_bias: Tuple[float, ...]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a flag-augmented DB without touching the kernel.

    ``db_flagged`` is ``[embeddings | F indicator columns]`` (each 0/1);
    ``flag_bias`` gives one additive score bias per indicator column
    (``MASK_BIAS`` to exclude rows with that flag, 0 to ignore it).
    The bias is folded into the inner product by appending the bias
    values to every query row, so the plain MIPS top-k applies the mask
    for free — tombstoned rows and layer filters stay on the device.
    """
    d = db_flagged.shape[1] - len(flag_bias)
    if d != q.shape[1]:
        raise ValueError(f"queries {tuple(q.shape)} vs flagged DB "
                         f"{tuple(db_flagged.shape)} with "
                         f"{len(flag_bias)} flags")
    return mips_topk(augment_queries(q, flag_bias).contiguous(),
                     db_flagged, k)
