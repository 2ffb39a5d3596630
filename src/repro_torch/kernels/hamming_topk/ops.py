"""Public Hamming top-k op: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

The coarse stage of the store's two-stage quantized scan
(``kernels/quantized_scan``): queries and rows hash to packed LSH
sign-bit codes, this op selects the C nearest codes per query, and only
those C rows are rescored in fp32.  Equal distances resolve to the
lowest row index on both routes, so the candidate lists are identical
and deterministic.  Words are int32 tensors with the uint32 bits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.common import check_launch, load_kernel, \
    scan_ranges, sm_count, stream_ptr
from repro_torch.kernels.hamming_topk import ref
from repro_torch.obs.metrics import global_registry

MAX_W = 80          # words per code the CUDA kernel takes

_LAUNCHES = global_registry().counter("kernels.hamming_topk.launches")

_SIGNATURES = {
    "hamming_topk_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p], ctypes.c_int),
}


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def launch_count() -> int:
    """CUDA kernel launches since the last reset."""
    return _LAUNCHES.count


def hamming_topk_cuda(qc: torch.Tensor, dbc: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/hamming_topk.cu`` on int32 contiguous CUDA
    tensors."""
    b, w = qc.shape
    n = dbc.shape[0]
    if w > MAX_W:
        raise ValueError(f"hamming_topk kernel takes w <= {MAX_W} words, "
                         f"got {w}")
    if qc.dtype != torch.int32 or dbc.dtype != torch.int32:
        raise TypeError("hamming_topk kernel takes int32 words")
    if not (qc.is_contiguous() and dbc.is_contiguous()):
        raise ValueError("hamming_topk kernel takes contiguous inputs")
    dev = qc.device
    dist = torch.empty((b, k), dtype=torch.int32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return dist, idx
    rows_per_range, n_ranges = scan_ranges(b, n, sm_count(dev))
    # per-(query, range) distance histograms, turned into output
    # offsets in place; the threshold distance per query
    hist = torch.empty((b, n_ranges, 32 * w + 1), dtype=torch.int32,
                       device=dev)
    thresh = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = load_kernel("hamming_topk", _SIGNATURES)
    err = lib.hamming_topk_launch(
        qc.data_ptr(), dbc.data_ptr(), hist.data_ptr(), thresh.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), b, n, w, k, rows_per_range,
        n_ranges, stream_ptr(dev))
    check_launch(lib, "hamming_topk", err)
    _LAUNCHES.inc()
    return dist, idx


def hamming_topk(qc: torch.Tensor, dbc: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest Hamming distances between packed codes:
    (b, w), (n, w) -> (dist (b, k) int32, idx (b, k) int32), ordered by
    (distance ascending, row ascending).  Any 1 <= k <= n."""
    if qc.dim() != 2 or dbc.dim() != 2 or qc.shape[1] != dbc.shape[1]:
        raise ValueError(f"expected (b, w) and (n, w), got "
                         f"{tuple(qc.shape)} and {tuple(dbc.shape)}")
    if not 1 <= k <= dbc.shape[0]:
        raise ValueError(f"need 1 <= k <= n, got k={k}, "
                         f"n={dbc.shape[0]}")
    if qc.device != dbc.device:
        raise ValueError(f"inputs on {qc.device} and {dbc.device}")
    if qc.device.type == "cuda":
        return hamming_topk_cuda(qc, dbc, k)
    if qc.device.type == "cpu":
        return ref.hamming_topk_ref(qc, dbc, k)
    raise ValueError(f"hamming_topk: no route for device {qc.device}")
