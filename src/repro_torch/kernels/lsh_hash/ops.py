"""Public LSH-hash op: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Codes must be CANONICAL: the tail bits beyond ``k`` of the last word
are 0 on every branch (the kernel sets no bit at or above ``k``; the
plain version pads the bits with zeros), so both routes give the same
words as the JAX package's ``lsh_hash``.  Words are int32 tensors
carrying the uint32 bits; ``codes_to_int`` turns them into the integer
bucket keys the graph partitions by.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.common import cdiv, check_launch, load_kernel, \
    lsh_grid, sm_count, stream_ptr
from repro_torch.kernels.lsh_hash import ref
from repro_torch.obs.metrics import global_registry

MAX_K = 512  # hyperplanes the CUDA kernel takes (8 groups of 64)

# CUDA kernel launches (the plain CPU route is not counted)
_LAUNCHES = global_registry().counter("kernels.lsh_hash.launches")


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def launch_count() -> int:
    """CUDA kernel launches since the last reset."""
    return _LAUNCHES.count


# v, h, out; n, d, k; the grid (LshGrid's fields, in order); stream
_SIGNATURES = {
    "lsh_hash_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p], ctypes.c_int),
    "lsh_hash_smem_bytes": ([ctypes.c_int] * 6, ctypes.c_int),
}


def lsh_hash_cuda(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lsh_hash.cu`` on fp32 contiguous CUDA tensors: one
    launch, on the grid ``lsh_grid`` picks for the shape; a launch the
    card refuses raises."""
    n, d = v.shape
    k = h.shape[1]
    if k > MAX_K:
        raise ValueError(f"lsh_hash kernel takes k <= {MAX_K}, got {k}")
    if v.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("lsh_hash kernel takes float32 inputs")
    if not (v.is_contiguous() and h.is_contiguous()):
        raise ValueError("lsh_hash kernel takes contiguous inputs")
    out = torch.empty((n, cdiv(k, 32)), dtype=torch.int32,
                      device=v.device)
    if n == 0:
        return out
    grid = lsh_grid(n, k, sm_count(v.device))
    lib = load_kernel("lsh_hash", _SIGNATURES)
    err = lib.lsh_hash_launch(v.data_ptr(), h.data_ptr(), out.data_ptr(),
                              n, d, k, *grid, stream_ptr(v.device))
    check_launch(lib, "lsh_hash", err)
    _LAUNCHES.inc()
    return out


def lsh_hash(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Packed hyperplane LSH codes: (n, d), (d, k) -> (n, ceil(k/32))
    int32 words (uint32 bits), tail bits beyond ``k`` masked to 0."""
    if v.dim() != 2 or h.dim() != 2 or v.shape[1] != h.shape[0]:
        raise ValueError(f"expected (n, d) @ (d, k), got "
                         f"{tuple(v.shape)} @ {tuple(h.shape)}")
    if v.device != h.device:
        raise ValueError(f"inputs on {v.device} and {h.device}")
    if v.device.type == "cuda":
        return lsh_hash_cuda(v, h)
    if v.device.type == "cpu":
        return ref.lsh_hash_ref(v, h)
    raise ValueError(f"lsh_hash: no route for device {v.device}")


def unpack_bits(codes: torch.Tensor, k: int) -> torch.Tensor:
    return ref.unpack_bits_ref(codes, k)


def codes_to_int(codes: np.ndarray, k: int) -> np.ndarray:
    """(n, n_words) 32-bit words -> (n,) integer keys.

    For k <= 64 returns uint64; beyond that an object array of python
    ints (arbitrary precision) -- ordering semantics identical either
    way (little-endian word significance).  int32 words are read as
    their uint32 bits.
    """
    codes = np.asarray(codes)
    if codes.dtype == np.int32:
        codes = codes.view(np.uint32)
    n, n_words = codes.shape
    if k <= 64 and n_words <= 2:
        lo = codes[:, 0].astype(np.uint64)
        hi = codes[:, 1].astype(np.uint64) << np.uint64(32) \
            if n_words > 1 else np.uint64(0)
        return lo | hi
    out = np.empty(n, dtype=object)
    for i in range(n):
        acc = 0
        for w in range(n_words):
            acc |= int(codes[i, w]) << (32 * w)
        out[i] = acc
    return out
