"""Plain PyTorch version of hyperplane LSH hashing with bit-packing.

Serves CPU tensors and the on-card comparisons; the CUDA kernel
(``csrc/lsh_hash.cu``) computes the same function.  Words are held as
int32 with the bits of the JAX package's uint32 words (torch's uint32
supports few ops); ``.numpy().view(np.uint32)`` recovers them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import cdiv


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def lsh_hash_ref(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sign(v @ h) packed little-endian into 32-bit words.

    v: (n, d) float; h: (d, k) float -> (n, ceil(k/32)) int32.
    Bit j of word w is 1 iff v . h[:, 32*w + j] >= 0; the tail bits at
    positions >= k are 0 (the padding below masks them).
    """
    n, d = v.shape
    d2, k = h.shape
    if d != d2:
        raise ValueError(f"shape mismatch {tuple(v.shape)} @ "
                         f"{tuple(h.shape)}")
    proj = v.to(torch.float32) @ h.to(torch.float32)            # (n, k)
    bits = (proj >= 0).to(torch.int64)
    n_words = cdiv(k, 32)
    pad = n_words * 32 - k
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(n, n_words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=v.device)
    return _as_int32_words((bits << shifts).sum(dim=-1))


def unpack_bits_ref(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n, n_words) int32 words -> (n, k) {0,1} int32 (little-endian)."""
    n, n_words = codes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(n, n_words * 32)[:, :k].to(torch.int32)
