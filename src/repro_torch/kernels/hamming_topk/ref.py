"""Plain PyTorch version of the packed-code Hamming top-k.

Serves CPU tensors and the on-card comparisons; the CUDA kernel
(``csrc/hamming_topk.cu``) computes the same function.  Words are int32
tensors carrying the bits of the JAX package's uint32 words (a word
with bit 31 set is negative here).  torch has no popcount, so each word
is counted with the SWAR bit trick on int64.  Ties go to the lowest row
index, as ``jax.lax.top_k`` does: the selection is a STABLE ascending
sort on distance, not ``torch.topk``.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding 32 bits),
    as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_dist_ref(qc: torch.Tensor, dbc: torch.Tensor) -> torch.Tensor:
    """qc: (b, w); dbc: (n, w) 32-bit words -> (b, n) int32 distances.

    Summed one word at a time, so the largest temporary is (b, n)."""
    b, w = qc.shape
    n = dbc.shape[0]
    dist = torch.zeros((b, n), dtype=torch.int32, device=qc.device)
    for j in range(w):
        dist += popcount32(qc[:, j, None] ^ dbc[None, :, j])
    return dist


def hamming_topk_ref(qc: torch.Tensor, dbc: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest distances per query: (dist (b, k) int32,
    idx (b, k) int32), by (distance ascending, row ascending)."""
    dist = hamming_dist_ref(qc, dbc)
    vals, idx = torch.sort(dist, dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
