"""Plain PyTorch version of maximum-inner-product top-k search.

Serves CPU tensors and the on-card comparisons; the CUDA kernel
(``csrc/mips_topk.cu``) computes the same function.  Ties go to the
lowest row index, as ``jax.lax.top_k`` does.  ``torch.topk`` does not
promise that, so the selection is a STABLE descending sort: equal
scores keep their row order.
"""
from __future__ import annotations

from typing import Tuple

import torch


def mips_topk_ref(q: torch.Tensor, db: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (b, d); db: (n, d) -> (vals (b, k) f32, idx (b, k) i32).

    Materializes the full (b, n) score matrix -- the thing the kernel
    avoids.
    """
    scores = q.to(torch.float32) @ db.to(torch.float32).T
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
