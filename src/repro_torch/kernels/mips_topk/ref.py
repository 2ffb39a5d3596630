"""Plain PyTorch version of maximum-inner-product top-k search.

Serves CPU tensors and the on-card comparisons; the CUDA kernel
(``csrc/mips_topk.cu``) computes the same function.  Ties go to the
lowest row index, as ``jax.lax.top_k`` does.  ``torch.topk`` does not
promise that, so the selection is a STABLE descending sort: equal
scores keep their row order.

``mips_rescore_ref`` is the plain version of the gathered-rows rescore
(the exact stage of the two-stage quantized scan): the union of every
query's candidate rows is gathered in ascending row order into one
sub-matrix, scored with one ``q @ sub.T``, and each query keeps only
its own candidates.  At full coverage the sub-matrix is the whole
buffer, so the scores are bitwise ``mips_topk_ref``'s.
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


def mips_rescore_ref(q: torch.Tensor, db: torch.Tensor, cand: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (b, d); db: (n, d); cand: (b, c) distinct row indices per
    query -> the k best of each query's own candidates (vals (b, k)
    f32, DB row idx (b, k) i32) by (score desc, row asc)."""
    rows = torch.unique(cand.to(torch.int64))              # ascending
    scores = q.to(torch.float32) @ db[rows].to(torch.float32).T
    own = torch.zeros(scores.shape, dtype=torch.bool, device=q.device)
    own.scatter_(1, torch.searchsorted(rows, cand.to(torch.int64)), True)
    # below every real or MASK_BIAS-masked score: a column the query
    # does not own never reaches its top k (it owns c >= k columns)
    scores = torch.where(own, scores, torch.finfo(torch.float32).min)
    vals, col = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), rows[col[:, :k]].to(torch.int32)
