"""Two-stage quantized retrieval: LSH sign-bit coarse scan -> exact fp32
rescore.

The exact flat scan streams every ``(cap, d + F)`` fp32 row per query.
The two-stage pipeline scans a compressed plane instead: each row is
hashed ONCE at append time to a packed sign-bit code (``lsh_hash`` over
persisted hyperplanes), the coarse stage ranks codes by Hamming
distance (``hamming_topk``; 44 bytes a row at the defaults against
1036), and only the top-C candidate rows are rescored in fp32
(``mips_rescore``).  The final scores are REAL inner products of real
rows, and candidates merge with the exact scan's (score desc, row asc)
order.

Flag masking rides inside the codes, laid out as in the JAX package:
after the ``code_words`` real code words come ``n_flags`` penalty word
groups of ``flag_words = ceil((n_bits + 1) / 32)`` words each.
- A DB row's group is all ones when its flag is set, all zeros
  otherwise (``encode_rows``); a tombstone flips the dead group in
  place, with no rehash.
- A query that penalizes a flag (bias != 0) carries all zeros there:
  distance 0 to unflagged rows and ``32 * flag_words > n_bits`` to
  flagged ones, so flagged rows rank after every unflagged row.
- A query that ignores a flag carries ``0x55555555``: 16 per word
  against both groups, a constant that reorders nothing.

Words are int32 tensors carrying the uint32 bits (``FLAG_SET`` is -1).

Invariant.  On the card every rescored (query, row) score is bitwise the
score the exact ``mips_topk`` kernel computes for that row (one ``fmaf``
chain in the kernel's order), so with ``n_coarse`` equal to the row
count the result is bitwise the exact scan's.  On the CPU the plain
rescore gathers the union of the candidates into one ``q @ sub.T``;
at full coverage that is the whole buffer, bitwise
``flagged_mips_topk``'s plain version.  A query rescores only its own
candidates, so its result never depends on the rest of the batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.hamming_topk.ops import hamming_topk
from repro_torch.kernels.lsh_hash.ops import lsh_hash
from repro_torch.kernels.mips_topk.ops import augment_queries, \
    count_collective, gather_merge_topk, mips_rescore

# db-side flag word: group all ones = flagged (0xFFFFFFFF as int32)
FLAG_SET = -1
# query-side "ignore this flag" word: popcount 16 against both groups
_FLAG_IGNORE = 0x55555555


@dataclass(frozen=True)
class QuantSpec:
    """Static layout of a compressed code plane (hashable, as in the JAX
    package, where it keys jitted helpers)."""

    dim: int       # fp32 embedding width d (codes hash rows[:, :dim])
    n_bits: int    # hyperplane count = real code bits
    n_flags: int   # trailing indicator columns mirrored as penalty groups
    seed: int      # hyperplane PRNG seed (persisted with the store)

    @property
    def code_words(self) -> int:
        return cdiv(self.n_bits, 32)

    @property
    def flag_words(self) -> int:
        # 32 * flag_words must EXCEED n_bits so a penalized flag
        # outranks any real code distance
        return cdiv(self.n_bits + 1, 32)

    @property
    def n_words(self) -> int:
        return self.code_words + self.n_flags * self.flag_words

    def flag_group(self, flag: int) -> Tuple[int, int]:
        """Column span ``[lo, hi)`` of one flag's penalty group."""
        lo = self.code_words + flag * self.flag_words
        return lo, lo + self.flag_words


def hyperplanes(spec: QuantSpec) -> np.ndarray:
    """The scan hyperplanes: ``(dim, n_bits)`` float32 drawn from
    PCG64(seed), the JAX package's draw, so a restored store re-derives
    the codes it was saved with."""
    gen = np.random.Generator(np.random.PCG64(spec.seed))
    return gen.standard_normal((spec.dim, spec.n_bits)) \
        .astype(np.float32)


def encode_rows(rows: torch.Tensor, flags: torch.Tensor,
                planes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """DB-side codes: ``(m, dim)`` rows + ``(m, n_flags)`` indicator
    columns -> ``(m, n_words)`` int32 (code words | flag groups)."""
    codes = lsh_hash(rows.to(torch.float32).contiguous(), planes)
    m = rows.shape[0]
    groups = [codes]
    for j in range(spec.n_flags):
        word = torch.where(flags[:, j] > 0, FLAG_SET, 0).to(torch.int32)
        groups.append(word[:, None].expand(m, spec.flag_words))
    return torch.cat(groups, dim=1)


def encode_queries(q: torch.Tensor, planes: torch.Tensor,
                   flag_bias: Tuple[float, ...],
                   spec: QuantSpec) -> torch.Tensor:
    """Query-side codes: the flag groups encode the bias -- all zeros to
    penalize a masked flag, half-bits to ignore it."""
    codes = lsh_hash(q.to(torch.float32).contiguous(), planes)
    b = q.shape[0]
    groups = [codes]
    for bias in flag_bias:
        word = 0 if bias != 0.0 else _FLAG_IGNORE
        groups.append(torch.full((b, spec.flag_words), word,
                                 dtype=torch.int32, device=q.device))
    return torch.cat(groups, dim=1)


def prepare_queries(q: torch.Tensor, flag_bias: Tuple[float, ...],
                    planes: torch.Tensor, spec: QuantSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A query block's two inputs to ``two_stage_topk``: the augmented
    fp32 queries and their codes.  The sharded store makes them once a
    batch and scans every shard with them, as the JAX collective does."""
    return (augment_queries(q, flag_bias).contiguous(),
            encode_queries(q, planes, flag_bias, spec))


def two_stage_topk(q_aug: torch.Tensor, q_codes: torch.Tensor,
                   db: torch.Tensor, codes: torch.Tensor, k: int,
                   n_coarse: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse top-C by (Hamming distance, row) -> exact rescore of each
    query's own C rows by (score desc, row asc)."""
    _, cand = hamming_topk(q_codes, codes, n_coarse)
    return mips_rescore(q_aug, db, cand, k)


def quantized_flagged_topk(q: torch.Tensor, db_flagged: torch.Tensor,
                           codes: torch.Tensor, k: int, n_coarse: int,
                           flag_bias: Tuple[float, ...],
                           planes: torch.Tensor, spec: QuantSpec
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage flag-masked top-k: the quantized twin of
    ``flagged_mips_topk`` (encode + coarse + rescore).  Requires
    ``k <= n_coarse <= rows``; returns ``(vals, row_idx)`` with scores
    bitwise the exact scan's for the rows it returns."""
    assert k <= n_coarse <= db_flagged.shape[0], \
        (k, n_coarse, tuple(db_flagged.shape))
    assert tuple(codes.shape) == (db_flagged.shape[0], spec.n_words), \
        (tuple(codes.shape), tuple(db_flagged.shape), spec)
    q_aug, qc = prepare_queries(q, flag_bias, planes, spec)
    return two_stage_topk(q_aug, qc, db_flagged, codes, int(k),
                          int(n_coarse))


def sharded_quantized_topk(q: torch.Tensor, db_local: torch.Tensor,
                           codes_local: torch.Tensor,
                           seq_local: torch.Tensor, planes: torch.Tensor,
                           k_shard: int, k_out: int, n_coarse: int,
                           flag_bias: Tuple[float, ...], spec: QuantSpec,
                           *, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage twin of ``sharded_mips_topk``: the query block and
    its codes made once a call, then on each of this rank's slots the
    coarse scan over its ``(cap, n_words)`` codes (``hamming_topk``)
    and the rescore of those C rows (``mips_rescore``), the rows mapped
    to global sequence numbers, and the same gather and merge
    (``gather_merge_topk``); one count on the collective counter."""
    s_local, cap, _ = db_local.shape
    assert tuple(codes_local.shape) == (s_local, cap, spec.n_words), \
        (tuple(codes_local.shape), tuple(db_local.shape), spec)
    assert k_shard <= n_coarse <= cap and \
        s_local * group.world_size * k_shard >= k_out, \
        (tuple(db_local.shape), group.world_size, k_shard, n_coarse,
         k_out)
    count_collective()
    q_aug, qc = prepare_queries(q, flag_bias, planes, spec)
    vals, seqs = [], []
    for j in range(s_local):
        v, r = two_stage_topk(q_aug, qc, db_local[j], codes_local[j],
                              int(k_shard), int(n_coarse))
        vals.append(v)
        seqs.append(seq_local[j][r.long()])
    return gather_merge_topk(torch.stack(vals), torch.stack(seqs),
                             int(k_out), group)
