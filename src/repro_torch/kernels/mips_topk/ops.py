"""Public MIPS top-k ops: the local scan and the flag-masked scan.

``mips_topk`` sends a CUDA tensor to the kernel (``csrc/mips_topk.cu``)
or raises, and a CPU tensor to the plain version.  Both order by
(score descending, row index ascending).  ``flagged_mips_topk`` folds
the store's per-flag biases into the queries (``augment_queries``), so
the kernel stays a plain MIPS top-k.

``mips_rescore`` is the exact stage of the two-stage quantized scan:
the scan's score chain over each query's own list of candidate rows
(``mips_rescore_launch`` in the same source, one kernel launch a call on
``rescore_grid``'s grid, no scratch), so a rescored score is bitwise the
scan's score for that row.

``merge_sharded_topk`` merges the sharded store's per-shard candidates
into the global top-k by (score desc, sequence asc).  It is XLA in the
JAX package, so here it is plain torch ops on the candidates' device.

``sharded_mips_topk`` is the collective query of a store laid over a
process group (``launch/mesh.py``): each rank scans its own slots with
the kernel, maps rows to global sequence numbers, and
``gather_merge_topk`` all-gathers the small ``(s, b, k)`` candidate
block and merges it, so every rank returns the same top-k.

The launch counters live on the process-global obs registry
(``kernels.mips_topk.launches``, ``kernels.mips_rescore.launches``) and
count CUDA kernel launches only; the merge and the collective count
their calls apart (``kernels.mips_topk.merge.launches``,
``kernels.mips_topk.collective.launches``: one a collective call, as
the JAX package counts its one ``shard_map`` launch); per-store
attribution of scans is ``StoreStats.kernel_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels.common import check_launch, load_kernel, \
    mips_scan_grid, rescore_grid, sm_count, stream_ptr
from repro_torch.kernels.mips_topk import ref
from repro_torch.obs.metrics import global_registry

MAX_K = 64          # k the CUDA kernel takes

_LAUNCHES = global_registry().counter("kernels.mips_topk.launches")
_RESCORE_LAUNCHES = global_registry().counter(
    "kernels.mips_rescore.launches")
_MERGE_LAUNCHES = global_registry().counter(
    "kernels.mips_topk.merge.launches")
_COLLECTIVE_LAUNCHES = global_registry().counter(
    "kernels.mips_topk.collective.launches")

# per-shard candidate padding: a value below every real (or MASK_BIAS-
# masked) score and a sequence number above every real row's, so padded
# candidates merge last
VAL_PAD = float(torch.finfo(torch.float32).min)
SEQ_PAD = 2**31 - 1

_SIGNATURES = {
    "mips_topk_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p], ctypes.c_int),
    "mips_rescore_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p], ctypes.c_int),
}


def reset_launch_count() -> None:
    _LAUNCHES.reset()
    _RESCORE_LAUNCHES.reset()
    _MERGE_LAUNCHES.reset()
    _COLLECTIVE_LAUNCHES.reset()


def merge_launch_count() -> int:
    """``merge_sharded_topk`` calls since the last reset."""
    return _MERGE_LAUNCHES.count


def collective_launch_count() -> int:
    """Collective calls (``sharded_mips_topk``,
    ``sharded_quantized_topk``) since the last reset."""
    return _COLLECTIVE_LAUNCHES.count


def count_collective() -> None:
    _COLLECTIVE_LAUNCHES.inc()


def launch_count() -> int:
    """``mips_topk`` CUDA kernel launches since the last reset."""
    return _LAUNCHES.count


def rescore_launch_count() -> int:
    """``mips_rescore`` CUDA kernel launches since the last reset."""
    return _RESCORE_LAUNCHES.count


def _check_f32(name: str, *ts: torch.Tensor) -> None:
    # plain loops: generator expressions cost microseconds a call here,
    # where a small scan's kernel takes a few
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32 inputs")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous inputs")


def mips_topk_cuda(q: torch.Tensor, db: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/mips_topk.cu`` on fp32 contiguous CUDA tensors."""
    b, d = q.shape
    n = db.shape[0]
    if k > MAX_K:
        raise ValueError(f"mips_topk kernel takes k <= {MAX_K}, got {k}")
    _check_f32("mips_topk", q, db)
    dev = q.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    tile, tile_rows, rows_per_range, n_ranges = mips_scan_grid(
        b, n, sm_count(dev))
    part_v = torch.empty((b, n_ranges, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((b, n_ranges, k), dtype=torch.int32, device=dev)
    lib = load_kernel("mips_topk", _SIGNATURES)
    err = lib.mips_topk_launch(
        q.data_ptr(), db.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), b, n, d, k, tile, tile_rows,
        rows_per_range, n_ranges, stream_ptr(dev))
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


def mips_rescore_cuda(q: torch.Tensor, db: torch.Tensor,
                      cand: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``mips_rescore_launch`` of ``csrc/mips_topk.cu``."""
    b, d = q.shape
    n = db.shape[0]
    c = cand.shape[1]
    if k > MAX_K:
        raise ValueError(f"mips_rescore kernel takes k <= {MAX_K}, "
                         f"got {k}")
    _check_f32("mips_rescore", q, db)
    if cand.dtype != torch.int32 or not cand.is_contiguous():
        raise TypeError("mips_rescore kernel takes contiguous int32 "
                        "candidates")
    dev = q.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    lib = load_kernel("mips_topk", _SIGNATURES)
    err = lib.mips_rescore_launch(
        q.data_ptr(), db.data_ptr(), cand.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), b, n, d, c, k, *rescore_grid(b, c, sm_count(dev)),
        stream_ptr(dev))
    check_launch(lib, "mips_topk", err)
    _RESCORE_LAUNCHES.inc()
    return vals, idx


def mips_rescore(q: torch.Tensor, db: torch.Tensor, cand: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query against ITS OWN candidate rows
    ``cand[b]`` (distinct indices into ``db``): (vals (b, k) f32, DB row
    idx (b, k) int32) by (score desc, row asc).  Needs k <= c."""
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1] \
            or cand.dim() != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError(f"expected (b, d), (n, d) and (b, c), got "
                         f"{tuple(q.shape)}, {tuple(db.shape)} and "
                         f"{tuple(cand.shape)}")
    if not 1 <= k <= cand.shape[1]:
        raise ValueError(f"need 1 <= k <= c, got k={k}, "
                         f"c={cand.shape[1]}")
    if not q.device == db.device == cand.device:
        raise ValueError(f"inputs on {q.device}, {db.device} and "
                         f"{cand.device}")
    if q.device.type == "cuda":
        return mips_rescore_cuda(q, db, cand, k)
    if q.device.type == "cpu":
        return ref.mips_rescore_ref(q, db, cand, k)
    raise ValueError(f"mips_rescore: no route for device {q.device}")


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


def merge_sharded_topk(vals: torch.Tensor, seqs: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k results: (s, b, kk) scores and int32
    sequence numbers -> the global (b, k), by (score desc, sequence
    asc), the JAX package's ``jnp.lexsort((seq, -val))``.

    Ties break by the smaller sequence number, not by candidate
    position, so when the sequence numbers carry the rows' global order
    the result is bitwise a single scan's over the unsharded rows.
    Candidates are sorted by sequence first, then stably by score; the
    score key is ``v + 0.0``, which makes -0.0 and 0.0 one key, as the
    JAX sort's canonicalised keys do."""
    s, b, kk = vals.shape
    flat_v = vals.transpose(0, 1).reshape(b, s * kk)
    flat_s = seqs.transpose(0, 1).reshape(b, s * kk)
    by_seq = torch.argsort(flat_s, dim=1, stable=True)
    flat_v = flat_v.gather(1, by_seq)
    flat_s = flat_s.gather(1, by_seq)
    order = torch.argsort(flat_v + 0.0, dim=1, descending=True,
                          stable=True)[:, :k]
    _MERGE_LAUNCHES.inc()
    return flat_v.gather(1, order), flat_s.gather(1, order)


def gather_merge_topk(vals: torch.Tensor, seqs: torch.Tensor, k: int,
                      group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collective's second half: this rank's ``(s_local, b, kk)``
    scores and int32 sequence numbers, all-gathered over ``group``
    (one gather of both, as one int32 block) into the ``(S, b, kk)``
    candidates of every slot in slot order, then merged to the global
    ``(b, k)`` -- the same result on every rank.  Without a group the
    candidates are every slot's already and are merged as they are."""
    if group is None:
        return merge_sharded_topk(vals, seqs, k)
    kk = vals.shape[2]
    both = group.all_gather(torch.cat([vals.view(torch.int32), seqs],
                                      dim=2))
    return merge_sharded_topk(both[..., :kk].contiguous()
                              .view(torch.float32),
                              both[..., kk:].contiguous(), k)


def local_slot_scans(q_aug: torch.Tensor, db_local: torch.Tensor,
                     seq_local: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each local slot's top ``k`` by the kernel on the slot's own view
    (the loop route's scan, ``store.slot_topk``, at the same k), its
    rows mapped to global sequence numbers: ``(s_local, b, k)``."""
    vals: List[torch.Tensor] = []
    seqs: List[torch.Tensor] = []
    for j in range(db_local.shape[0]):
        v, i = mips_topk(q_aug, db_local[j], k)
        vals.append(v)
        seqs.append(seq_local[j][i.long()])
    return torch.stack(vals), torch.stack(seqs)


def sharded_mips_topk(q: torch.Tensor, db_local: torch.Tensor,
                      seq_local: torch.Tensor, k_shard: int, k_out: int,
                      flag_bias: Tuple[float, ...], *, group
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collective sharded top-k over a process group: the JAX package's
    one ``shard_map`` launch, as one call on every rank.

    ``db_local`` is this rank's ``(s_local, cap, d + F)`` share of the
    store's stacked buffer and ``seq_local`` its ``(s_local, cap)`` int32
    sequence plane (``S = s_local * world_size`` slots in all, the same
    capacity everywhere).  The augmented query block is built once; each
    local slot is scanned with ``mips_topk`` at ``k_shard``; the
    candidates are gathered and merged (``gather_merge_topk``).  Exact
    whenever ``S * k_shard >= k_out``.  Returns the merged ``(vals,
    seqs)``, the same on every rank; the caller maps sequence numbers to
    ids."""
    s_local, cap, _ = db_local.shape
    assert k_shard <= cap and s_local * group.world_size * k_shard >= \
        k_out, (tuple(db_local.shape), group.world_size, k_shard, k_out)
    count_collective()
    q_aug = augment_queries(q, flag_bias).contiguous()
    vals, seqs = local_slot_scans(q_aug, db_local, seq_local, k_shard)
    return gather_merge_topk(vals, seqs, k_out, group)
