"""Public Hamming top-k op: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors.

The coarse stage of the store's two-stage quantized scan
(``kernels/quantized_scan``): queries and rows hash to packed LSH
sign-bit codes, this op selects the C nearest codes per query, and only
those C rows are rescored in fp32.  Equal distances resolve to the
lowest row index on both routes, so the candidate lists are identical
and deterministic.  Words are int32 tensors with the uint32 bits.

On the card ``hamming_route`` sends each call to one of two kernels of
``csrc/hamming_topk.cu`` (``ROUTES``), with no fallback between them:

- ``list`` for C <= ``LIST_MAX_C`` (the serving C is
  ``coarse_mult * top_k`` = 32): one pass over the code plane per 64
  queries, a warp-select top-C per (query, row range), and a merge;
- ``count`` for larger C (up to n): an exact counting selection over
  distance histograms, three launches.

Launch counters on the obs registry: ``kernels.hamming_topk.launches``
(one per call) and, beside it, ``kernels.hamming_topk.<route>.launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.common import SCAN_BQ, SCAN_ROWS, cdiv, \
    check_launch, load_kernel, scan_ranges, sm_count, stream_ptr
from repro_torch.kernels.hamming_topk import ref
from repro_torch.obs.metrics import global_registry

MAX_W = 80          # words per code the CUDA kernels take
LIST_MAX_C = 128    # largest C of the list route (kListMaxC in the source)
ROUTES = ("list", "count")
# the list route's scan (csrc/hamming_topk.cu): 8 queries per warp and
# 8 warps per block, so a query tile holds 8 to 64 queries.  Rows per
# staged tile: 512 up to LIST_TILE_W[0] words a row (where such tiles
# fill the card), 256 up to LIST_TILE_W[1], else 128, so that a stage
# holds at most 40 KB
LIST_QUERY_TILES = (8, 16, 32, 64)
LIST_TILE_ROWS = (512, 256, 128)
LIST_TILE_W = (16, 40)

_LAUNCHES = global_registry().counter("kernels.hamming_topk.launches")
_ROUTE_LAUNCHES = {route: global_registry().counter(
    f"kernels.hamming_topk.{route}.launches") for route in ROUTES}

_SIGNATURES = {
    "hamming_topk_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p], ctypes.c_int),
    "hamming_list_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p], ctypes.c_int),
}


class HammingGrid(NamedTuple):
    """One call's route and grid.  ``query_tile`` and ``tile_rows`` are
    the queries per block and rows per staged tile; ``key_bits`` the
    width of the list route's (distance, row) keys (0 on the count
    route)."""
    route: str
    query_tile: int
    tile_rows: int
    rows_per_range: int
    n_ranges: int
    key_bits: int


def list_key_bits(w: int, rows_per_range: int) -> int:
    """32 where a key ``dist << s | offset`` fits: s bits hold an offset
    in the range, and dist is at most 32 w; else 64."""
    bits = (32 * w).bit_length() + (rows_per_range - 1).bit_length()
    return 32 if bits <= 32 else 64


def hamming_route(b: int, n: int, w: int, c: int,
                  n_sms: int) -> HammingGrid:
    """The route and grid of a (b, w) x (n, w) top-``c`` call.

    ``list`` (c <= LIST_MAX_C): the narrowest query tile that holds b
    (larger b in tiles of 64); 512-row tiles for w <= 16 where they fill
    the card, else 256 rows (w <= 40) or 128; and about one block per SM
    over the query tiles, each a contiguous range of whole row tiles.
    ``count``: the counting kernels' grid (``scan_ranges``)."""
    if c > LIST_MAX_C:
        rows_per_range, n_ranges = scan_ranges(b, n, n_sms)
        return HammingGrid("count", SCAN_BQ, SCAN_ROWS, rows_per_range,
                           n_ranges, 0)
    tile = next((t for t in LIST_QUERY_TILES if b <= t),
                LIST_QUERY_TILES[-1])
    q_tiles = cdiv(b, tile)
    large, mid, small = LIST_TILE_ROWS
    if w <= LIST_TILE_W[0] and cdiv(n, large) * q_tiles >= n_sms:
        tile_rows = large
    else:
        tile_rows = mid if w <= LIST_TILE_W[1] else small
    tiles = cdiv(n, tile_rows)
    want = max(1, n_sms // q_tiles)
    rows_per_range = cdiv(tiles, min(tiles, want)) * tile_rows
    return HammingGrid("list", tile, tile_rows, rows_per_range,
                       cdiv(n, rows_per_range),
                       list_key_bits(w, rows_per_range))


def reset_launch_count() -> None:
    _LAUNCHES.reset()
    for counter in _ROUTE_LAUNCHES.values():
        counter.reset()


def launch_count() -> int:
    """Calls that launched the CUDA kernels since the last reset."""
    return _LAUNCHES.count


def route_launch_counts() -> dict:
    """``{route: calls}`` since the last reset: which kernels
    (``ROUTES``) the calls went to."""
    return {route: _ROUTE_LAUNCHES[route].count for route in ROUTES}


def hamming_topk_cuda(qc: torch.Tensor, dbc: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/hamming_topk.cu`` on int32 contiguous CUDA tensors."""
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
    grid = hamming_route(b, n, w, k, sm_count(dev))
    lib = load_kernel("hamming_topk", _SIGNATURES)
    if grid.route == "list":
        # each (query, range)'s top-k keys
        part = torch.empty((b, grid.n_ranges, k), device=dev,
                           dtype=torch.int32 if grid.key_bits == 32
                           else torch.int64)
        err = lib.hamming_list_launch(
            qc.data_ptr(), dbc.data_ptr(), part.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), b, n, w, k, grid.query_tile, grid.tile_rows,
            grid.rows_per_range, grid.n_ranges, grid.key_bits,
            stream_ptr(dev))
    else:
        # per-(query, range) distance histograms, turned into output
        # offsets in place; the threshold distance per query
        hist = torch.empty((b, grid.n_ranges, 32 * w + 1),
                           dtype=torch.int32, device=dev)
        thresh = torch.empty((b,), dtype=torch.int32, device=dev)
        err = lib.hamming_topk_launch(
            qc.data_ptr(), dbc.data_ptr(), hist.data_ptr(),
            thresh.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, w, k,
            grid.rows_per_range, grid.n_ranges, stream_ptr(dev))
    check_launch(lib, "hamming_topk", err)
    _LAUNCHES.inc()
    _ROUTE_LAUNCHES[grid.route].inc()
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
