"""hamming_topk parity: the port's plain version (what a CPU tensor runs)
against the JAX package's ``hamming_topk_ref`` and its Pallas kernel in
interpret mode, bitwise (distances and indices are integers), on
numpy-seeded words with bit 31 set and duplicated codes.  The CUDA
kernel itself is tested in ``test_torch_cuda.py``.
"""
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hamming_topk.kernel import hamming_topk_pallas
from repro.kernels.hamming_topk.ref import hamming_dist_ref as jax_dist
from repro.kernels.hamming_topk.ref import hamming_topk_ref as jax_topk

from repro_torch.kernels.common import CSRC_DIR
from repro_torch.kernels.hamming_topk import breakdown, ops
from repro_torch.kernels.hamming_topk.ref import hamming_dist_ref, \
    popcount32
from repro_torch.kernels.timing import instrumented_source
from torch_threads import one_blas_thread  # noqa: F401


def _codes(b, n, w, seed):
    """Random uint32 words (about half with bit 31 set), with duplicated
    rows and a query equal to a row, so distances tie."""
    rng = np.random.default_rng(seed + 31 * n + w)
    qc = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    base = rng.integers(0, 2**32, size=(max(2, n // 4), w),
                        dtype=np.uint32)
    dbc = base[rng.integers(0, base.shape[0], size=n)]
    dbc[n // 2] = 0xFFFFFFFF
    qc[0] = dbc[n - 1]
    assert (dbc >> np.uint32(31)).any() and (qc >> np.uint32(31)).any()
    return qc, dbc


def _port(qc, dbc, k):
    d, i = ops.hamming_topk(torch.from_numpy(qc.view(np.int32)),
                            torch.from_numpy(dbc.view(np.int32)), k)
    assert d.dtype == torch.int32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def test_popcount_of_signed_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555,
                      0x0F0F0F0F, 0xDEADBEEF], dtype=np.uint32)
    want = [bin(int(x)).count("1") for x in words]
    got = popcount32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("w", [1, 2, 11])
def test_distances_match_reference(w):
    qc, dbc = _codes(5, 90, w, seed=0)
    got = hamming_dist_ref(torch.from_numpy(qc.view(np.int32)),
                           torch.from_numpy(dbc.view(np.int32)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_dist(jnp.asarray(qc),
                                         jnp.asarray(dbc))))


@pytest.mark.parametrize("w", [1, 2, 11])
@pytest.mark.parametrize("which_k", ["1", "32", "n"])
def test_plain_matches_reference_bitwise(w, which_k):
    n = 300
    k = {"1": 1, "32": 32, "n": n}[which_k]
    qc, dbc = _codes(6, n, w, seed=1)
    got = _port(qc, dbc, k)
    want = jax_topk(jnp.asarray(qc), jnp.asarray(dbc), k)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    # ordered by (distance asc, row asc)
    d, i = got
    assert (np.diff(d, axis=1) >= 0).all()
    assert ((np.diff(d, axis=1) > 0) | (np.diff(i, axis=1) > 0)).all()


@pytest.mark.parametrize("b,n,w,k", [(5, 300, 11, 8), (5, 300, 11, 32),
                                     (3, 64, 2, 64), (2, 130, 1, 1)])
def test_plain_matches_pallas_interpret_bitwise(b, n, w, k):
    qc, dbc = _codes(b, n, w, seed=2)
    got = _port(qc, dbc, k)
    # small blocks: several n-tiles, so ties cross tile boundaries
    want = hamming_topk_pallas(jnp.asarray(qc), jnp.asarray(dbc), k,
                               block_q=8, block_n=64, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_duplicates_resolve_to_the_lowest_index():
    code = np.array([[0x80000001, 7]], dtype=np.uint32)
    dbc = np.array([[1, 7], [0x80000001, 7], [3, 3], [0x80000001, 7],
                    [0x80000001, 7]], dtype=np.uint32)
    d, i = _port(code, dbc, 5)
    assert d.tolist() == [[0, 0, 0, 1, 3]]
    assert i.tolist() == [[1, 3, 4, 0, 2]]


def test_shape_and_k_checks():
    qc = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 4), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 3), dtype=torch.int32), 11)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc, torch.zeros((10, 3), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        ops.hamming_topk(qc[0], torch.zeros((10, 3), dtype=torch.int32), 1)
    wide = torch.zeros((2, ops.MAX_W + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"w <= {ops.MAX_W}"):
        ops.hamming_topk_cuda(wide, wide, 1)
    with pytest.raises(TypeError):
        ops.hamming_topk_cuda(qc.to(torch.int64),
                              torch.zeros((10, 3), dtype=torch.int64), 1)


# ---------------------------------------------------------------------------
# hamming_route: which kernels a call goes to, and their grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 32, ops.LIST_MAX_C, ops.LIST_MAX_C + 1,
                               4096])
def test_route_boundary_at_list_max_c(c):
    grid = ops.hamming_route(64, 1 << 22, 11, c, 132)
    assert grid.route == ("list" if c <= ops.LIST_MAX_C else "count")
    if grid.route == "count":   # the counting kernels' own grid
        assert (grid.rows_per_range, grid.n_ranges) == \
            ops.scan_ranges(64, 1 << 22, 132)
        assert grid.key_bits == 0


@pytest.mark.parametrize("b,n,w", [(1, 1, 1), (1, 255, 11), (8, 257, 2),
                                   (9, 5000, 11), (64, 32768, 11),
                                   (65, 35841, 41), (130, 1 << 22, 11),
                                   (3, 700, 80), (1000, 70000, 67)])
def test_list_grid_covers_rows(b, n, w):
    for sms in (1, 7, 132):
        g = ops.hamming_route(b, n, w, 32, sms)
        assert g.route == "list"
        wide = 256 if w <= ops.LIST_TILE_W[1] else 128
        q_tiles = -(-b // g.query_tile)
        fills = -(-n // 512) * q_tiles >= sms
        assert g.tile_rows == (512 if w <= ops.LIST_TILE_W[0] and fills
                               else wide)
        assert g.rows_per_range % g.tile_rows == 0
        assert g.n_ranges * g.rows_per_range >= n
        assert (g.n_ranges - 1) * g.rows_per_range < n
        # about one block per SM: never more blocks than SMs, unless the
        # query tiles alone outnumber them
        assert g.n_ranges * q_tiles <= max(sms, q_tiles)


@pytest.mark.parametrize("b,tile", [(1, 8), (8, 8), (9, 16), (16, 16),
                                    (17, 32), (33, 64), (64, 64),
                                    (65, 64), (130, 64)])
def test_list_query_tiles(b, tile):
    """The narrowest tile of 8, 16, 32 or 64 queries that holds b;
    larger b in tiles of 64 on the grid's second axis."""
    g = ops.hamming_route(b, 1 << 22, 11, 32, 132)
    assert g.query_tile == tile
    q_tiles = -(-b // tile)
    assert q_tiles == (1 if b <= 64 else -(-b // 64))
    assert g.n_ranges == -(-(1 << 22) // g.rows_per_range)
    assert g.n_ranges * q_tiles <= 132


def test_list_grid_at_the_serving_shapes():
    # the main path's code plane: one 256-row tile per range
    assert ops.hamming_route(64, 32768, 11, 32, 132) == \
        ops.HammingGrid("list", 64, 256, 256, 128, 32)
    # 2^22 rows: 512-row tiles, 63 a range, 32-bit keys (9 + 15 bits)
    assert ops.hamming_route(64, 1 << 22, 11, 32, 132) == \
        ops.HammingGrid("list", 64, 512, 63 * 512, 131, 32)
    assert ops.hamming_route(1, 1 << 22, 11, 32, 132) == \
        ops.HammingGrid("list", 8, 512, 63 * 512, 131, 32)
    # wider codes stage fewer rows a tile
    assert ops.hamming_route(64, 1 << 22, 17, 32, 132).tile_rows == 256
    assert ops.hamming_route(64, 1 << 22, 41, 32, 132).tile_rows == 128


@pytest.mark.parametrize("w,rows,bits", [
    (11, 32000, 32), (11, 1 << 23, 32), (11, (1 << 23) + 1, 64),
    (80, 1 << 20, 32), (80, (1 << 20) + 1, 64), (1, 1 << 26, 32),
    (1, (1 << 26) + 1, 64), (2, 1, 32)])
def test_key_width_follows_distance_and_range_bits(w, rows, bits):
    """32-bit keys hold dist (at most 32 w) above an offset within the
    range; the host falls back to 64 bits where the two do not fit."""
    assert ops.list_key_bits(w, rows) == bits
    if bits == 32:
        top = ((32 * w) << (rows - 1).bit_length()) | (rows - 1)
        assert top < 0xFFFFFFFF           # below the empty-slot sentinel


def test_key_width_reaches_the_route():
    # w = 80 with 2^21 rows in one range needs 12 + 21 bits
    g = ops.hamming_route(64, 1 << 21, 80, 32, 1)
    assert (g.n_ranges, g.key_bits) == (1, 64)
    assert ops.hamming_route(64, 1 << 21, 80, 32, 132).key_bits == 32


def _cu_const(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _list_smem_bytes(source, w, tile_rows, query_tile, c, key_bytes):
    """``ListLayout::bytes`` of ``csrc/hamming_topk.cu``: the scan's
    shared memory, from the source's own constants."""
    warps = _cu_const(source, "kListThreads") // 32
    q, stages = _cu_const(source, "kQ"), _cu_const(source, "kStages")
    stage_words = (tile_rows * w + 3 + 3) & ~3
    ring_words = max(stages * stage_words, warps * q * c * key_bytes // 4)
    q_words = query_tile * ((w + 3) & ~3)
    return 4 * (ring_words + q_words) + warps * q * 32 * key_bytes


def test_list_route_constants_match_the_source():
    """The grid that ``hamming_route`` builds is what the launcher takes:
    the same largest C, the same query tiles, the most queries a block's
    warps hold, row tiles of whole warps."""
    source = (CSRC_DIR / "hamming_topk.cu").read_text()
    assert _cu_const(source, "kListMaxC") == ops.LIST_MAX_C
    launcher = source[source.index('extern "C" int hamming_list_launch'):]
    tiles = re.search(r"tile_ok = ([^;]+);", launcher).group(1)
    assert tuple(int(t) for t in re.findall(r"query_tile == (\d+)",
                                             tiles)) == ops.LIST_QUERY_TILES
    assert ops.LIST_QUERY_TILES[-1] == \
        _cu_const(source, "kListThreads") // 32 * _cu_const(source, "kQ")
    assert all(t % 32 == 0 for t in ops.LIST_TILE_ROWS)


@pytest.mark.parametrize("w", [1, 2, 11, 16, 17, 40, 41, 67, ops.MAX_W])
def test_list_grids_fit_the_scan_shared_memory(w):
    """Every list-route grid, with its own key width and with 64-bit keys
    (as the card tests force them), fits the scan's shared memory
    (``kSmemMax``): a launch the launcher would refuse is caught here,
    not on the card."""
    source = (CSRC_DIR / "hamming_topk.cu").read_text()
    limit = _cu_const(source, "kSmemMax")
    for b, n, sms, c in itertools.product(
            (1, 8, 9, 33, 64, 130), (1, 700, 5000, 70000, 1 << 22),
            (1, 132), (1, 32, 33, 64, 65, ops.LIST_MAX_C)):
        if c > n:
            continue
        g = ops.hamming_route(b, n, w, c, sms)
        assert g.route == "list"
        for key_bits in {g.key_bits, 64}:
            assert _list_smem_bytes(source, w, g.tile_rows, g.query_tile, c,
                                    key_bits // 8) <= limit, (b, n, sms, c)


class _Lib:
    def __init__(self):
        self.calls = []

    def hamming_list_launch(self, *args):
        self.calls.append(("list", args))
        return 0

    def hamming_topk_launch(self, *args):
        self.calls.append(("count", args))
        return 0


def _stubbed(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(ops, "load_kernel", lambda name, sigs: lib)
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "stream_ptr", lambda dev: None)
    return lib


@pytest.mark.parametrize("c,route", [(32, "list"), (ops.LIST_MAX_C, "list"),
                                     (ops.LIST_MAX_C + 1, "count")])
def test_cuda_wrapper_hands_the_route_grid_to_the_launcher(monkeypatch, c,
                                                           route):
    """The wrapper's arguments, in the order of the C entry points'
    ctypes signatures (the kernels themselves run only on the card), and
    one launch counted per call, on its route."""
    lib = _stubbed(monkeypatch)
    ops.reset_launch_count()
    qc = torch.zeros((17, 11), dtype=torch.int32)
    dbc = torch.zeros((70000, 11), dtype=torch.int32)
    ops.hamming_topk_cuda(qc, dbc, c)
    assert ops.launch_count() == 1
    assert ops.route_launch_counts() == {r: int(r == route)
                                         for r in ops.ROUTES}
    ((kind, args),) = lib.calls
    assert kind == route
    g = ops.hamming_route(17, 70000, 11, c, 132)
    name = "hamming_list_launch" if route == "list" else \
        "hamming_topk_launch"
    assert len(args) == len(ops._SIGNATURES[name][0])
    if route == "list":
        assert args[5:14] == (17, 70000, 11, c, g.query_tile, g.tile_rows,
                              g.rows_per_range, g.n_ranges, g.key_bits)
    else:
        assert args[6:12] == (17, 70000, 11, c, g.rows_per_range,
                              g.n_ranges)


def test_cuda_wrapper_takes_the_key_width_from_list_key_bits(monkeypatch):
    """The launcher gets the key width that ``list_key_bits`` chose: 32
    bits for a narrow range, 64 where the range is too long for them,
    and 64 wherever ``list_key_bits`` says so (as the card tests force
    it)."""
    lib = _stubbed(monkeypatch)
    qc = torch.zeros((4, 80), dtype=torch.int32)
    small = torch.zeros((300, 80), dtype=torch.int32)
    ops.hamming_topk_cuda(qc, small, 8)
    assert lib.calls[-1][1][13] == 32
    monkeypatch.setattr(ops, "sm_count", lambda dev: 1)
    ops.hamming_topk_cuda(qc, torch.zeros((1 << 21, 80), dtype=torch.int32),
                          8)
    assert lib.calls[-1][1][13] == 64
    monkeypatch.setattr(ops, "list_key_bits", lambda w, rows: 64)
    ops.hamming_topk_cuda(qc, small, 8)
    assert lib.calls[-1][1][13] == 64
    assert len(lib.calls) == 3


@pytest.mark.parametrize("variant", sorted(breakdown.VARIANTS))
def test_breakdown_switches_apply_to_the_shipped_source(variant):
    """Each instrumented copy that the breakdown tool builds is the
    kernel source with exactly its switches applied."""
    source = (CSRC_DIR / "hamming_topk.cu").read_text()
    switches = breakdown.VARIANTS[variant]
    copy = instrumented_source(source, breakdown.SWITCHES, switches)
    assert (copy == source) == (not switches)
    for name in switches:
        assert breakdown.SWITCHES[name][1] in copy
    with pytest.raises(ValueError):
        instrumented_source(source, breakdown.SWITCHES,
                            ("NO_LOAD", "NO_LOAD"))
