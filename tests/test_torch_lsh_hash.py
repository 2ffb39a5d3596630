"""lsh_hash parity: the port's plain version (what a CPU tensor runs)
against the JAX package's Pallas kernel in interpret mode and its jnp
reference, bitwise, on numpy-seeded inputs; ``HyperplaneLSH`` against
the reference's; the kernel's grid (``lsh_grid``), the wrapper's launch
arguments and the breakdown tool's copies of the source.  The CUDA
kernel itself is tested in ``test_torch_cuda.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lsh import HyperplaneLSH as JaxLSH
from repro.kernels.lsh_hash.ops import codes_to_int as jax_codes_to_int
from repro.kernels.lsh_hash.ops import lsh_hash as jax_lsh_hash
from repro.kernels.lsh_hash.ops import unpack_bits as jax_unpack_bits

from repro_torch.core.lsh import HyperplaneLSH
from repro_torch.kernels import common
from repro_torch.kernels.common import CSRC_DIR, cdiv
from repro_torch.kernels.lsh_hash import breakdown, ops
from repro_torch.kernels.lsh_hash.ref import lsh_hash_ref
from repro_torch.kernels.timing import instrumented_source
from torch_threads import one_blas_thread  # noqa: F401

SHAPES = [(1, 256, 12), (300, 256, 12), (77, 259, 33), (64, 128, 64),
          (50, 256, 128)]


def _inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed + 7 * n + d + k)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[0] = 0.0   # the embedder's empty-text row: every bit set
    h = rng.standard_normal((d, k)).astype(np.float32)
    return v, h


def _port_codes(v, h):
    codes = ops.lsh_hash(torch.from_numpy(v), torch.from_numpy(h))
    assert codes.dtype == torch.int32
    return codes.numpy().view(np.uint32)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_plain_matches_pallas_interpret_bitwise(n, d, k):
    v, h = _inputs(n, d, k)
    want = np.asarray(jax_lsh_hash(jnp.asarray(v), jnp.asarray(h),
                                   use_pallas=True, interpret=True))
    got = _port_codes(v, h)
    assert got.shape == want.shape == (n, -(-k // 32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_lsh_hash(jnp.asarray(v), jnp.asarray(h),
                                     use_pallas=False)))
    # zero projection sets the bit: the zero row is all ones up to k
    assert jax_codes_to_int(got[:1], k)[0] == (1 << k) - 1


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_unpack_and_int_keys_match(n, d, k):
    v, h = _inputs(n, d, k, seed=1)
    codes = _port_codes(v, h)
    np.testing.assert_array_equal(
        ops.unpack_bits(torch.from_numpy(codes.view(np.int32)), k).numpy(),
        np.asarray(jax_unpack_bits(jnp.asarray(codes), k)))
    got = ops.codes_to_int(codes.view(np.int32), k)
    want = jax_codes_to_int(codes, k)
    assert got.dtype == want.dtype
    assert list(got) == list(want)


@pytest.mark.parametrize("k", [1, 12, 32, 33, 64])
def test_tail_bits_masked(k):
    """Bits at positions >= k are 0 on the plain route (canonical), and
    the plain version masks them itself: the op adds nothing."""
    v, h = _inputs(40, 16, k, seed=2)
    codes = _port_codes(v, h)
    if k % 32:
        assert not (codes[:, -1] >> np.uint32(k % 32)).any()
    raw = lsh_hash_ref(torch.from_numpy(v), torch.from_numpy(h))
    np.testing.assert_array_equal(codes, raw.numpy().view(np.uint32))


@pytest.mark.parametrize("dim,k,seed", [(256, 12, 0), (128, 10, 0),
                                        (64, 40, 5)])
def test_hyperplane_lsh_matches_reference(dim, k, seed):
    a = JaxLSH(dim, k, seed)
    b = HyperplaneLSH(dim, k, seed, device="cpu")
    assert b.hyperplanes.dtype == np.float32
    np.testing.assert_array_equal(a.hyperplanes, b.hyperplanes)
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((200, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs[3] = 0.0
    np.testing.assert_array_equal(a.hash_packed(vecs), b.hash_packed(vecs))
    assert list(a.hash_ints(vecs)) == list(b.hash_ints(vecs))
    c = HyperplaneLSH.from_state(a.state_dict(), device="cpu")
    assert list(c.hash_ints(vecs)) == list(a.hash_ints(vecs))
    assert c.state_dict()["seed"] == seed


def test_kernel_refuses_wide_k():
    v = torch.zeros((4, 8))
    h = torch.zeros((8, ops.MAX_K + 1))
    with pytest.raises(ValueError, match=f"k <= {ops.MAX_K}"):
        ops.lsh_hash_cuda(v, h)
    assert ops.MAX_K == 512   # 8 groups of 64 hyperplanes


def _cu_int(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         source).group(1))


def _lsh_cover(grid, n, k, b):
    """How often ``lsh_hash_kernel`` computes each (row, plane) of block
    ``b``'s rows under ``grid``: the kernel's own mapping, tile by tile
    and thread by thread (thread t: plane group t // row_lanes, row lane
    t % row_lanes; rows lane + i * row_lanes of the tile, planes
    group * KP + j)."""
    kp, r = grid.planes_per_thread, grid.rows_per_thread
    lanes, rb = grid.row_lanes, grid.rows_per_block
    tile = r * lanes
    tid = np.arange(grid.plane_groups * lanes)
    g, rl = tid // lanes, tid % lanes
    rows = rl[:, None] + lanes * np.arange(r)[None, :]
    planes = g[:, None] * kp + np.arange(kp)[None, :]
    rows = np.repeat(rows, kp, axis=1).ravel()
    planes = np.tile(planes, (1, r)).ravel()
    begin, end = b * rb, min(n, (b + 1) * rb)
    cover = np.zeros((end - begin, k), np.int32)
    for t0 in range(begin, end, tile):
        ok = (t0 + rows < end) & (planes < k)
        np.add.at(cover, (t0 - begin + rows[ok], planes[ok]), 1)
    return cover


@pytest.mark.parametrize("n", [1, 5, 64, 300, 2501, 12510, 30189, 100000,
                               1 << 22])
@pytest.mark.parametrize("k,d", [(1, 256), (10, 128), (12, 256), (13, 64),
                                 (33, 259), (64, 256), (128, 256),
                                 (200, 64), (512, 256), (64, 1024)])
def test_lsh_grid_computes_every_code_bit_once(n, k, d):
    """Every (row, plane) is computed by exactly one thread, in one
    launch: a thread's planes are one group of at most KP, its
    accumulators at most 64; the block within its thread limit and the
    SM's shared memory; the kernel instantiated for the split.  The
    features stream 32 at a time, so the grid is the same at every d."""
    for sms in (1, 132):
        grid = common.lsh_grid(n, k, sms)
        kp, r, g = (grid.planes_per_thread, grid.rows_per_thread,
                    grid.plane_groups)
        assert (kp, r) in common.LSH_KERNELS
        assert r * kp <= 64
        assert g == cdiv(k, kp)          # no idle group, none missing
        threads = g * grid.row_lanes     # and a producer warp
        assert 1 <= threads <= common.lsh_max_threads(kp, r) - 32
        assert common.lsh_smem_bytes(grid, k) <= common.SMEM_MAX
        assert grid.stages in common.LSH_STAGES
        tile = r * grid.row_lanes   # whole TMA boxes of rows
        assert tile <= common.LSH_BOX or tile % common.LSH_BOX == 0
        blocks = cdiv(n, grid.rows_per_block)
        assert (blocks - 1) * grid.rows_per_block < n
        # every block where that is small, else the first and the last
        walk = range(blocks) if n * k <= 1 << 22 else sorted({0, blocks - 1})
        for b in walk:
            if grid.rows_per_block * k <= 1 << 22:
                assert (_lsh_cover(grid, n, k, b) == 1).all()


def test_lsh_grid_at_the_paths_shapes():
    # the query encoding: 64 queries over 64 blocks (64 SMs, each a
    # consumer warp and the producer warp), each query's planes split 8
    # ways
    g = common.lsh_grid(64, 64, 132)
    assert cdiv(64, g.rows_per_block) >= 64
    assert g.plane_groups == 8 and g.row_lanes == 1
    # the main path's build and a growth round: one tile a block, about
    # one block a SM
    for n in (12510, 2501):
        g = common.lsh_grid(n, 12, 132)
        assert cdiv(n, g.rows_per_block) == 132
        assert g.rows_per_block <= g.rows_per_thread * g.row_lanes
    # 2^22 rows: one block a SM walking its rows tile by tile
    g = common.lsh_grid(1 << 22, 12, 132)
    assert cdiv(1 << 22, g.rows_per_block) == 132
    assert g.rows_per_block > g.rows_per_thread * g.row_lanes
    assert g.rows_per_thread > 1
    # above 64 planes a tile's plane groups share its rows in one block
    g = common.lsh_grid(12510, 128, 132)
    assert g.planes_per_thread * g.plane_groups >= 128


def test_lsh_constants_match_the_source():
    """The Python grid's limits are the kernel's: instantiations, thread
    tiers, shared memory, stages, the TMA boxes; the launcher's C
    signature has the arguments the wrapper passes."""
    source = (CSRC_DIR / "lsh_hash.cu").read_text()
    assert _cu_int(source, "kMaxK") == ops.MAX_K
    assert _cu_int(source, "kSmemMax") == common.SMEM_MAX
    assert _cu_int(source, "kMaxStages") >= max(common.LSH_STAGES)
    assert _cu_int(source, "kChunk") == common.LSH_CHUNK
    assert _cu_int(source, "kBoxRows") == _cu_int(source, "kBoxPlanes") \
        == common.LSH_BOX
    assert _cu_int(source, "kAlign") == common.LSH_ALIGN
    insts = set(re.findall(r"lsh_hash_kernel<(\d+), (\d+)>", source))
    assert insts == {(str(kp), str(r)) for kp, r in common.LSH_KERNELS}
    assert "return r * kp <= 8 ? 1024 : r * kp <= 32 ? 512 : " \
        "r * kp <= 64 ? 320 : 256;" in source
    assert [common.lsh_max_threads(kp, 1) for kp in (8, 12)] == [1024, 512]
    assert common.lsh_max_threads(8, 8) == 320
    # the mbarriers (full[] and empty[]) fit the first aligned part
    assert 16 * _cu_int(source, "kMaxStages") <= common.LSH_ALIGN
    launcher = source[source.index('extern "C" int lsh_hash_launch('):]
    params = launcher[:launcher.index(")")].split(",")
    assert len(params) == len(ops._SIGNATURES["lsh_hash_launch"][0])
    assert len(params) == 7 + len(common.LshGrid._fields)


@pytest.mark.parametrize("n,k,d", [(12510, 12, 256), (64, 64, 256),
                                   (30189, 64, 256), (1 << 22, 12, 256),
                                   (0, 12, 256), (7, 200, 259)])
def test_lsh_wrapper_hands_the_grid_to_one_launch(monkeypatch, n, k, d):
    """The wrapper's arguments, in the order of the C entry point's
    ctypes signature (the kernel runs only on the card): the grid of
    ``lsh_grid``, one launch counted, nothing allocated but the codes."""
    v = torch.zeros((n, d))
    h = torch.zeros((d, k))
    seen, allocs = [], []

    class Lib:
        def lsh_hash_launch(self, *args):
            seen.append(args)
            return 0

    empty = torch.empty

    def recording_empty(*args, **kwargs):
        allocs.append((tuple(args[0]), kwargs.get("dtype")))
        return empty(*args, **kwargs)

    monkeypatch.setattr(ops, "load_kernel", lambda name, sigs: Lib())
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(torch, "empty", recording_empty)
    before = ops.launch_count()
    out = ops.lsh_hash_cuda(v, h)
    assert allocs == [((n, cdiv(k, 32)), torch.int32)]
    assert out.shape == (n, cdiv(k, 32))
    if n == 0:
        assert not seen and ops.launch_count() == before
        return
    assert ops.launch_count() == before + 1
    (args,) = seen
    assert len(args) == len(ops._SIGNATURES["lsh_hash_launch"][0])
    assert args[3:] == (n, d, k, *common.lsh_grid(n, k, 132), None)


@pytest.mark.parametrize("variant", ["full", "loads_only", "no_rows",
                                     "empty", "prologue"])
def test_lsh_breakdown_switches_apply_to_the_shipped_source(variant):
    """Each instrumented copy the breakdown tool builds is the kernel
    source with exactly its switches applied."""
    source = (CSRC_DIR / "lsh_hash.cu").read_text()
    switches = breakdown.VARIANTS[variant]
    copy = instrumented_source(source, breakdown.SWITCHES, switches)
    assert (copy == source) == (not switches)
    for name in switches:
        assert breakdown.SWITCHES[name][1] in copy
