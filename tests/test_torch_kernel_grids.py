"""Host-side launch decisions of the persistent kernels, on the CPU.

`hash_grid_fwd`, `hash_grid_bwd`, `plane_bilinear_bwd`, `plane_bilinear_vjp`
and `plane_linear_bwd` size their grids to the card and choose their
shared-memory layout in Python (`ops/hash_onehot.py`,
`ops/plane_onehot.py`); the kernels take the result as it is. These tests
hold those decisions to what the kernels assume, at the flagship shapes and
at the edges, and hold the Python twins of the kernels' layout constants to
the CUDA sources. No card and no JAX needed.
"""

import math
import re
from pathlib import Path

import pytest

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops import hash_onehot as ho
from lidar4d_tpu_torch.ops import plane_onehot as po
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132


def _constant(source, name):
    """The value of `constexpr int name = a * b ...;` in a CUDA source."""
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return math.prod(int(t) for t in m.group(1).split("*"))


def test_layout_constants_match_the_cuda_sources():
    assert _constant("hash_grid_bwd.cu", "kThreads") == ho.HASH_BWD_THREADS
    assert _constant("hash_grid_bwd.cu", "kSmemFloats") == ho.HASH_BWD_SMEM_FLOATS
    assert _constant("plane_linear_bwd.cu", "kThreads") == po.LIN_BWD_THREADS
    assert _constant("plane_linear_bwd.cu", "kSmemLimit") == po.LIN_BWD_SMEM_LIMIT
    assert _constant("hash_grid_fwd.cu", "kMaxThreads") == ho.HASH_FWD_MAX_THREADS
    assert _constant("hash_grid_fwd.cu", "kGatherThreads") == ho.HASH_FWD_GATHER_THREADS
    assert ho.HASH_FWD_THREADS <= ho.HASH_FWD_MAX_THREADS and ho.HASH_FWD_THREADS % 32 == 0
    assert _constant("hash_grid_fwd.cu", "kSmemLimit") == ho.HASH_FWD_SMEM_LIMIT
    assert _constant("hash_grid_fwd.cu", "kMaxLevels") == ho._MAX_LEVELS
    assert _constant("plane_bilinear_bwd.cu", "kThreads") == po.PLANE_BWD_THREADS
    assert _constant("plane_bilinear_bwd.cu", "kChunk") == po.PLANE_BWD_CHUNK
    assert _constant("plane_bilinear_bwd.cu", "kSmemLimit") == po.PLANE_BWD_SMEM_LIMIT
    assert _constant("plane_bilinear_vjp.cu", "kMaxThreads") == po.PLANE_VJP_MAX_THREADS
    assert _constant("plane_bilinear_vjp.cu", "kChunk") == po.PLANE_VJP_CHUNK
    assert _constant("plane_bilinear_vjp.cu", "kSmemLimit") == po.PLANE_VJP_SMEM_LIMIT
    assert po.PLANE_VJP_THREADS <= po.PLANE_VJP_MAX_THREADS and po.PLANE_VJP_THREADS % 32 == 0
    modes = re.search(r"enum Mode \{ kGlobal = (\d), kShared = (\d), kStaged = (\d) \};",
                      (CSRC / "plane_bilinear_vjp.cu").read_text())
    assert modes and tuple(map(int, modes.groups())) == (
        po.PLANE_VJP_GLOBAL, po.PLANE_VJP_SHARED, po.PLANE_VJP_STAGED)


@pytest.mark.parametrize("n,groups,grids,bps,waves,want", [
    (10**6, 64, 6, 3, 1, 237),      # one wave: 132 x 3 blocks over 6 levels, 66 each
    (10**6, 64, 6, 3, 2, 119),      # two waves: 132 each
    (1000, 64, 6, 3, 1, 4),         # a short call: fewer blocks, each group the minimum run
    (10**6, 64, 1000, 1, 1, 15625),  # at least one block a grid
])
def test_persistent_run(n, groups, grids, bps, waves, want):
    assert _cuda.persistent_run(n, groups, grids, 4, H100_SMS, bps, waves) == want


@pytest.mark.parametrize("n,levels,variants,features", [
    (262_144, 6, 1, 8),      # static hash, fine call
    (131_072, 6, 1, 8),      # static hash, coarse call
    (262_144, 1, 3, 8),      # hashed static plane, 3 variants
    (262_144, 4, 1, 2),      # flow grid, folded
    (262_144, 6, 1, 2),      # dynamic plane, folded, variant 0
    (7_168, 4, 1, 2),        # flow loss cloud
    (16_384, 4, 1, 2),       # flow loss ground
    (1, 6, 1, 8),
    (1 << 20, 2, 3, 1),
])
@pytest.mark.parametrize("bps", [1, 2, 3])
def test_hash_bwd_run_fills_its_waves_and_covers_every_point(n, levels, variants, features,
                                                             bps):
    groups = ho.HASH_BWD_THREADS // features
    run = _cuda.persistent_run(n, groups, levels * variants, ho.HASH_BWD_MIN_RUN, H100_SMS, bps,
                               ho.HASH_BWD_WAVES)
    blocks = -(-n // (groups * run))             # the kernel's grid.x
    most = ho.HASH_BWD_WAVES * H100_SMS * bps
    assert run >= ho.HASH_BWD_MIN_RUN
    assert blocks * groups * run >= n            # every point has a group
    assert (blocks - 1) * groups * run < n       # and every block has points
    assert blocks * levels * variants <= max(most, levels * variants)
    if run > ho.HASH_BWD_MIN_RUN:                # the shortest run that keeps to the waves
        assert -(-n // (groups * (run - 1))) > most // (levels * variants)


def test_hash_bwd_shared_levels():
    assert ho._smem_floats(HashEncoderSpec(3, 6, 8, 11, 64, 2048)) == 2048 * 8
    assert ho._smem_floats(HashEncoderSpec(3, 2, 8, 14, 4, 64)) == 125 * 8   # 2^14 x 8 is global
    assert ho._smem_floats(HashEncoderSpec(3, 1, 8, 14, 64, 64)) == 0


@pytest.mark.parametrize("c,w,copy", [
    (8, 32, True), (8, 256, True), (4, 2, True), (16, 64, True), (16, 1024, True),
    (8, 3632, True), (8, 3633, False), (16, 2048, False), (16, 3584, False),
])
def test_plane_linear_bwd_table_copy(c, w, copy):
    """The table copy goes to shared memory while it fits beside the
    [W][C] gradient in 227 KB; every flagship table (C = 8, W <= 256) does,
    and the gradient alone fits at every C * W the kernel takes (57344)."""
    assert po.plane_linear_bwd_table_copy(c, w) == copy
    assert c * w * 4 <= po.LIN_BWD_SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 255, 257, 131_072, 262_144, (1 << 20) + 3])
@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("bps", [1, 4, 8])
def test_plane_linear_bwd_run_fills_one_wave_and_covers_every_point(n, c, bps):
    groups = po.LIN_BWD_THREADS // c
    run = _cuda.persistent_run(n, groups, 9, po.LIN_BWD_MIN_RUN, H100_SMS, bps)
    blocks = -(-n // (groups * run))             # the kernel's grid.x
    assert run >= po.LIN_BWD_MIN_RUN
    assert blocks * groups * run >= n            # every point has a group
    assert (blocks - 1) * groups * run < n       # and every block has points
    assert blocks * 9 <= max(H100_SMS * bps, 9)
    if run > po.LIN_BWD_MIN_RUN:                 # the shortest run that keeps to one wave
        assert -(-n // (groups * (run - 1))) > H100_SMS * bps // 9


# plane_bilinear_bwd: the channel slice a block accumulates in shared memory.
@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (128, 128), (5, 17), (8, 256)])
def test_plane_bilinear_bwd_slice_fits_shared_memory(c, hw):
    """Every flagship plane (and every plane up to 128^2) takes the shared
    path, with a power-of-two slice of its channels that fits 227 KB, at
    every C the kernel takes; the flagship C = 8 planes keep at least three
    blocks an SM."""
    cb = po.plane_bilinear_bwd_slice(c, *hw)
    stride = po.plane_bilinear_bwd_stride(*hw)
    assert cb in (1, 2, 4, 8, 16) and c % cb == 0
    assert cb * stride * 4 <= po.PLANE_BWD_SMEM_LIMIT
    assert stride >= hw[0] * hw[1] + 4 and stride % 4 == 0
    assert stride % 32 != 0                       # channels start on different banks
    if c == 8:
        assert cb * stride * 4 <= po.PLANE_BWD_SMEM_LIMIT // 3


@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("hw", [(256, 256), (512, 512), (200, 300)])
def test_plane_bilinear_bwd_slice_global_above_the_limit(c, hw):
    """A plane whose one channel exceeds 227 KB takes the global path."""
    assert po.plane_bilinear_bwd_stride(*hw) * 4 > po.PLANE_BWD_SMEM_LIMIT
    assert po.plane_bilinear_bwd_slice(c, *hw) == 0


def test_plane_bilinear_bwd_slice_flagship():
    """C = 8: 32^2 with all 8 channels, 64^2 with 4, 128^2 with 1 (about
    65 KB each); with the whole 227 KB for one block, 64^2 x 8 and 128^2 x 2."""
    assert [po.plane_bilinear_bwd_slice(8, r, r) for r in (32, 64, 128)] == [8, 4, 1]
    full = po.PLANE_BWD_SMEM_LIMIT
    assert [po.plane_bilinear_bwd_slice(8, r, r, full) for r in (32, 64, 128)] == [8, 8, 2]


@pytest.mark.parametrize("n", [1, 255, 131_072, 262_144, (1 << 20) + 3])
@pytest.mark.parametrize("c,hw", [(8, (32, 32)), (8, (64, 64)), (8, (128, 128)),
                                  (4, (128, 128)), (16, (32, 32)), (8, (256, 256))])
@pytest.mark.parametrize("bps", [1, 3])
def test_plane_bilinear_bwd_run_covers_every_point(n, c, hw, bps):
    cb = po.plane_bilinear_bwd_slice(c, *hw)
    lanes = cb or min(c, 8)
    groups = po.PLANE_BWD_THREADS // lanes
    grids = 3 * (c // lanes)
    run = po.plane_bilinear_bwd_run(n, c, cb, 3, H100_SMS, bps)
    blocks = -(-n // (groups * run))             # the kernel's grid.x
    assert run >= po.PLANE_BWD_MIN_RUN and run % po.PLANE_BWD_CHUNK == 0
    assert blocks * groups * run >= n            # every point has a group
    assert (blocks - 1) * groups * run < n       # and every block has points
    assert blocks * grids <= max(po.PLANE_BWD_WAVES * H100_SMS * bps, grids)


# hash_grid_fwd: which tables go to shared memory, tile or direct stores,
# points a tile.
_FWD_SPECS = [
    HashEncoderSpec(3, 6, 8, 11, 64, 2048),      # flagship static hash
    HashEncoderSpec(3, 4, 2, 11, 16, 256),       # flagship flow grid, folded
    HashEncoderSpec(2, 6, 2, 11, 64, 2048),      # flagship dynamic plane 0, folded
    HashEncoderSpec(2, 6, 2, 10, 64, 2048),      # flagship dynamic planes 1-2, folded
    HashEncoderSpec(2, 6, 8, 11, 64, 2048),      # classic dynamic plane 0
    HashEncoderSpec(3, 4, 8, 11, 16, 256),       # classic flow grid
    HashEncoderSpec(2, 1, 8, 11, 255, 255),      # hashed static plane
    HashEncoderSpec(3, 3, 4, 12, 4, 32),         # dense and hashed levels
    HashEncoderSpec(3, 2, 8, 14, 4, 64),         # a level too large for shared memory
    HashEncoderSpec(2, 2, 1, 8, 4, 8),           # F = 1
    HashEncoderSpec(3, 16, 2, 24, 16, 4096),     # 16 levels of KERNEL_MAX_ROWS rows
]


@pytest.mark.parametrize("spec", _FWD_SPECS, ids=str)
@pytest.mark.parametrize("n_points", [1, 7_168, 16_384, 131_072, 786_432, 4_194_304])
def test_hash_fwd_launch_fits_shared_memory(spec, n_points):
    plan = ho.hash_fwd_launch(spec, n_points)
    f, lf = spec.n_features, spec.n_output_dims
    one_sector = f % 4 == 0 and lf <= 8
    if n_points < ho.HASH_FWD_MIN_POINTS or one_sector:
        assert plan == (0, ho.HASH_FWD_GATHER_THREADS, False, -1, None)   # the gather path
        return
    assert plan.tile and plan.threads == ho.HASH_FWD_THREADS <= ho.HASH_FWD_MAX_THREADS
    tile_floats = plan.threads * ho.hash_fwd_tile_pitch(spec.n_levels, f)
    table = ho.hash_fwd_table_floats(spec)
    assert (plan.table_floats + tile_floats) * 4 <= ho.HASH_FWD_SMEM_LIMIT
    if (table + tile_floats) * 4 <= ho.HASH_FWD_SMEM_LIMIT:
        assert plan == (table, plan.threads, True, 100, ho.HASH_FWD_MIN_RUN)
        return
    # gathering through L1: the shared-memory share holds the resident
    # blocks that leave HASH_FWD_L1_KEEP bytes of L1, at least one
    assert plan.table_floats == 0 and plan.min_run == 1
    block = tile_floats * 4 + ho.HASH_FWD_BLOCK_RESERVE
    smem = plan.carveout * ho.HASH_FWD_SM_SMEM / 100
    step = ho.HASH_FWD_SM_SMEM / 100
    assert block <= smem < max(block, ho.HASH_FWD_SM_SMEM - ho.HASH_FWD_L1_KEEP) + step
    blocks = int(smem // block)
    assert blocks == 1 or ho.HASH_FWD_SM_SMEM - blocks * block >= ho.HASH_FWD_L1_KEEP - step


def test_hash_fwd_launch_flagship():
    """At the train step's and the render's point counts: the folded flow
    grid and dynamic planes stage their tables (16-96 KB); the static hash
    (384 KB) and the classic route's F = 8 dynamic planes and flow grid
    gather through L1, all of them through the output tile; the hashed
    static plane (one 32-byte sector a point) and the flow loss's 7,168
    cloud points take the gather path."""
    for n in (131_072, 262_144, 4_194_304):
        plans = [ho.hash_fwd_launch(spec, n) for spec in _FWD_SPECS[:7]]
        assert [bool(p.table_floats) for p in plans] == [False, True, True, True, False, False,
                                                         False]
        assert [p.tile for p in plans] == [True] * 6 + [False]
    assert ho.hash_fwd_launch(_FWD_SPECS[1], 7_168) == (0, 128, False, -1, None)
    assert ho.hash_fwd_launch(_FWD_SPECS[0], 262_144).carveout < 100


@pytest.mark.parametrize("levels,features,pitch", [
    (3, 8, 28), (6, 8, 52), (1, 8, 12), (6, 2, 12), (4, 2, 12), (2, 1, 4), (3, 4, 12),
    (1, 1, 4), (16, 8, 132)])
def test_hash_fwd_tile_pitch(levels, features, pitch):
    """The pitch of the kernel's tile_pitch(): eight neighbouring points'
    16-byte stores land on distinct banks (pitch = 4 mod 8)."""
    assert ho.hash_fwd_tile_pitch(levels, features) == pitch
    assert pitch % 8 == 4


@pytest.mark.parametrize("n", [1, 255, 131_072, 262_144, 4_194_304, (1 << 20) + 3])
@pytest.mark.parametrize("variants", [1, 3])
@pytest.mark.parametrize("bps,min_run", [(1, 2), (2, 2), (4, 1), (8, 1)])
def test_hash_fwd_run_covers_every_point(n, variants, bps, min_run):
    threads = ho.HASH_FWD_THREADS
    run = _cuda.persistent_run(n, threads, variants, min_run, H100_SMS, bps)
    blocks = -(-n // (threads * run))                # the kernel's grid.x
    assert run >= min_run
    assert blocks * threads * run >= n
    assert (blocks - 1) * threads * run < n
    assert blocks * variants <= max(H100_SMS * bps, variants)      # one resident wave


# plane_bilinear_vjp: where a block accumulates dG and reads the plane, and
# the persistent run.
@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("hw", [(8, 32), (8, 64), (8, 128), (8, 256), (5, 17)], ids=str)
def test_plane_bilinear_vjp_plan_fits_shared_memory(c, hw):
    """Every time plane [C, 8, S] (S <= 256, C in 4, 8, 16) and a ragged
    5 x 17 plane accumulate their whole gradient in shared memory; a staged
    plane fits beside it with PLANE_VJP_STAGE_BLOCKS blocks an SM and whole
    16-byte bulk copies; the L1 route's shared-memory share holds its
    resident blocks."""
    plan = po.plane_bilinear_vjp_plan(c, *hw)
    stride = po.plane_bilinear_bwd_stride(*hw)
    assert plan.stride == stride and stride % 32 != 0    # channels on different banks
    assert plan.mode in (po.PLANE_VJP_SHARED, po.PLANE_VJP_STAGED)
    smem = po.plane_bilinear_vjp_smem(c, plan.mode, stride)
    assert smem <= po.PLANE_VJP_SMEM_LIMIT
    assert po.plane_bilinear_vjp_smem(c, po.PLANE_VJP_SHARED, stride) == c * stride * 4
    if plan.mode == po.PLANE_VJP_STAGED:
        assert hw[0] * hw[1] % 4 == 0 and plan.carveout == 100
        assert smem == 2 * c * stride * 4 + 16
        assert po.PLANE_VJP_STAGE_BLOCKS * (smem + po.PLANE_VJP_BLOCK_RESERVE) \
            <= po.PLANE_VJP_SM_SMEM
    else:
        block = smem + po.PLANE_VJP_BLOCK_RESERVE
        share = plan.carveout * po.PLANE_VJP_SM_SMEM / 100
        assert 0 < plan.carveout <= 100 and share >= block
        blocks = int(share // block)
        assert blocks >= min(po.PLANE_VJP_SM_THREADS // po.PLANE_VJP_THREADS,
                             (po.PLANE_VJP_SM_SMEM - po.PLANE_VJP_L1_KEEP) // block)


@pytest.mark.parametrize("c,hw", [(4, (128, 128)), (8, (128, 128)), (16, (128, 128)),
                                  (16, (64, 64)), (8, (256, 256)), (4, (200, 300))], ids=str)
def test_plane_bilinear_vjp_plan_global_above_the_limit(c, hw):
    """A plane whose [C, H, W] gradient exceeds 227 KB takes the global path
    (no shared memory, the default share), as the 8-channel 128^2 plane of
    the card tests does."""
    plan = po.plane_bilinear_vjp_plan(c, *hw)
    assert c * po.plane_bilinear_bwd_stride(*hw) * 4 > po.PLANE_VJP_SMEM_LIMIT
    assert plan.mode == po.PLANE_VJP_GLOBAL and plan.carveout == -1
    assert po.plane_bilinear_vjp_smem(c, plan.mode, plan.stride) == 0


def test_plane_bilinear_vjp_plan_flagship(monkeypatch):
    """The flagship time planes [3, 8, 8, S]: the plane staged at S = 32, 64
    and 128 (16-66 KB a block, two blocks an SM), read through L1 at S = 256
    (a 64 KB accumulator; staged, 128 KB would leave one block an SM), with
    a share of 132 KB for two blocks and 96 KB of L1. Without staging every
    S reads through L1; with one block an SM allowed, S = 256 stages too."""
    modes = [po.plane_bilinear_vjp_plan(8, 8, s).mode for s in (32, 64, 128, 256)]
    assert modes == [po.PLANE_VJP_STAGED] * 3 + [po.PLANE_VJP_SHARED]
    assert po.plane_bilinear_vjp_plan(8, 8, 256).carveout == 58
    monkeypatch.setattr(po, "PLANE_VJP_STAGE", False)
    assert {po.plane_bilinear_vjp_plan(8, 8, s).mode for s in (32, 64, 128, 256)} == {
        po.PLANE_VJP_SHARED}
    monkeypatch.setattr(po, "PLANE_VJP_STAGE", True)
    monkeypatch.setattr(po, "PLANE_VJP_STAGE_BLOCKS", 1)
    assert po.plane_bilinear_vjp_plan(8, 8, 256).mode == po.PLANE_VJP_STAGED


@pytest.mark.parametrize("n", [1, 7, 262_144, 262_147])
@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("bps", [1, 2, 4])
def test_plane_bilinear_vjp_run_covers_every_point(n, c, bps):
    """Three planes: every point has a lane group, every block has points,
    runs are whole chunks, and the grid keeps to one resident wave."""
    groups = po.PLANE_VJP_THREADS // c
    run = po.plane_bilinear_vjp_run(n, c, 3, H100_SMS, bps)
    blocks = -(-n // (groups * run))             # the kernel's grid.x
    assert run >= po.PLANE_VJP_MIN_RUN and run % po.PLANE_VJP_CHUNK == 0
    assert blocks * groups * run >= n
    assert (blocks - 1) * groups * run < n
    assert blocks * 3 <= max(po.PLANE_VJP_WAVES * H100_SMS * bps, 3)
