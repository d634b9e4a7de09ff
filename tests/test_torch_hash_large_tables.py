"""Launch plans of the hash kernels' large-table routes, on the CPU.

In the paper's configuration (configs/kitti360_4950.txt at the CLI
defaults) the static hash (8 levels of 2^19 rows, F = 4, 67 MB), the flow
grid (F = 8, 2^18 rows a level, 60 MB) and the xy dynamic planes (2^15
rows, F = 4, 4.2 MB) have no level small enough for `hash_grid_bwd`'s
shared accumulator: they take its vector route. The static hash and the
flow grid are over the L2: their backward goes level-major, and
`hash_grid_fwd`'s tile path keeps at least HASH_FWD_L2_RESIDENT threads an
SM resident for them. These tests hold the route each of those specs
takes, and each flagship spec's (unchanged), and the plans' values at
their edges, to what the kernels assume. No card and no JAX needed.
"""

import re
from pathlib import Path

import pytest

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops import hash_onehot as ho
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132
H100_L2 = 50 * 1024 * 1024          # torch.cuda.get_device_properties(0).L2_cache_size
HOPPER_SMEM = 227 * 1024            # the most shared memory a block can take

# The paper's configuration: the specs of one reference step and their calls'
# point counts (1,024 rays x 768 samples; the flow loss's clouds).
STATIC = HashEncoderSpec(3, 8, 4, 19, 512, 32768)
FLOW = HashEncoderSpec(3, 8, 8, 18, 32, 8192)
XY = HashEncoderSpec(2, 8, 4, 15, 512, 32768)
FOLDED = HashEncoderSpec(2, 8, 1, 13, 512, 32768)     # xz / yz, F = 4 folded to F' = 1
STEP_POINTS = 1024 * 768
FRAME_POINTS = 4096 * 768                             # a render chunk's density call
# The flagship's specs (configs/bench_conf_phash111.txt's widths).
FLAGSHIP = [
    HashEncoderSpec(3, 6, 8, 11, 64, 2048),      # static hash
    HashEncoderSpec(3, 4, 2, 11, 16, 256),       # flow grid, folded
    HashEncoderSpec(2, 6, 2, 11, 64, 2048),      # dynamic plane 0, folded
    HashEncoderSpec(2, 6, 2, 10, 64, 2048),      # dynamic planes 1-2, folded
    HashEncoderSpec(2, 6, 8, 11, 64, 2048),      # classic dynamic plane 0
    HashEncoderSpec(3, 4, 8, 11, 16, 256),       # classic flow grid
    HashEncoderSpec(2, 1, 8, 11, 255, 255),      # hashed static plane
]


def _table_bytes(spec, n_tables=1):
    return n_tables * spec.n_rows * spec.n_features * 4


def _resident_threads(plan, spec):
    """Threads an SM holds of a tile launch of `spec` that gathers through
    L1, by the shared memory its carveout gives (what the occupancy
    calculator finds on the card)."""
    pitch = ho.hash_fwd_tile_pitch(spec.n_levels, spec.n_features)
    block = plan.threads * 4 * pitch + ho.HASH_FWD_BLOCK_RESERVE
    return int(plan.carveout * ho.HASH_FWD_SM_SMEM / 100 // block) * plan.threads


@pytest.mark.parametrize("spec,n,fwd,bwd", [
    (STATIC, STEP_POINTS, "tile over L2", "vector"),
    (STATIC, FRAME_POINTS, "tile over L2", "vector"),
    (FLOW, STEP_POINTS, "tile over L2", "vector"),
    (FLOW, FRAME_POINTS, "tile over L2", "vector"),
    (FLOW, 52_224, "gather over L2", "vector"),  # the flow loss's ground cloud
    (FLOW, 7_168, "gather over L2", "vector"),   # and its object cloud
    (XY, STEP_POINTS, "tile", "vector"),         # 4.2 MB: L2-resident
    (FOLDED, STEP_POINTS, "tile", "shared"),     # 2^13 x 1: the shared accumulator
], ids=lambda v: v if isinstance(v, (str, int)) else str(v))
def test_reference_routes(spec, n, fwd, bwd):
    assert ho.hash_fwd_plan(spec, n, 1, H100_L2)[1] == fwd
    assert ho.hash_bwd_launch(spec, 1, H100_L2).label == bwd


def test_reference_table_sizes():
    """The bytes the routes are chosen by: static 67 MB and flow 60 MB over
    half the L2, xy 4.2 MB under it; none of their levels fits even a whole
    227 KB of shared memory as a backward accumulator, only the folded
    xz / yz levels fit the 64 KB one."""
    assert [round(_table_bytes(s) / 1e6, 1) for s in (STATIC, FLOW, XY)] == [67.1, 59.9, 4.2]
    assert _table_bytes(XY) < ho.HASH_L2_SHARE * H100_L2 < _table_bytes(FLOW)
    for spec in (STATIC, FLOW, XY):
        assert min(spec.table_sizes) * spec.n_features * 4 > HOPPER_SMEM
        assert ho._smem_floats(spec) == 0
    assert ho._smem_floats(FOLDED) == 8192


def test_flow_grid_keeps_two_blocks_resident():
    """The flow grid's output tile (L x F = 64 floats, pitch 68: 70 KB a
    256-point block) leaves one block an SM beside HASH_FWD_L1_KEEP of L1;
    over the L2 the plan keeps two (512 threads), the static hash's three
    already. The carveout holds them and no more than fits."""
    under = ho.hash_fwd_launch(FLOW, STEP_POINTS)
    over = ho.hash_fwd_launch(FLOW, STEP_POINTS, over_l2=True)
    assert _resident_threads(under, FLOW) == 256 and _resident_threads(over, FLOW) == 512
    assert over == (0, ho.HASH_FWD_THREADS, True, 62, 1)
    assert ho.hash_fwd_launch(STATIC, STEP_POINTS, True) == ho.hash_fwd_launch(STATIC,
                                                                               STEP_POINTS)


@pytest.mark.parametrize("spec", FLAGSHIP, ids=str)
@pytest.mark.parametrize("n", [7_168, 131_072, 262_144, 4_194_304])
def test_flagship_routes_unchanged(spec, n):
    """Every flagship table is far under the L2: the forward keeps its tile /
    staged / gather plan, and the backward the shared accumulator, over
    HASH_BWD_WAVES waves of all levels at once."""
    plan, route = ho.hash_fwd_plan(spec, n, 3, H100_L2)
    assert plan == ho.hash_fwd_launch(spec, n) and route == plan.route
    assert not ho.tables_over_l2(spec, 3, H100_L2)
    bwd = ho.hash_bwd_launch(spec, 3, H100_L2)
    assert bwd == (ho._smem_floats(spec), "lanes", spec.n_levels * 3) and bwd.label == "shared"


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("levels", [1, 3, 8])
@pytest.mark.parametrize("n_tables", [1, 3])
def test_over_l2_threshold(d, f, levels, n_tables):
    """A call's tables are over the L2 one byte above HASH_L2_SHARE of it,
    counting all V variants' tables (V > 1 gets there sooner): the
    forward's route says so, and the backward goes level-major (one grid a
    variant) where no level fits its shared accumulator."""
    spec = HashEncoderSpec(d, levels, f, 22, 4096, 1 << 16)       # hashed levels only
    assert ho._smem_floats(spec) == 0
    nbytes = _table_bytes(spec, n_tables)
    l2_at = int(nbytes / ho.HASH_L2_SHARE)               # the tables are the share exactly
    assert ho.HASH_L2_SHARE * l2_at == nbytes
    assert not ho.tables_over_l2(spec, n_tables, l2_at)
    assert ho.tables_over_l2(spec, n_tables, l2_at - 2)
    assert not ho.hash_fwd_plan(spec, 1000, n_tables, l2_at)[1].endswith("over L2")
    assert ho.hash_fwd_plan(spec, 1000, n_tables, l2_at - 2)[1] == "gather over L2"
    assert ho.hash_bwd_launch(spec, n_tables, l2_at).grids == levels * n_tables
    assert ho.hash_bwd_launch(spec, n_tables, l2_at - 2).grids == n_tables


@pytest.mark.parametrize("levels,features", [(8, 8), (8, 4), (16, 8), (4, 8), (16, 2), (6, 8)])
@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, STEP_POINTS + 5, FRAME_POINTS])
def test_over_l2_residency_fits(levels, features, n):
    """Over the L2 the tile plan's resident blocks hold HASH_FWD_L2_RESIDENT
    threads where their tiles fit in the SM's shared memory (else as many
    as fit, at least one), and at least what HASH_FWD_L1_KEEP leaves; the
    gather path (N < HASH_FWD_MIN_POINTS, N = 0 included) is the same plan
    either way."""
    spec = HashEncoderSpec(3, levels, features, 22, 16, 4096)
    plan = ho.hash_fwd_launch(spec, n, over_l2=True)
    base = ho.hash_fwd_launch(spec, n)
    if not base.tile:
        assert plan == base
        return
    block = plan.threads * 4 * ho.hash_fwd_tile_pitch(levels, features) \
        + ho.HASH_FWD_BLOCK_RESERVE
    smem = plan.carveout * ho.HASH_FWD_SM_SMEM / 100
    assert plan.carveout >= base.carveout and block <= smem <= ho.HASH_FWD_SM_SMEM
    blocks = int(smem // block)
    want = min(-(-ho.HASH_FWD_L2_RESIDENT // plan.threads), ho.HASH_FWD_SM_SMEM // block)
    assert blocks >= want
    assert plan.carveout == base.carveout or blocks == want      # no more than the floor


@pytest.mark.parametrize("spec,f,route", [
    (STATIC, 4, "vector"), (FLOW, 8, "vector"), (XY, 4, "vector"),
    (HashEncoderSpec(3, 8, 2, 19, 512, 32768), 2, "lanes"),      # F = 2: scalar reductions
    (HashEncoderSpec(3, 8, 1, 20, 512, 32768), 1, "lanes"),      # F = 1
    (HashEncoderSpec(2, 8, 8, 16, 64, 4096), 8, "vector"),       # D = 2, F = 8
])
@pytest.mark.parametrize("cot_ptr,dtab_ptr", [(0, 0), (4096, 1 << 30), (4, 0), (0, 8),
                                              (16 * 7 + 4, 16)])
def test_vector_reduction_alignment(spec, f, route, cot_ptr, dtab_ptr):
    """The vector route adds a row's 4-feature chunk with one 16-byte
    reduction: it takes F = 4 or 8 (every level's offset x F x 4 bytes is a
    multiple of 16 then) and a cotangent and gradient that start 16-byte
    aligned; anything else keeps the scalar reductions, still level-major
    (no level of these specs fits the shared accumulator), level-major
    where the gradient is over the L2."""
    assert spec.n_features == f
    aligned = cot_ptr % 16 == 0 and dtab_ptr % 16 == 0
    want = route if aligned else "lanes"
    plan = ho.hash_bwd_launch(spec, 1, H100_L2, cot_ptr, dtab_ptr)
    over_l2 = _table_bytes(spec) > ho.HASH_L2_SHARE * H100_L2
    assert plan == (0, want, 1 if over_l2 else spec.n_levels)   # level-major over the L2
    assert plan.label == ("vector" if want == "vector" else "global")
    if plan.route == "vector":
        assert all(off * f * 4 % 16 == 0 for off in spec.level_offsets)


def test_backward_levers_off(monkeypatch):
    monkeypatch.setattr(ho, "HASH_BWD_VECTOR", False)
    assert ho.hash_bwd_launch(STATIC, 3, H100_L2) == (0, "lanes", 3)
    monkeypatch.setattr(ho, "HASH_BWD_LEVEL_MAJOR", False)
    assert ho.hash_bwd_launch(STATIC, 3, H100_L2) == (0, "lanes", STATIC.n_levels * 3)
    monkeypatch.setattr(ho, "HASH_BWD_VECTOR", True)
    assert ho.hash_bwd_launch(STATIC, 3, H100_L2) == (0, "vector", STATIC.n_levels * 3)


@pytest.mark.parametrize("n", [1, 767, 7_168, 52_224, STEP_POINTS, STEP_POINTS + 5])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("n_variants", [1, 3])
@pytest.mark.parametrize("bps", [1, 2, 4])
def test_level_major_grid_covers_every_point(n, f, n_variants, bps):
    """Level-major: each level's grid (and each variant's) is at most
    HASH_BWD_WAVES resident waves of the card on its own, so that the levels
    run one after another; every point has a group of F lanes, and every
    block has points."""
    groups = ho.HASH_BWD_THREADS // f
    plan = ho.hash_bwd_launch(HashEncoderSpec(3, 8, f, 20, 512, 32768), n_variants, H100_L2)
    assert plan.grids == n_variants
    run = _cuda.persistent_run(n, groups, plan.grids, ho.HASH_BWD_MIN_RUN, H100_SMS, bps,
                               ho.HASH_BWD_WAVES)
    blocks = -(-n // (groups * run))             # the kernel's grid.x, for each level
    assert run >= ho.HASH_BWD_MIN_RUN
    assert blocks * groups * run >= n
    assert (blocks - 1) * groups * run < n
    assert blocks * n_variants <= max(ho.HASH_BWD_WAVES * H100_SMS * bps, n_variants)


def test_route_numbers_match_the_cuda_source():
    src = (CSRC / "hash_grid_bwd.cu").read_text()
    m = re.search(r"enum Route \{ kLanes = (\d), kVector = (\d) \};", src)
    assert m and dict(zip(("lanes", "vector"), map(int, m.groups()))) == ho.HASH_BWD_ROUTES
