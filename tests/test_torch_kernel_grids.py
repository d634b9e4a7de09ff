"""Host-side launch decisions of the persistent backward kernels, on the CPU.

`hash_grid_bwd` and `plane_linear_bwd` size their grids to the card and
choose their shared-memory layout in Python (`ops/hash_onehot.py`,
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
