"""chip_smoke.py's vjp_zeros, on the CPU: plane_bilinear_vjp's point gradient
is held exactly to the tent's zeros (exact-integer pixel coordinates, points
outside [0, 1]), and a zero on one side alone at a live point passes only as
a float32 cancellation, within the rounding bound of the sum over channels."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from lidar4d_tpu_torch.ops import plane_onehot as po  # noqa: E402


def _inputs(seed=0, p=3, c=8, h=8, w=64, n=3000):
    rng = np.random.default_rng(seed)
    grid = torch.tensor(rng.uniform(0.5, 1.5, (p, c, h, w)), dtype=torch.float32)
    pts = torch.tensor(rng.uniform(-0.05, 1.05, (p, n, 2)), dtype=torch.float32)
    pts[:, :w, 0] = torch.arange(w) / (w - 1)            # exact integer u, borders included
    pts[:, :h, 1] = torch.arange(h) / (h - 1)
    pts[0, w, 0] = float("nan")
    cot = torch.tensor(rng.standard_normal((p, c, n)), dtype=torch.float32)
    return grid, pts, cot


def test_plain_against_itself_and_its_float64_oracle():
    grid, pts, cot = _inputs()
    want = po.plane_bilinear_vjp_plain(grid, pts, cot)[1]
    wide = po.plane_bilinear_vjp_plain(grid.double(), pts, cot.double())[1]
    assert (want == 0).sum() > 2 * 64
    assert cs.vjp_zeros(grid, pts, cot, want.clone(), want) == 0
    assert cs.vjp_zeros(grid, pts, cot, want, wide) == 0


def test_a_cancellation_at_a_live_point_is_counted():
    grid, pts, cot = _inputs(1)
    want = po.plane_bilinear_vjp_plain(grid, pts, cot)[1]
    got = want.clone()
    live = (want != 0).nonzero()[:2].tolist()
    got[tuple(live[0])] = 0.0                             # the kernel's sum cancelled
    want[tuple(live[0])] = 3e-5
    want[tuple(live[1])] = 0.0                            # the plain version's sum cancelled
    got[tuple(live[1])] = -2e-6
    assert cs.vjp_zeros(grid, pts, cot, got, want) == 2


@pytest.mark.parametrize("fault", ["nonzero where the tent's is zero",
                                   "zero at a live point beyond rounding"])
def test_a_wrong_zero_pattern_raises(fault):
    grid, pts, cot = _inputs(2)
    want = po.plane_bilinear_vjp_plain(grid, pts, cot)[1]
    got = want.clone()
    if fault.startswith("nonzero"):
        got[0, 0, 0] = 1e-7                               # u = 0: the tent's subgradient is 0
    else:
        i = tuple((want.abs() > 1.0).nonzero()[0].tolist())
        got[i] = 0.0
    with pytest.raises(AssertionError, match="plane_bilinear_vjp"):
        cs.vjp_zeros(grid, pts, cot, got, want)
