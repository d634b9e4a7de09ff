"""The bfloat16 twins' forward functions take their points in blocks of
TPU_CHUNK (`ops/hash_onehot.py`), which bounds their temporaries at a frame
render's point counts. Per point they compute the same, so a twin over many
blocks equals the same twin over one, bit for bit (port only, CPU)."""

import numpy as np
import pytest
import torch

from lidar4d_tpu_torch.ops import hash_onehot as ho
from lidar4d_tpu_torch.ops import plane_onehot as po
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec
from torch_threads import limit_under_xdist

limit_under_xdist()

N = 1000                          # points; blocks of 96 leave a ragged last one
SMALL = 96


def _twice(monkeypatch, fn, *args):
    whole = fn(*args)
    monkeypatch.setattr(ho, "TPU_CHUNK", SMALL)
    return whole, fn(*args)


@pytest.mark.parametrize("c, w", [(8, 64), (4, 300)])   # gather form, bf16 tent form
def test_plane_linear_tpu_blocks_bit_identical(monkeypatch, c, w):
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.normal(size=(3, c, w)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, (3, N)).astype(np.float32))
    assert po.tpu_linear_gathers(c, w) == (c == 8)
    whole, blocks = _twice(monkeypatch, po.plane_linear_tpu, grid, x)
    assert whole.shape == (3, N, c)
    assert torch.equal(whole, blocks)


def test_plane_bilinear_tpu_blocks_bit_identical(monkeypatch):
    rng = np.random.default_rng(1)
    grid = torch.from_numpy(rng.normal(size=(3, 8, 17, 33)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-0.1, 1.1, (3, N, 2)).astype(np.float32))
    whole, blocks = _twice(monkeypatch, po.plane_bilinear_tpu, grid, pts)
    assert whole.shape == (3, 8, N)
    assert torch.equal(whole, blocks)


@pytest.mark.parametrize("log2", [5, 11])       # bf16 one-hot form, exact gather form
def test_hash_grid_fwd_tpu_blocks_bit_identical(monkeypatch, log2):
    spec = HashEncoderSpec(n_dims=3, n_levels=3, n_features=8 if log2 == 11 else 2,
                           log2_hashmap_size=log2, base_resolution=4, max_resolution=32)
    rng = np.random.default_rng(2)
    tables = torch.from_numpy(rng.normal(size=(2, spec.n_rows, spec.n_features))
                              .astype(np.float32))
    xs = torch.from_numpy(rng.uniform(0, 1, (2, N, 3)).astype(np.float32))
    whole, blocks = _twice(monkeypatch, ho.hash_grid_fwd_tpu, spec, tables, xs)
    assert torch.equal(whole, blocks)
