"""chip_smoke.py's float32_mlps_sharing_relu_masks, on the CPU: the recording
run is the port's float32 MLP, bit for bit and in its gradients; the
replaying run differentiates the MLP on the recorded masks and counts the
pre-activations whose own sign differs."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from lidar4d_tpu_torch.models import flow_field, lidar4d  # noqa: E402
from lidar4d_tpu_torch.ops.mlp import apply_mlp  # noqa: E402

DIMS = (6, 5, 4, 2)


def _mlp(seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((i, o)), dtype=torch.float32, requires_grad=True)
            for i, o in zip(DIMS[:-1], DIMS[1:])]


def _x(seed, n=7):
    return torch.tensor(np.random.default_rng(seed).standard_normal((n, DIMS[0])),
                        dtype=torch.float32)


def _grads(out, params):
    return torch.autograd.grad(out.square().sum(), params)


def test_recording_run_is_the_float32_mlp():
    params, x = _mlp(0), _x(1)
    masks = []
    with cs.float32_mlps_sharing_relu_masks(masks, record=True) as relu:
        out = lidar4d.apply_mlp(params, x)
        assert flow_field.apply_mlp is lidar4d.apply_mlp
    ref = apply_mlp(params, x, dtype=torch.float32)
    assert torch.equal(out, ref)
    for g, r in zip(_grads(out, params), _grads(ref, params)):
        assert torch.equal(g, r)
    assert [tuple(m.shape) for m in masks[0]] == [(7, 5), (7, 4)]
    assert relu["flipped"] == 0 and relu["masked"] == 7 * (5 + 4)
    assert lidar4d.apply_mlp is apply_mlp and flow_field.apply_mlp is apply_mlp


def test_replaying_run_differentiates_on_the_recorded_masks():
    params, x = _mlp(2), _x(3)
    masks = []
    with cs.float32_mlps_sharing_relu_masks(masks, record=True):
        lidar4d.apply_mlp(params, x)
    y = -x                                  # every first-layer sign turns over
    with cs.float32_mlps_sharing_relu_masks(masks, record=False) as relu:
        out = lidar4d.apply_mlp(params, y)
    h, flipped = y, 0
    for li, w in enumerate(params):
        h = h @ w
        if li < len(params) - 1:
            flipped += int(((h > 0) != masks[0][li]).sum())
            h = h * masks[0][li]
    assert torch.equal(out, h)
    for g, r in zip(_grads(out, params), _grads(h, params)):
        assert torch.equal(g, r)
    assert relu["flipped"] == flipped > 0


@pytest.mark.parametrize("case", ["fewer calls", "other shape"])
def test_replaying_run_refuses_other_calls(case):
    params, x = _mlp(4), _x(5)
    masks = []
    with cs.float32_mlps_sharing_relu_masks(masks, record=True):
        lidar4d.apply_mlp(params, x)
        lidar4d.apply_mlp(params, x)
    with pytest.raises(AssertionError):
        with cs.float32_mlps_sharing_relu_masks(masks, record=False):
            lidar4d.apply_mlp(params, x if case == "fewer calls" else _x(5, n=3))
    assert lidar4d.apply_mlp is apply_mlp and flow_field.apply_mlp is apply_mlp
