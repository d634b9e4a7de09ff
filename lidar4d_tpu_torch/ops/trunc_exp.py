"""Truncated-gradient exponential.

Port of `lidar4d_tpu/ops/trunc_exp.py`: the forward is exp(x) in float32;
the backward clamps the input to [-15, 15] before the exp, so a large
density-head input cannot blow the gradient up.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
