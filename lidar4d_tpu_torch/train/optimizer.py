"""Grouped Adam with exponential learning-rate decay.

Port of `lidar4d_tpu/train/optimizer.py::make_optimizer`: Adam with
b = (0.9, 0.99), eps = 1e-15 (optax `scale_by_adam`: bias-corrected
moments, update m_hat / (sqrt(v_hat) + eps)); "base" leaves at lr, "head"
leaves at 0.1 lr, "unet" leaves frozen (no update and no Adam state: the
U-Net trains in the refine stage); the rate lr * 0.1 ** min(step / iters, 1)
read at the count before the step. Written by hand over the parameter
tree's leaves, updated in place (the reference returns a new tree; the
port reuses the parameter tensors to save memory). The scalar factors are
computed in float32 on the host, as optax computes them, and the decay
constants enter as Python floats, as in optax.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from lidar4d_tpu_torch.interop import tree_leaves

_MULT = {"base": 1.0, "head": 0.1}


def lr_schedule(lr, iters, step):
    """lr * 0.1 ** min(step / iters, 1), in float32."""
    frac = np.minimum(np.float32(step) / np.float32(iters), np.float32(1.0))
    return np.float32(lr) * np.float32(0.1) ** frac


@dataclass
class AdamState:
    mu: list = field(default_factory=list)      # one tensor per trained leaf
    nu: list = field(default_factory=list)
    count: int = 0


class GroupedAdam:
    """Adam over the leaves of a parameter tree, one label per leaf."""

    def __init__(self, lr, iters, labels, b1=0.9, b2=0.99, eps=1e-15):
        self.lr, self.iters = lr, iters
        self.b1, self.b2, self.eps = b1, b2, eps
        self.labels = tree_leaves(labels)
        unknown = sorted(set(self.labels) - {"base", "head", "unet"})
        if unknown:
            raise ValueError(f"unknown param-group labels {unknown}; expected base/head/unet")

    def init(self, params):
        trained = [p for p, lb in zip(tree_leaves(params), self.labels) if lb != "unet"]
        return AdamState([torch.zeros_like(p) for p in trained],
                         [torch.zeros_like(p) for p in trained], 0)

    @torch.no_grad()
    def step(self, params, grads, state: AdamState):
        """Update the leaves of `params` in place from `grads` (leaves in
        tree order, None for a leaf without gradient); advances `state`."""
        count = state.count + 1
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(count)
        rate = lr_schedule(self.lr, self.iters, state.count)
        k = 0
        for p, g, lb in zip(tree_leaves(params), grads, self.labels):
            if lb == "unet":
                continue
            mu, nu = state.mu[k], state.nu[k]
            k += 1
            if g is None:
                g = torch.zeros_like(p)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * (np.float32(_MULT[lb]) * -rate))
        state.count = count
        return state


def make_optimizer(lr, iters, labels):
    """The grouped Adam of the reference's `make_optimizer`."""
    return GroupedAdam(lr, iters, labels)
