"""Exponential moving average of parameters, torch_ema semantics.

Port of `lidar4d_tpu/train/ema.py`: the reference updates the EMA once per
epoch with the ramped decay min(decay, (1 + n) / (10 + n)); evaluation and
the refine stage read the shadow weights.
"""

from dataclasses import dataclass
from typing import Any

import torch

from lidar4d_tpu_torch.interop import tree_map


@dataclass
class EmaState:
    shadow: Any       # tree matching params
    num_updates: int


def ema_init(params) -> EmaState:
    return EmaState(shadow=tree_map(lambda p: p.detach().clone(), params), num_updates=0)


@torch.no_grad()
def ema_update(state: EmaState, params, decay=0.95) -> EmaState:
    n = state.num_updates + 1
    d = min(decay, (1.0 + n) / (10.0 + n))
    shadow = tree_map(lambda s, p: s - (1.0 - d) * (s - p), state.shadow, params)
    return EmaState(shadow=shadow, num_updates=n)


def ema_params(state: EmaState):
    return state.shadow
