"""Loss criteria and the composite training-loss config.

Port of `lidar4d_tpu/train/losses.py`: the elementwise criteria
(l1 / mse / bce-with-logits / huber / cos, all without reduction), the
`LossConfig` knobs with the reference CLI's names and defaults, and the
Sobel kernels with a 3x3 'same' convolution for the patch gradient loss.
"""

from dataclasses import dataclass

import torch


def l1(pred, gt):
    return torch.abs(pred - gt)


def mse(pred, gt):
    return (pred - gt) ** 2


def bce_with_logits(pred, gt):
    # torch BCEWithLogitsLoss(reduction='none'), written as the reference writes it
    return torch.clamp(pred, min=0) - pred * gt + torch.log1p(torch.exp(-torch.abs(pred)))


def bce(pred, gt, eps=1e-7):
    p = torch.clamp(pred, eps, 1 - eps)
    return -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))


def huber(delta):
    def fn(pred, gt):
        err = torch.abs(pred - gt)
        return torch.where(err < delta, 0.5 * err ** 2, delta * (err - 0.5 * delta))

    return fn


def cosine_similarity(pred, gt, axis=-1, eps=1e-8):
    num = torch.sum(pred * gt, dim=axis)
    den = torch.clamp(torch.linalg.norm(pred, dim=axis) * torch.linalg.norm(gt, dim=axis),
                      min=eps)
    return num / den


def elementwise_loss(name, scale=1.0):
    """Resolve a criterion name (reference `elementwise_loss`)."""
    if name == "l1":
        return l1
    if name == "mse":
        return mse
    if name == "bce":
        return bce_with_logits
    if name == "huber":
        return huber(0.2 * scale)
    if name == "cos":
        return cosine_similarity
    raise ValueError(f"unknown loss {name}")


@dataclass(frozen=True)
class LossConfig:
    """Training-loss knobs; names and defaults are the reference's."""

    depth_loss: str = "l1"
    depth_grad_loss: str = "l1"
    intensity_loss: str = "mse"
    raydrop_loss: str = "mse"
    flow_loss: bool = True
    grad_loss: bool = True
    urf_loss: bool = False
    alpha_d: float = 1.0
    alpha_i: float = 0.1
    alpha_r: float = 0.01
    alpha_grad: float = 0.1
    alpha_grad_norm: float = 0.1
    alpha_spatial: float = 0.1
    alpha_tv: float = 0.1
    grad_norm_smooth: bool = False
    spatial_smooth: bool = False
    tv_loss: bool = False
    sobel_grad: bool = False
    smooth_factor: float = 0.2
    scale: float = 0.01
    num_frames: int = 51
    iters: int = 30000


def sobel_kernels(device="cpu"):
    gx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=device)
    gy = torch.tensor([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], device=device)
    return gx, gy


def conv2d_same(img, kernel):
    """img [B, 1, H, W], kernel [3, 3] -> [B, 1, H, W]: a cross-correlation
    with zero padding 1 (the reference's 'SAME' conv), written as nine
    shifted multiply-adds in float32 so that no cuDNN TF32 path can reach it."""
    h, w = img.shape[2], img.shape[3]
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[dy, dx] * pad[:, :, dy:dy + h, dx:dx + w]
    return out
