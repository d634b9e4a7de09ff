"""LiDAR4D composed neural field: 4D hash + planes + flow + MLP heads.

Port of `lidar4d_tpu/models/lidar4d.py`. One function per query (`density`,
`attribute`, `flow`) over an explicit parameter tree with the reference's
layouts, kept so that a JAX tree carried over by `interop` plugs in as is.
The reference's behaviour is kept, quirks included: frame index
floor(t*(F-1)+0.5), neighbour times (frame±1)/num_frames (the reference's
/num_frames), t2 clamped to [0, 1], has_next/has_prev masking, and the
0.5/0.25/0.25 fusion of the dynamic features with the flow-warped
neighbours. Scalar time arithmetic runs in float32 on the host.
"""

from dataclasses import dataclass

import numpy as np
import torch

from lidar4d_tpu_torch.interop import tree_map, tree_to_torch
from lidar4d_tpu_torch.models.flow_field import FlowField
from lidar4d_tpu_torch.models.hash_field import HashGrid4D
from lidar4d_tpu_torch.models.planes_field import Planes4D
from lidar4d_tpu_torch.models.unet import UNet
from lidar4d_tpu_torch.ops._cuda import resolve_device
from lidar4d_tpu_torch.ops.hash_onehot import FACT_MAX_ROWS, onehot_eligible
from lidar4d_tpu_torch.ops.mlp import apply_mlp, init_mlp
from lidar4d_tpu_torch.ops.trunc_exp import trunc_exp


def frequency_encode(x, degree=12):
    """tcnn 'Frequency' encoding: sin/cos of 2^k * pi * x -> [N, d*degree*2]."""
    outs = []
    for k in range(degree):
        s = (2.0 ** k) * np.pi
        outs.append(torch.sin(s * x))
        outs.append(torch.cos(s * x))
    return torch.cat(outs, dim=-1)


@dataclass(frozen=True)
class LiDAR4DConfig:
    min_resolution: int = 32
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels_plane: int = 4
    n_features_per_level_plane: int = 8
    plane_hash_scales: int = 0
    plane_hash_log2: int = 11
    n_levels_hash: int = 8
    n_features_per_level_hash: int = 4
    log2_hashmap_size: int = 19
    hash_size_dynamic: tuple = (15, 13, 13)
    num_layers_flow: int = 3
    hidden_dim_flow: int = 64
    flow_n_levels: int = 8
    flow_n_features: int = 8
    flow_log2_hashmap_size: int = 18
    flow_base_resolution: int = 32
    flow_max_resolution: int = 8192
    num_layers_sigma: int = 2
    hidden_dim_sigma: int = 64
    geo_feat_dim: int = 15
    num_layers_lidar: int = 3
    hidden_dim_lidar: int = 64
    out_lidar_dim: int = 2
    num_frames: int = 51
    bound: float = 1.0
    view_degree: int = 12
    near_lidar: float = 0.01
    far_lidar: float = 0.81
    density_scale: float = 1.0
    active_sensor: bool = False
    flow_warp: bool = True


class LiDAR4DField:
    """The composed field on one device (`device="cuda"` unless told otherwise)."""

    def __init__(self, cfg: LiDAR4DConfig = LiDAR4DConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def planes_encoder(self) -> Planes4D:
        c = self.cfg
        return Planes4D(
            output_dim=c.n_features_per_level_plane,
            resolution=(c.min_resolution,) * 3 + (c.time_resolution,),
            multiscale_res=tuple(2 ** n for n in range(c.n_levels_plane)),
            hash_scales=c.plane_hash_scales,
            hash_log2=c.plane_hash_log2,
        )

    @property
    def hash_encoder(self) -> HashGrid4D:
        c = self.cfg
        return HashGrid4D(
            base_resolution=c.base_resolution,
            max_resolution=c.max_resolution,
            time_resolution=c.time_resolution,
            n_levels=c.n_levels_hash,
            n_features_per_level=c.n_features_per_level_hash,
            log2_hashmap_size=c.log2_hashmap_size,
            hash_size_dynamic=tuple(c.hash_size_dynamic),
        )

    @property
    def flow_net(self) -> FlowField:
        c = self.cfg
        return FlowField(
            input_dim=4,
            num_layers=c.num_layers_flow,
            hidden_dim=c.hidden_dim_flow,
            use_grid=True,
            n_levels=c.flow_n_levels,
            n_features_per_level=c.flow_n_features,
            log2_hashmap_size=c.flow_log2_hashmap_size,
            base_resolution=c.flow_base_resolution,
            max_resolution=c.flow_max_resolution,
        )

    @property
    def unet(self) -> UNet:
        return UNet(in_channels=3, out_channels=1)

    @property
    def in_onehot_window(self) -> bool:
        """Whether every hash table of the field (static and the three
        dynamic planes) is within the reference's one-hot window,
        FACT_MAX_ROWS rows a level: its trainer and its Simulator render such
        a field in 16,384-ray chunks and any other in 4,096
        (`renderer.frame_chunk`)."""
        enc = self.hash_encoder
        specs = [enc.static_spec] + [enc.dynamic_spec(p) for p in range(3)]
        return all(onehot_eligible(s, FACT_MAX_ROWS) for s in specs)

    @property
    def sigma_input_dim(self) -> int:
        return self.planes_encoder.n_output_dims + self.hash_encoder.n_output_dims

    @property
    def view_dim(self) -> int:
        return 3 * self.cfg.view_degree * 2

    def init(self, seed: int = 0):
        """Seeded parameters (numpy Generator) on the field's device.

        Same distributions as the reference's init, not the same numbers:
        a JAX tree carried over by `interop.params_from_jax` gives those.
        """
        c = self.cfg
        rng = np.random.default_rng(seed)
        lidar_in = self.view_dim + c.geo_feat_dim
        head = [lidar_in] + [c.hidden_dim_lidar] * (c.num_layers_lidar - 1) + [1]
        tree = {
            "planes": self.planes_encoder.init(rng),
            "hash": self.hash_encoder.init(rng),
            "flow": self.flow_net.init(rng),
            "sigma": init_mlp(
                rng,
                [self.sigma_input_dim] + [c.hidden_dim_sigma] * (c.num_layers_sigma - 1)
                + [1 + c.geo_feat_dim],
            ),
            "intensity": init_mlp(rng, head),
            "raydrop": init_mlp(rng, head),
            "unet": self.unet.init(rng),
        }
        return tree_to_torch(tree, self.device)

    # ------------------------------------------------------------------ flow
    def flow(self, params, x, t):
        """x: [N, 3] in [-bound, bound] -> dict(forward [N, 3], backward [N, 3])."""
        c = self.cfg
        x01 = (x + c.bound) / (2 * c.bound)
        out = self.flow_net(params["flow"], x01, t)
        return {"forward": out[:, :3], "backward": out[:, 3:]}

    # --------------------------------------------------------------- density
    def density(self, params, x, t):
        """x: [N, 3] in [-bound, bound]; t: scalar in [0, 1].

        Returns dict(sigma [N], geo_feat [N, geo_feat_dim]).
        """
        c = self.cfg
        x01 = (x + c.bound) / (2 * c.bound)
        t = np.float32(t)
        frame_idx = int(np.floor(t * np.float32(c.num_frames - 1) + np.float32(0.5)))

        hash_s = self.hash_encoder.forward_static(params["hash"], x01)
        t_col = torch.full((x01.shape[0], 1), float(t), dtype=x01.dtype, device=x01.device)
        plane_s = self.planes_encoder.forward_static(
            params["planes"], torch.cat([x01, t_col], dim=-1))

        if c.flow_warp:
            flow = self.flow_net(params["flow"], x01, t)
            t1 = np.float32(frame_idx + 1.0) / np.float32(c.num_frames)
            t2 = np.clip(np.float32(frame_idx - 1.0) / np.float32(c.num_frames), 0.0, 1.0)
            xs = torch.stack([x01, x01 + flow[:, :3], x01 + flow[:, 3:]])
            ts = (t, np.float32(t1), np.float32(t2))
            # the hash encoder's warped variants are the reference's no-grad
            # neighbour lookups: given without the flow net's graph, variant
            # 0's coordinates need a gradient only where x does, and an
            # unfused encode above the factorized window keeps its kernel
            # (hash_encode_auto) instead of the x-differentiable gather
            hash_d, hash_d1, hash_d2 = self.hash_encoder.forward_dynamic_multi(
                params["hash"], torch.cat([x01[None], xs[1:].detach()]), ts)
            # coord_grad_lead=1: variant 0's coordinates are ray positions;
            # the warped variants keep their coordinate gradient, the flow
            # net's only gradient path through the planes
            plane_d, plane_d1, plane_d2 = self.planes_encoder.forward_dynamic_scalar_t_multi(
                params["planes"], xs, ts, coord_grad_lead=1)
            # has_next / has_prev: the reference masks with 0/1 weights
            if frame_idx >= c.num_frames - 1:
                hash_d1, plane_d1 = hash_d, plane_d
            if frame_idx <= 0:
                hash_d2, plane_d2 = hash_d, plane_d
            plane_d = 0.5 * plane_d + 0.25 * (plane_d1 + plane_d2)
            hash_d = 0.5 * hash_d + 0.25 * (hash_d1 + hash_d2)
        else:
            hash_d = self.hash_encoder.forward_dynamic(params["hash"], x01, t)
            plane_d = self.planes_encoder.forward_dynamic_scalar_t(params["planes"], x01, t)

        features = torch.cat([plane_s, plane_d, hash_s, hash_d], dim=-1)
        h = apply_mlp(params["sigma"], features)
        return {"sigma": trunc_exp(h[:, 0]), "geo_feat": h[:, 1:]}

    # ------------------------------------------------------------- attribute
    def attribute(self, params, d, geo_feat):
        """d: [N, 3] ray dirs in [-1, 1]; geo_feat [N, G] -> [N, 2] =
        (raydrop, intensity) after sigmoid."""
        d01 = (d + 1.0) / 2.0
        h = torch.cat([frequency_encode(d01, self.cfg.view_degree), geo_feat], dim=-1)
        intensity = torch.sigmoid(apply_mlp(params["intensity"], h)[:, 0])
        raydrop = torch.sigmoid(apply_mlp(params["raydrop"], h)[:, 0])
        return torch.stack([raydrop, intensity], dim=-1)

    # ------------------------------------------------ optimizer group labels
    def param_group_labels(self, params):
        """Tree of labels beside `params` (reference `param_group_labels`):
        encoders "base" (lr), heads and flow net "head" (0.1 lr), U-Net
        "unet" (frozen: trained in the refine stage)."""
        group = {"planes": "base", "hash": "base", "flow": "head", "sigma": "head",
                 "intensity": "head", "raydrop": "head", "unet": "unet"}
        return {k: tree_map(lambda _, g=group[k]: g, v) for k, v in params.items()}
