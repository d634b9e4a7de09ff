"""K-Planes style factorized 4D feature planes.

Port of `lidar4d_tpu/models/planes_field.py`. The C(4,2) = 6 coordinate
planes of each scale split into a static group (xy, xz, yz) and a dynamic
group (xt, yt, zt); each group's features are multiplied and the scales
concatenated. Parameters are a list (scales) of lists (6 planes) of float32
tensors: dense planes [C, reso[c1], reso[c0]] (coordinate c0 on the last
axis), and — for the top `hash_scales` scales — a static plane stored as a
[2^hash_log2, C] 1-level 2D hash table.

Dense planes go through `plane_bilinear` (one launch per scale for a
group's three planes, forward and backward), hashed static planes through
`hash_grid` (one launch for the three planes). The static lookups' points
are ray positions, so they take no coordinate gradient. The dynamic planes
of a density query, whose time axis collapses at its scalar t, go through
`plane_linear`; the time-plane collapse stays in PyTorch, so autograd
carries the time planes' gradient through it. `forward_dynamic` and
`__call__` look the time planes up at a per-sample time through
`plane_bilinear(coord_grad=True)`, whose coordinate gradient
(`plane_bilinear_vjp`) trains a flow net through warped lookups.
"""

from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from lidar4d_tpu_torch.ops.grid_sample import scalar_lerp_weights
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec
from lidar4d_tpu_torch.ops.hash_onehot import hash_grid
from lidar4d_tpu_torch.ops.plane_onehot import plane_bilinear, plane_linear

_COO_COMBS = tuple(combinations(range(4), 2))
_STATIC_COMBS = tuple(c for c in _COO_COMBS if 3 not in c)
_DYNAMIC_COMBS = tuple(c for c in _COO_COMBS if 3 in c)
_STATIC_IDS = tuple(_COO_COMBS.index(c) for c in _STATIC_COMBS)
_DYNAMIC_IDS = tuple(_COO_COMBS.index(c) for c in _DYNAMIC_COMBS)


@dataclass(frozen=True)
class Planes4D:
    output_dim: int = 8
    resolution: tuple = (32, 32, 32, 8)  # x, y, z, t base resolutions
    multiscale_res: tuple = (1, 2, 4, 8)
    a: float = 0.1
    b: float = 0.5
    hash_scales: int = 0
    hash_log2: int = 11

    @property
    def n_output_dims(self) -> int:
        return self.output_dim * len(self.multiscale_res) * 2

    def _scale_reso(self, scale: int):
        return tuple(r * scale for r in self.resolution[:3]) + self.resolution[3:]

    def _static_hashed(self, scale_idx: int, reso) -> bool:
        """Top `hash_scales` scales with a cubic spatial resolution whose
        vertex grid exceeds the table (reference `_static_hashed`)."""
        if scale_idx < len(self.multiscale_res) - self.hash_scales:
            return False
        if len({reso[0], reso[1], reso[2]}) != 1:
            return False
        return reso[0] ** 2 > (1 << self.hash_log2)

    def _hash_spec(self, size: int) -> HashEncoderSpec:
        # base = size - 1: the hash corner grid matches the dense plane's
        # align_corners pixel grid
        return HashEncoderSpec(
            n_dims=2, n_levels=1, n_features=self.output_dim,
            log2_hashmap_size=self.hash_log2,
            base_resolution=size - 1, max_resolution=size - 1,
        )

    def init(self, rng: np.random.Generator):
        """Time planes ones, spatial planes U(a, b) (hashed ones as [rows, C])."""
        params = []
        for si, scale in enumerate(self.multiscale_res):
            reso = self._scale_reso(scale)
            hashed = self._static_hashed(si, reso)
            planes = []
            for comb in _COO_COMBS:
                shape = (self.output_dim, reso[comb[1]], reso[comb[0]])
                if 3 in comb:
                    w = np.ones(shape, np.float32)
                elif hashed:
                    spec = self._hash_spec(reso[comb[0]])
                    w = rng.uniform(self.a, self.b, (spec.n_rows, self.output_dim))
                else:
                    w = rng.uniform(self.a, self.b, shape)
                planes.append(w.astype(np.float32))
            params.append(planes)
        return params

    def _forward(self, params, pts, combs, comb_ids, coord_grad=True):
        """pts: [N, 4] in [0, 1] -> [N, C * n_scales]: per scale the product
        of the group's planes, scales concatenated (reference `_forward`).

        A group's dense planes of one shape run as one `plane_bilinear`
        launch; planes of unequal shapes (anisotropic resolutions) run one
        launch each. Hashed static planes run as one `hash_grid` launch; their
        points are ray positions (the kernel NaN-poisons a coordinate
        cotangent, as the reference's one-hot kernels do)."""
        outs = []
        for si, planes in enumerate(params):
            group = [planes[ci] for ci in comb_ids]
            pt = [pts[:, list(c)] for c in combs]
            if group[0].ndim == 2:
                reso = self._scale_reso(self.multiscale_res[si])
                spec = self._hash_spec(reso[combs[0][0]])
                feats = hash_grid(spec, torch.stack(group),
                                  torch.clamp(torch.stack(pt), 0.0, 1.0))  # [P, N, C]
                feats = feats.transpose(1, 2)
            elif len({g.shape for g in group}) == 1:
                feats = plane_bilinear(torch.stack(group), torch.stack(pt), coord_grad)
            else:
                feats = [plane_bilinear(g[None], q[None].contiguous(), coord_grad)[0]
                         for g, q in zip(group, pt)]
            acc = feats[0]
            for f in feats[1:]:
                acc = acc * f                                          # [C, N]
            outs.append(acc.T)
        return torch.cat(outs, dim=-1)

    def forward_static(self, params, pts):
        """pts: [N, 4] in [0, 1] -> [N, C * n_scales] (product over xy/xz/yz);
        pts are ray positions, so no coordinate gradient is taken."""
        return self._forward(params, pts, _STATIC_COMBS, _STATIC_IDS, coord_grad=False)

    def forward_dynamic(self, params, pts):
        """pts: [N, 4] in [0, 1] with a per-sample time pts[:, 3] ->
        [N, C * n_scales] (product over xt/yt/zt), differentiable in pts."""
        return self._forward(params, pts, _DYNAMIC_COMBS, _DYNAMIC_IDS)

    def forward_dynamic_scalar_t_multi(self, params, xyzs, ts, coord_grad_lead=0):
        """Dynamic (xt, yt, zt) features of V variants, each at a scalar time.

        Each [C, T, S] time plane collapses over T at the variant's t with the
        exact align_corners weights (in PyTorch, reference planes_field.py
        forward_dynamic_scalar_t_multi); the remaining 1-D lookups of all V x 3
        planes run as one `plane_linear` launch per scale.

        Args:
          xyzs: [V, N, 3] spatial coords in [0, 1]; ts: V scalar times.
          coord_grad_lead: the first `coord_grad_lead` variants get a zero
            coordinate gradient, and `plane_linear` skips that work for
            their 3 * coord_grad_lead tables (variant-major table axis).
        Returns:
          [V, N, C * n_scales].
        """
        v, n = xyzs.shape[0], xyzs.shape[1]
        c_dim = self.output_dim
        xs = xyzs.permute(0, 2, 1).reshape(v * 3, n).contiguous()
        outs = []
        for planes in params:
            g = torch.stack([planes[ci] for ci in _DYNAMIC_IDS])       # [3, C, T, S]
            t_res = g.shape[2]
            g_red = []
            for t in ts:
                y0, y1, ty = scalar_lerp_weights(t, t_res)
                g_red.append((1.0 - ty) * g[:, :, y0] + ty * g[:, :, y1])  # [3, C, S]
            g_red = torch.stack(g_red).reshape(v * 3, c_dim, g.shape[3])
            feats = plane_linear(g_red, xs, coord_grad_lead=3 * coord_grad_lead)
            feats = feats.reshape(v, 3, n, c_dim)
            outs.append(feats[:, 0] * feats[:, 1] * feats[:, 2])       # [V, N, C]
        return torch.cat(outs, dim=-1)

    def forward_dynamic_scalar_t(self, params, xyz, t):
        """Single-variant form: xyz [N, 3], scalar t -> [N, C * n_scales]."""
        return self.forward_dynamic_scalar_t_multi(params, xyz[None], [t])[0]

    def __call__(self, params, pts):
        return self.forward_static(params, pts), self.forward_dynamic(params, pts)
