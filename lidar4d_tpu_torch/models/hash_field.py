"""4D decomposed hash encoder: static 3D grid + time-indexed 2D plane grids.

Port of `lidar4d_tpu/models/hash_field.py`. Parameters are a dict of float32
tensors with the reference's layouts: `static` [rows, F] and `dynamic_p`
[time_resolution * rows_p, F] for the xy/xz/yz planes. A lookup at time t
blends the two adjacent time grids in TABLE space, then applies the Lagrange
"interpT" over num_basis feature chunks (folded into the table under
`hash_onehot.ONEHOT_VARIANT` "fact", after the encode under "classic").
"""

from dataclasses import dataclass

import numpy as np
import torch

from lidar4d_tpu_torch.ops import hash_onehot
from lidar4d_tpu_torch.ops.grid_sample import scalar_lerp_weights
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec, init_hash_table, lagrange_weights
from lidar4d_tpu_torch.ops.hash_onehot import (
    folded_eligible,
    hash_encode_auto,
    hash_encode_fact_multi_folded,
    hash_encode_interp_auto,
)

_PLANE_SELS = ((0, 1), (0, 2), (1, 2))  # xy, xz, yz


@dataclass(frozen=True)
class HashGrid4D:
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 19
    hash_size_dynamic: tuple = (15, 13, 13)  # xy gets the larger table
    num_basis: int = 4

    @property
    def static_spec(self) -> HashEncoderSpec:
        return HashEncoderSpec(
            n_dims=3,
            n_levels=self.n_levels,
            n_features=self.n_features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
        )

    def dynamic_spec(self, plane: int) -> HashEncoderSpec:
        return HashEncoderSpec(
            n_dims=2,
            n_levels=self.n_levels,
            n_features=self.n_features_per_level,
            log2_hashmap_size=self.hash_size_dynamic[plane],
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
        )

    @property
    def n_output_dims_static(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_output_dims_dynamic(self) -> int:
        return 3 * (self.n_levels * self.n_features_per_level // self.num_basis)

    @property
    def n_output_dims(self) -> int:
        return self.n_output_dims_static + self.n_output_dims_dynamic

    def init(self, rng: np.random.Generator):
        params = {"static": init_hash_table(rng, self.static_spec)}
        for p in range(3):
            params[f"dynamic_{p}"] = init_hash_table(
                rng, self.dynamic_spec(p), n_grids=self.time_resolution)
        return params

    def forward_static(self, params, x):
        """x: [N, 3] in [0, 1] -> [N, L*F]."""
        return hash_encode_auto(self.static_spec, params["static"], x)

    def _blended_table(self, params, plane, t):
        spec = self.dynamic_spec(plane)
        stack = params[f"dynamic_{plane}"].reshape(
            self.time_resolution, spec.n_rows, spec.n_features)
        i1, i2, w2 = scalar_lerp_weights(t, self.time_resolution)
        return (1.0 - w2) * stack[i1] + w2 * stack[i2]

    def forward_dynamic(self, params, x, t):
        """x: [N, 3] in [0, 1], t: scalar in [0, 1] -> [N, 3*L*F/B].

        Out-of-range t is clamped at the grid-index level (reference
        hash_field.py forward_dynamic).
        """
        x = torch.clamp(x, 0.0, 1.0)
        feats = []
        for p, sel in enumerate(_PLANE_SELS):
            tab = self._blended_table(params, p, t)
            feats.append(hash_encode_interp_auto(
                self.dynamic_spec(p), tab, x[:, list(sel)], t, self.num_basis))
        return torch.cat(feats, dim=-1)

    def forward_dynamic_multi(self, params, xs, ts, fused=None):
        """Dynamic encode of V time variants.

        xs: [V, N, 3] in [0, 1] (variants may be flow-warped); ts: V scalar
        times. Returns [V, N, 3*L*F/B], per variant equal to forward_dynamic.
        Variant 0 is differentiable; variants 1..V-1 are the reference's
        `torch.no_grad()` neighbour lookups (reference hash_field.py
        forward_dynamic_multi): they run without a graph, so neither the
        tables nor the warped coordinates (the flow net) get a gradient
        through them, and the one-hot NaN poison of their coordinates never
        runs.

        fused=None picks the reference's rule: the fused path (the folded
        encode of all V variants, one kernel launch per plane) under
        ONEHOT_VARIANT "fact" when every plane's spec is folded-eligible,
        else V `forward_dynamic` calls.
        """
        if fused is None:
            fused = hash_onehot.ONEHOT_VARIANT == "fact" and all(
                folded_eligible(self.dynamic_spec(p), self.num_basis) for p in range(3))
        if not fused:
            outs = [self.forward_dynamic(params, xs[0], ts[0])]
            with torch.no_grad():
                outs += [self.forward_dynamic(params, xs[v], t) for v, t in enumerate(ts) if v]
            return torch.stack(outs)
        x = torch.clamp(xs, 0.0, 1.0)
        ws = torch.from_numpy(
            np.stack([lagrange_weights(t, self.num_basis) for t in ts])).to(xs.device)
        feats = []
        for p, sel in enumerate(_PLANE_SELS):
            tabs = [self._blended_table(params, p, t) for t in ts]
            g = hash_encode_fact_multi_folded(
                self.dynamic_spec(p), tabs[0], torch.stack(tabs[1:]).detach(),
                x[:, :, list(sel)].contiguous(), ws)
            feats.append(torch.cat([g[:1], g[1:].detach()]))
        return torch.cat(feats, dim=-1)

    def __call__(self, params, x, t):
        return self.forward_static(params, x), self.forward_dynamic(params, x, t)
