"""Multiresolution hash-grid encoding (Instant-NGP style), plain PyTorch.

Port of `lidar4d_tpu/ops/hash_enc.py`. Per-level tables are concatenated
into one flat `[rows, F]` table; levels whose dense vertex grid fits the
hashmap budget index it directly (strided by `res + 1`), larger levels use
the NGP spatial hash

    h(v) = (v_0 * 1) xor (v_1 * 2654435761) xor (v_2 * 805459861)  mod T

with T a power of two. Torch has no general uint32 arithmetic, so the hash
runs in int64: the low 32 bits of an int64 product equal the uint32 product,
and `& (T - 1)` with T <= 2^32 keeps only those bits — the row indices are
bit-identical to the reference's uint32 arithmetic.

`hash_encode` here is the plain version of the CUDA kernel in
`ops/hash_onehot.py`; it gathers `[L * 2^d, N]` rows, so it is meant for the
CPU and for checking the kernel at moderate point counts. In the reference
`hash_encode` (with `row_offset`) and `hash_encode_blend` are XLA gathers,
not Pallas kernels, so they stay plain PyTorch on every device; they are
also the path `hash_encode_auto` takes where a caller needs the coordinate
gradient.
"""

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

# NGP spatial-hash primes (first coordinate is un-multiplied).
_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashEncoderSpec:
    """Static configuration of a multiresolution hash encoder. The derived
    sizes are computed once an instance (every kernel wrapper reads them at
    each call)."""

    n_dims: int = 3
    n_levels: int = 8
    n_features: int = 4
    log2_hashmap_size: int = 19
    base_resolution: int = 512
    max_resolution: int = 32768

    @cached_property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp2(np.log2(self.max_resolution / self.base_resolution) / (self.n_levels - 1))
        )

    @cached_property
    def resolutions(self):
        s = self.per_level_scale
        return tuple(
            int(np.round(self.base_resolution * (s ** l))) for l in range(self.n_levels)
        )

    @cached_property
    def table_sizes(self):
        """Rows per level: dense size if the vertex grid fits, else 2^log2."""
        cap = 1 << self.log2_hashmap_size
        sizes = []
        for res in self.resolutions:
            dense = (res + 1) ** self.n_dims
            sizes.append(dense if dense <= cap else cap)
        return tuple(sizes)

    @cached_property
    def level_offsets(self):
        offs, acc = [], 0
        for s in self.table_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @cached_property
    def n_rows(self) -> int:
        return sum(self.table_sizes)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features


def init_hash_table(rng: np.random.Generator, spec: HashEncoderSpec, n_grids: int = 1,
                    scale: float = 1e-4):
    """Uniform(-scale, scale) init (tiny-cuda-nn's default), as float32 numpy.

    Returns [n_grids * n_rows, F] (n_grids > 1 stacks time-indexed grids).
    """
    shape = (n_grids * spec.n_rows, spec.n_features)
    return rng.uniform(-scale, scale, shape).astype(np.float32)


@lru_cache(maxsize=None)
def _corner_bits(n_dims: int, device: torch.device):
    """[2^d, d] int64: bit k of corner c, the corner's offset along axis k."""
    return torch.tensor([[(c >> k) & 1 for k in range(n_dims)] for c in range(1 << n_dims)],
                        dtype=torch.int64, device=device)


def _level_indices(spec: HashEncoderSpec, x, level: int):
    """Corner rows + interpolation weights for one level.

    Args:
      x: [N, d] float32 in [0, 1].
    Returns:
      idx [2^d, N] int64 flat row indices (level offset included),
      wgt [2^d, N] float32 trilinear/bilinear weights.
    """
    d = spec.n_dims
    res = spec.resolutions[level]
    size = spec.table_sizes[level]
    off = spec.level_offsets[level]
    bits = _corner_bits(d, x.device)

    pos = x.float() * res
    x0f = torch.floor(pos)
    frac = pos - x0f
    cpos = torch.clamp(x0f.to(torch.int64)[None] + bits[:, None], 0, res)   # [C, N, d]
    if size == (res + 1) ** d:
        flat, stride = cpos[..., 0], 1
        for k in range(1, d):
            stride *= res + 1
            flat = flat + cpos[..., k] * stride
    else:
        acc = cpos[..., 0] * _PRIMES[0]
        for k in range(1, d):
            acc = torch.bitwise_xor(acc, cpos[..., k] * _PRIMES[k])
        flat = acc & (size - 1)
    w = torch.where(bits[:, None].bool(), frac[None], 1.0 - frac[None])     # [C, N, d]
    wgt = w[..., 0]
    for k in range(1, d):
        wgt = wgt * w[..., k]
    return off + flat, wgt


def _all_indices(spec: HashEncoderSpec, x):
    """Corner rows and weights of every level: idx, wgt [L, 2^d, N]."""
    idx_all, wgt_all = [], []
    for level in range(spec.n_levels):
        idx, wgt = _level_indices(spec, x, level)
        idx_all.append(idx)
        wgt_all.append(wgt)
    return torch.stack(idx_all), torch.stack(wgt_all)


def hash_encode(spec: HashEncoderSpec, table, x, row_offset=None):
    """Encode points with a multiresolution hash grid.

    Args:
      table: [rows, F] (or [n_grids * n_rows, F]) float32 parameter table.
      x:     [N, d] coordinates in [0, 1].
      row_offset: optional int (or 0-d integer tensor) added to every row
        index, selecting one grid of a stack of n_grids.
    Returns:
      [N, L * F] float32 features.
    """
    n = x.shape[0]
    idx, wgt = _all_indices(spec, x)                # [L, C, N]
    if row_offset is not None:
        idx = idx + row_offset
    g = table[idx.reshape(-1)].reshape(*idx.shape, spec.n_features)  # [L, C, N, F]
    acc = torch.sum(g * wgt[..., None], dim=1)      # [L, N, F]
    return acc.permute(1, 0, 2).reshape(n, spec.n_levels * spec.n_features)


def hash_encode_blend(spec: HashEncoderSpec, table, x, row_offsets, blend):
    """Blend of K grid lookups that share corner indices, in one gather.

    Args:
      table:       [n_grids * n_rows, F] stacked grids.
      row_offsets: [K] integer row offsets (grid index * n_rows).
      blend:       [K] float32 blend weights.
    Returns:
      [N, L * F]: sum_k blend[k] * hash_encode(spec, table, x, row_offsets[k]).
    """
    n = x.shape[0]
    idx, wgt = _all_indices(spec, x)                # [L, C, N]
    offs = torch.as_tensor(row_offsets, dtype=torch.int64, device=x.device)
    blend = torch.as_tensor(blend, dtype=torch.float32, device=x.device)
    idx_k = idx[None] + offs[:, None, None, None]   # [K, L, C, N]
    g = table[idx_k.reshape(-1)].reshape(*idx_k.shape, spec.n_features)
    g = torch.sum(g * blend[:, None, None, None, None], dim=0)       # [L, C, N, F]
    acc = torch.sum(g * wgt[..., None], dim=1)      # [L, N, F]
    return acc.permute(1, 0, 2).reshape(n, spec.n_levels * spec.n_features)


@lru_cache(maxsize=None)
def _lagrange_nodes(num_basis: int):
    """Lagrange nodes T = [0, 1/(B-1), ..., 1]."""
    return tuple(i / (num_basis - 1) for i in range(num_basis))


def lagrange_weights(t, num_basis=4):
    """Lagrange basis weights at scalar time t, computed in float32 on the host.

    Returns a float32 numpy array [num_basis] — the same f32 arithmetic as
    the reference (nodes enter as f32 constants).
    """
    nodes = _lagrange_nodes(num_basis)
    t = np.float32(t)
    weights = []
    for j in range(num_basis):
        w = np.float32(1.0)
        for m in range(num_basis):
            if m == j:
                continue
            w = w * (t - np.float32(nodes[m])) / np.float32(nodes[j] - nodes[m])
        weights.append(w)
    return np.asarray(weights, np.float32)


def lagrange_time_interp(feats, t, n_levels, n_features, num_basis=4):
    """Temporal Lagrange interpolation over feature chunks ("interpT").

    feats [N, L*F] viewed as [N, L, B, F/B], blended with the Lagrange basis
    at scalar time t. Returns [N, L * F / B].
    """
    n = feats.shape[0]
    f_chunk = n_features // num_basis
    x = feats.reshape(n, n_levels, num_basis, f_chunk)
    w = torch.from_numpy(lagrange_weights(t, num_basis)).to(feats.device)
    out = torch.einsum("nlbf,b->nlf", x, w)
    return out.reshape(n, n_levels * f_chunk)
