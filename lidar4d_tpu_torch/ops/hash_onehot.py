"""Hash-grid encodes on the CUDA kernels `hash_grid_fwd` / `hash_grid_bwd`.

Port of `lidar4d_tpu/ops/hash_onehot.py`. The TPU file wrote the row gather
and its scatter as one-hot matmuls because the TPU has no fast gather, in
two layouts: the classic `[BN, R]` one-hot (`_fwd_call` / `_bwd_call`) and
the factorized one (`_fwd_call_fact*`, `_bwd_call_fact`,
`_folded_table_bwd`). Both compute one function with one gradient contract.
Hopper gathers and scatters directly, so every entry point here, classic or
factorized, runs one forward kernel, `csrc/hash_grid_fwd.cu`, and one
backward kernel, `csrc/hash_grid_bwd.cu`, each taking V tables and V point
sets at once and computing corner rows and weights from x inside the kernel.

`ONEHOT_VARIANT` is the reference's A/B switch of the train and render
path, read at call time: under "fact" (the default) `hash_encode_auto`
takes the factorized route, `hash_encode_interp_auto` folds interpT into
the table, and `HashGrid4D.forward_dynamic_multi` fuses its V variants into
one launch per plane; under "classic" every encode runs at the table's own
F, one launch per variant, and interpT follows the encode.

Dispatch rule for every wrapper: a CPU tensor runs the plain PyTorch version
(`hash_grid_fwd_plain`, built on `ops.hash_enc.hash_encode`, and
`hash_grid_bwd_plain`, autograd of it); a CUDA tensor launches the kernel or
raises. There is no fallback between the two.

Gradient contracts (the reference's custom VJPs, kept on both devices): the
kernels give the TABLE gradient only. The coordinate cotangent is NaN when
the incoming cotangent is nonzero (`_poison`), so a caller that
differentiates through the coordinates fails loudly instead of training with
a silent zero; such a caller passes `coord_grad=True` to the dispatchers and
gets the plain path, which autograd differentiates in x too.

The Lagrange "interpT" contraction commutes with the encode
(`interpT(Encode(T, x), t) == Encode(fold(T, w(t)), x)`), so the folded
entry points fold the table in PyTorch first (`_fold_table`, outside the
kernel as in the reference) and encode at F' = F / num_basis features;
autograd carries the folded table's gradient back through the fold.
"""

import dataclasses
from functools import lru_cache

import torch

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops.hash_enc import (
    HashEncoderSpec,
    hash_encode,
    lagrange_time_interp,
    lagrange_weights,
)

_MAX_LEVELS = 16
_KERNEL_DIMS = (2, 3)
_KERNEL_FEATURES = (1, 2, 4, 8)
# Rows per level the kernels take: keeps the row offsets of up to 16 levels
# inside the kernel's 32-bit integers.
KERNEL_MAX_ROWS = 1 << 24
# The reference's window of the factorized route (rows per level); the
# classic route's is `hash_encode_auto`'s max_rows, 4096 by default.
FACT_MAX_ROWS = 16384
ONEHOT_VARIANT = "fact"


def onehot_eligible(spec: HashEncoderSpec, max_rows=4096):
    """Whether the kernels take this spec with at most `max_rows` rows per
    level: the reference's one-hot window (4096 rows by default, the classic
    route's; `hash_encode_auto` passes its max_rows or fact_max_rows). The
    kernels need 2 or 3 dims, F in {1, 2, 4, 8} (their vector widths) and at
    most 16 levels; the TPU's tile rules (F % 8, VMEM) do not apply to
    them."""
    return (spec.n_dims in _KERNEL_DIMS
            and spec.n_features in _KERNEL_FEATURES
            and spec.n_levels <= _MAX_LEVELS
            and max(spec.table_sizes) <= min(max_rows, KERNEL_MAX_ROWS))


def folded_eligible(spec: HashEncoderSpec, num_basis, fact_max_rows=None):
    """Whether the folded encode (F' = F / num_basis) runs on the kernels
    within `fact_max_rows` rows per level (default FACT_MAX_ROWS)."""
    if spec.n_features % num_basis:
        return False
    fact_max_rows = FACT_MAX_ROWS if fact_max_rows is None else fact_max_rows
    return onehot_eligible(_folded_spec(spec, num_basis), fact_max_rows)


def _folded_spec(spec, num_basis):
    return dataclasses.replace(spec, n_features=spec.n_features // num_basis)


@lru_cache(maxsize=None)
def _level_table(spec: HashEncoderSpec, device: torch.device):
    """[L, 4] int32 (resolution, rows, row offset, dense flag) on `device`."""
    rows = []
    for res, size, off in zip(spec.resolutions, spec.table_sizes, spec.level_offsets):
        rows.append([res, size, off, int(size == (res + 1) ** spec.n_dims)])
    return torch.tensor(rows, dtype=torch.int32, device=device)


def hash_grid_fwd_plain(spec: HashEncoderSpec, tables, xs):
    """Plain version of `hash_grid_fwd`: [V, rows, F], [V, N, d] -> [V, N, L*F]."""
    return torch.stack([hash_encode(spec, t, x) for t, x in zip(tables, xs)])


def hash_grid_fwd(spec: HashEncoderSpec, tables, xs):
    """Encode V point sets through V tables of one spec.

    Args:
      tables: [V, rows, F] float32, each a flat per-level-concatenated table.
      xs:     [V, N, d] float32 coordinates in [0, 1].
    Returns:
      [V, N, L*F] float32.
    """
    v, n, d = xs.shape
    if tables.shape != (v, spec.n_rows, spec.n_features) or d != spec.n_dims:
        raise ValueError(
            f"hash_grid_fwd: tables {tuple(tables.shape)} / xs {tuple(xs.shape)} "
            f"do not match {spec}")
    if xs.device.type == "cpu":
        return hash_grid_fwd_plain(spec, tables, xs)
    if not onehot_eligible(spec, KERNEL_MAX_ROWS):
        raise ValueError(f"hash_grid_fwd kernel does not take {spec}")
    _cuda.check_cuda_tensor("tables", tables)
    _cuda.check_cuda_tensor("xs", xs)
    tables = _cuda.aligned(tables)
    out = torch.empty((v, n, spec.n_levels * spec.n_features), dtype=torch.float32,
                      device=xs.device)
    if n == 0:
        return out
    levels = _level_table(spec, xs.device)
    _cuda.launch("hash_grid_fwd", xs.device, xs.data_ptr(), tables.data_ptr(),
                 levels.data_ptr(), out.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                 spec.n_features, spec.n_rows)
    return out


# The persistent grid of `hash_grid_bwd` (csrc/hash_grid_bwd.cu): threads a
# block (the kernel's kThreads), the fewest consecutive points a group of F
# lanes takes, the resident waves the grid fills (2 ran 3% faster than 1 on
# the H100, see PERF.md), and the largest level slice rows_l * F it
# accumulates in shared memory (64 KB).
HASH_BWD_THREADS = 512
HASH_BWD_MIN_RUN = 4
HASH_BWD_WAVES = 2
HASH_BWD_SMEM_FLOATS = 16384


def _smem_floats(spec: HashEncoderSpec):
    """The kernel's shared-memory accumulator: the largest level slice
    rows_l * F that fits HASH_BWD_SMEM_FLOATS, else 0; a level above it adds
    to the global gradient directly."""
    fits = [r * spec.n_features for r in spec.table_sizes
            if r * spec.n_features <= HASH_BWD_SMEM_FLOATS]
    return max(fits, default=0)


def hash_grid_bwd_plain(spec: HashEncoderSpec, xs, cot, n_tables=None):
    """Plain version of `hash_grid_bwd`: autograd of `hash_grid_fwd_plain`
    with respect to the tables (the encode is linear in them)."""
    v = xs.shape[0]
    n_tables = v if n_tables is None else n_tables
    with torch.enable_grad():
        tables = torch.zeros((v, spec.n_rows, spec.n_features), dtype=cot.dtype,
                             device=cot.device, requires_grad=True)
        out = hash_grid_fwd_plain(spec, tables, xs.detach())
        (grad,) = torch.autograd.grad(out, tables, cot)
    if n_tables > v:
        grad = torch.cat([grad, grad.new_zeros((n_tables - v, *grad.shape[1:]))])
    return grad


def hash_grid_bwd(spec: HashEncoderSpec, xs, cot, n_tables=None):
    """Table gradient of `hash_grid_fwd` for the V point sets given.

    Args:
      xs:  [V, N, d] float32 coordinates, as given to the forward.
      cot: [V, N, L*F] float32 cotangent of the forward's output.
      n_tables: rows of the result's leading axis (default V); tables past
        the V scattered ones get a zero gradient, so a caller trains the
        first V of its tables alone.
    Returns:
      [n_tables, rows, F] float32.
    """
    v, n, _ = xs.shape
    n_tables = v if n_tables is None else n_tables
    if cot.shape != (v, n, spec.n_output_dims) or n_tables < v:
        raise ValueError(f"hash_grid_bwd: xs {tuple(xs.shape)} / cot {tuple(cot.shape)} "
                         f"/ {n_tables} tables do not match {spec}")
    if xs.device.type == "cpu":
        return hash_grid_bwd_plain(spec, xs, cot, n_tables)
    if not onehot_eligible(spec, KERNEL_MAX_ROWS):
        raise ValueError(f"hash_grid_bwd kernel does not take {spec}")
    _cuda.check_cuda_tensor("xs", xs)
    _cuda.check_cuda_tensor("cot", cot)
    dtab = torch.zeros((n_tables, spec.n_rows, spec.n_features), dtype=torch.float32,
                       device=xs.device)
    if n == 0:
        return dtab
    levels = _level_table(spec, xs.device)
    smem = _smem_floats(spec)
    bps = _cuda.blocks_per_sm("hash_grid_bwd_blocks_per_sm", spec.n_dims, spec.n_features,
                              smem)
    run = _cuda.persistent_run(n, HASH_BWD_THREADS // spec.n_features, spec.n_levels * v,
                               HASH_BWD_MIN_RUN, _cuda.sm_count(xs.device), bps,
                               HASH_BWD_WAVES)
    _cuda.launch("hash_grid_bwd", xs.device, xs.data_ptr(), cot.data_ptr(),
                 levels.data_ptr(), dtab.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                 spec.n_features, spec.n_rows, run, smem)
    return dtab


def _poison(ref, cot):
    """Per-variant coordinate cotangent of the kernels: NaN for a variant
    whose incoming cotangent has a nonzero entry, else 0 (reference
    `_poison_coord_grad`, gated per variant as in `_vjp_bwd_multi_folded`).
    ref: [V, ...]; cot: [V, ...]."""
    live = (cot != 0).reshape(cot.shape[0], -1).any(dim=1)
    poison = torch.where(live, float("nan"), 0.0).to(ref.dtype)
    return poison.reshape(-1, *([1] * (ref.ndim - 1))) * torch.ones_like(ref)


class _HashGrid(torch.autograd.Function):
    """V-variant hash encode: forward `hash_grid_fwd`, backward
    `hash_grid_bwd` for the first `n_grad` tables (the others get a zero
    gradient), NaN-poisoned cotangents for xs and for the Lagrange weights
    ws (None when the caller has none)."""

    @staticmethod
    def forward(ctx, spec, n_grad, tables, xs, ws):
        ctx.spec, ctx.n_grad = spec, n_grad
        ctx.ws_shape = None if ws is None else ws.shape
        ctx.save_for_backward(xs)
        return hash_grid_fwd(spec, tables, xs)

    @staticmethod
    def backward(ctx, cot):
        (xs,) = ctx.saved_tensors
        cot = cot.contiguous()
        dtables = dxs = dws = None
        if ctx.needs_input_grad[2]:
            k = ctx.n_grad
            dtables = hash_grid_bwd(ctx.spec, xs[:k], cot[:k], n_tables=xs.shape[0])
        if ctx.needs_input_grad[3]:
            dxs = _poison(xs, cot)
        if ctx.needs_input_grad[4]:
            dws = _poison(torch.ones(ctx.ws_shape, device=cot.device), cot)
        return None, None, dtables, dxs, dws


def hash_grid(spec: HashEncoderSpec, tables, xs):
    """Differentiable `hash_grid_fwd`: [V, rows, F], [V, N, d] -> [V, N, L*F],
    every table trained (the hashed static planes, one table per plane)."""
    return _HashGrid.apply(spec, tables.shape[0], tables, xs, None)


def hash_encode_onehot_fact(spec: HashEncoderSpec, table, x):
    """Hash encode of one point set, [rows, F], [N, d] -> [N, L*F], with the
    reference's contract: the table gradient from `hash_grid_bwd`, and NaN
    for x wherever the incoming cotangent is nonzero (`_poison_coord_grad`).
    The reference's factorized one-hot encode (`_fwd_call_fact` /
    `_bwd_call_fact`)."""
    return _HashGrid.apply(spec, 1, table[None], x[None], None)[0]


# The reference's classic one-hot encode (its Pallas `_fwd_call` /
# `_bwd_call`): on Hopper the same function, kernels and contract as the
# factorized one. A name of its own, so that the dispatch reads as the
# reference's.
hash_encode_onehot = hash_encode_onehot_fact


def hash_encode_fact_multi(spec: HashEncoderSpec, table, tables_ng, xs):
    """Unfolded encode of V point sets through V tables in one launch.

    table [rows, F] (variant 0), tables_ng [V-1, rows, F], xs [V, N, d].
    Returns [V, N, L*F], per variant equal to `hash_encode_onehot`. Only
    variant 0's table is trained: tables_ng get a zero gradient. The x
    poison is gated per variant, so a variant whose output the caller
    detaches passes a zero cotangent to its coordinates.
    """
    tables = torch.cat([table[None], tables_ng])
    return _HashGrid.apply(spec, 1, tables, xs, None)


def hash_encode_auto(spec: HashEncoderSpec, table, x, row_offset=None, max_rows=4096,
                     fact_max_rows=None, coord_grad=False):
    """Hash encode with the reference's dispatch, in its order:

      * `row_offset` or coord_grad=True: the plain `hash_encode`, which
        differentiates in x too;
      * ONEHOT_VARIANT "fact" and at most `fact_max_rows` rows per level
        (default FACT_MAX_ROWS): `hash_encode_onehot_fact`;
      * at most `max_rows` rows per level: `hash_encode_onehot`, the classic
        route;
      * else the reference's float32 gather, whose x gradient is real: the
        plain `hash_encode` where x needs a gradient, the kernel (the same
        function) where it does not.

    The one-hot routes NaN-poison the x cotangent (module docstring), so a
    caller that differentiates through x passes coord_grad=True.
    """
    fact_max_rows = FACT_MAX_ROWS if fact_max_rows is None else fact_max_rows
    if row_offset is None and not coord_grad:
        if ONEHOT_VARIANT == "fact" and onehot_eligible(spec, fact_max_rows):
            return hash_encode_onehot_fact(spec, table, x)
        if onehot_eligible(spec, max_rows):
            return hash_encode_onehot(spec, table, x)
        x_grad = torch.is_grad_enabled() and x.requires_grad
        if not x_grad and onehot_eligible(spec, KERNEL_MAX_ROWS):
            return hash_encode_onehot(spec, table, x)
    return hash_encode(spec, table, x, row_offset=row_offset)


def _fold_table(table, w, fp):
    """[..., rows, F] x Lagrange weights [..., B] -> [..., rows, F'] (F' = F/B).

    Float32, written as a broadcast multiply and a sum over B rather than a
    matmul so that no TF32 setting can reach it (the reference runs this
    contraction at HIGHEST precision)."""
    b = w.shape[-1]
    t = table.reshape(*table.shape[:-1], b, fp)
    return (t * w[..., None, :, None]).sum(dim=-2)


def hash_encode_folded(spec: HashEncoderSpec, table, x, w):
    """interpT(hash_encode(spec, table, x), t), the Lagrange contraction
    folded into the table. w: [B] = lagrange_weights(t, B). Returns
    [N, L*F/B]. The table gradient runs the kernel at F' and autograd
    expands it through `_fold_table` by w; x and w get NaN poison."""
    b = w.shape[0]
    fp = spec.n_features // b
    folded = _fold_table(table, w.detach(), fp)
    return _HashGrid.apply(_folded_spec(spec, b), 1, folded[None], x[None], w[None])[0]


def hash_encode_fact_multi_folded(spec: HashEncoderSpec, table, tables_ng, xs, ws):
    """Folded encode of V point sets through V tables in one launch.

    table [rows, F] (variant 0), tables_ng [V-1, rows, F], xs [V, N, d],
    ws [V, B] per-variant Lagrange weights. Returns [V, N, L*F/B]. Only
    variant 0's table is trained; tables_ng get no gradient; the x and w
    poison is gated per variant, so the warped variants, whose output the
    caller detaches, pass a zero (not NaN) cotangent to the flow net.
    """
    b = ws.shape[1]
    fp = spec.n_features // b
    folded = torch.cat([_fold_table(table, ws[0].detach(), fp)[None],
                        _fold_table(tables_ng.detach(), ws[1:].detach(), fp)])
    return _HashGrid.apply(_folded_spec(spec, b), 1, folded, xs, ws)


def hash_encode_interp_auto(spec: HashEncoderSpec, table, x, t, num_basis,
                            coord_grad=False):
    """interpT(encode(x), t): under ONEHOT_VARIANT "fact", the folded encode
    when the spec splits into basis chunks the kernels take (kernel on CUDA,
    plain on CPU); else `hash_encode_auto`, then interpT. coord_grad=True
    takes the plain path, differentiable in x too."""
    if not coord_grad and ONEHOT_VARIANT == "fact" and folded_eligible(spec, num_basis):
        w = torch.from_numpy(lagrange_weights(t, num_basis)).to(x.device)
        return hash_encode_folded(spec, table, x, w)
    g = hash_encode_auto(spec, table, x, coord_grad=coord_grad)
    return lagrange_time_interp(g, t, spec.n_levels, spec.n_features, num_basis)
