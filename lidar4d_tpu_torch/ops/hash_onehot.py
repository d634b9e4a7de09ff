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
from typing import NamedTuple, Optional

import torch

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops.hash_enc import (
    HashEncoderSpec,
    _all_indices,
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


# The share of the card's L2 a call's tables (V x rows x F floats) must
# exceed for the kernels' plans for tables over the L2.
HASH_L2_SHARE = 0.5


def tables_over_l2(spec: HashEncoderSpec, n_tables, l2_bytes):
    """Whether a call's n_tables = V tables of `spec` exceed HASH_L2_SHARE
    of a card's `l2_bytes` of L2 (the H100's 50 MiB): then the finer levels'
    rows, and their gradient's, come from the L2 and device memory, not
    from L1."""
    return n_tables * spec.n_rows * spec.n_features * 4 > HASH_L2_SHARE * l2_bytes


# The launch of `hash_grid_fwd` (csrc/hash_grid_fwd.cu): points a tile on
# the tile path and on the gather path (one a thread; the kernel's
# kMaxThreads at most), the shared memory a block may take (its kSmemLimit,
# the H100's 227 KB), the fewest points (N x V) a call needs for the tile
# path, the SM's unified L1 / shared memory and the L1 a tile launch that
# gathers through L1 keeps, whether tables may be staged and tiles used at
# all (the variants PERF.md times), and the fewest tiles a staging block
# takes (a persistent grid fills one resident wave). Tables over the L2
# (`tables_over_l2`): the threads an SM the tile path keeps resident at
# least.
HASH_FWD_THREADS = 256
HASH_FWD_GATHER_THREADS = 128
HASH_FWD_MAX_THREADS = 512
HASH_FWD_SMEM_LIMIT = 227 * 1024
HASH_FWD_MIN_POINTS = 65536
HASH_FWD_SM_SMEM = 228 * 1024
HASH_FWD_BLOCK_RESERVE = 2048      # 1 KB the driver reserves and the kernel's static arrays
HASH_FWD_L1_KEEP = 96 * 1024
HASH_FWD_STAGE = True
HASH_FWD_TILE = True
HASH_FWD_MIN_RUN = 2
HASH_FWD_L2_RESIDENT = 512


class FwdLaunch(NamedTuple):
    """One launch of `hash_grid_fwd`: floats of the table staged in shared
    memory (0: rows gathered through L1), points a tile, whether the outputs
    go through the shared-memory tile, the SM's shared-memory share in
    percent (-1: the driver's choice), and the fewest tiles a block of the
    persistent grid takes (None: a grid of one tile a block)."""
    table_floats: int
    threads: int
    tile: bool
    carveout: int
    min_run: Optional[int]

    @property
    def route(self):
        """The path as the route counters name it: staged, tile or gather."""
        if self.table_floats:
            return "staged"
        return "tile" if self.tile else "gather"


def hash_fwd_tile_pitch(levels, features):
    """Floats a point takes in the kernel's output tile for `levels` levels
    of `features` features: levels x features rounded up to 4, plus 4 where
    that is a multiple of 8 (distinct banks for eight 16-byte stores)."""
    w = -(-levels * features // 4) * 4
    return w + 4 if w % 8 == 0 else w


def hash_fwd_table_floats(spec: HashEncoderSpec):
    """Floats a table of `spec` takes in shared memory, each level rounded
    up to 4 floats (the kernel's 16-byte bulk copies)."""
    return sum(-(-r * spec.n_features // 4) * 4 for r in spec.table_sizes)


def hash_fwd_launch(spec: HashEncoderSpec, n_points, over_l2=False):
    """The `FwdLaunch` of `hash_grid_fwd` for a call on n_points = N x V
    points of `spec`, whose tables are over the L2 where `over_l2`
    (`tables_over_l2`).

    The gather path, the earlier design's launch (rows through L1, each
    thread storing its own point's outputs, HASH_FWD_GATHER_THREADS points a
    block, one tile a block, the driver's choice of shared memory), serves a call
    of fewer than HASH_FWD_MIN_POINTS points, which cannot spread a block's
    fixed costs, and a spec whose point output is one 32-byte sector or
    less written by 16-byte stores (F % 4 == 0, L x F <= 8), which a thread
    writes whole already. Every other call takes the tile path: tiles of
    HASH_FWD_THREADS points whose outputs go through shared memory, with the
    whole table staged in shared memory beside the tile where both fit
    (bulk copies, all of the SM's fast memory shared, at least
    HASH_FWD_MIN_RUN tiles a block of a persistent grid), else with rows
    gathered through L1 and a shared-memory share that leaves
    HASH_FWD_L1_KEEP bytes of L1 (at least one block's). Tables over the L2
    keep at least HASH_FWD_L2_RESIDENT threads an SM resident instead, as
    far as their tiles fit: their gathers wait on the L2 and device memory,
    and a wide output tile (the flow grid's 272 bytes a point) would leave
    one block an SM."""
    f = spec.n_features
    one_sector = f % 4 == 0 and spec.n_output_dims <= 8
    if n_points < HASH_FWD_MIN_POINTS or one_sector or not HASH_FWD_TILE:
        return FwdLaunch(0, HASH_FWD_GATHER_THREADS, False, -1, None)
    tile_floats = HASH_FWD_THREADS * hash_fwd_tile_pitch(spec.n_levels, f)
    table = hash_fwd_table_floats(spec)
    if HASH_FWD_STAGE and (table + tile_floats) * 4 <= HASH_FWD_SMEM_LIMIT:
        return FwdLaunch(table, HASH_FWD_THREADS, True, 100, HASH_FWD_MIN_RUN)
    block = tile_floats * 4 + HASH_FWD_BLOCK_RESERVE
    blocks = max(1, (HASH_FWD_SM_SMEM - HASH_FWD_L1_KEEP) // block)
    if over_l2:
        resident = -(-HASH_FWD_L2_RESIDENT // HASH_FWD_THREADS)
        blocks = max(blocks, min(resident, HASH_FWD_SM_SMEM // block))
    carveout = min(100, -(-100 * blocks * block // HASH_FWD_SM_SMEM))
    return FwdLaunch(0, HASH_FWD_THREADS, True, carveout, 1)


def hash_fwd_plan(spec: HashEncoderSpec, n_points, n_tables, l2_bytes):
    """(FwdLaunch, route) of a `hash_grid_fwd` call on n_points = N x V
    points through n_tables = V tables of `spec` on a card with `l2_bytes`
    of L2; the route is the plan's, with " over L2" where the tables are
    (`tables_over_l2`)."""
    over_l2 = tables_over_l2(spec, n_tables, l2_bytes)
    plan = hash_fwd_launch(spec, n_points, over_l2)
    return plan, plan.route + (" over L2" if over_l2 else "")


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
    plan, route = hash_fwd_plan(spec, n * v, v, _cuda.l2_bytes(xs.device))
    run = 1
    if plan.min_run is not None:
        bps = _cuda.blocks_per_sm("hash_grid_fwd_blocks_per_sm", spec.n_dims, spec.n_levels,
                                  spec.n_features, plan.table_floats, plan.threads,
                                  int(plan.tile), plan.carveout)
        run = _cuda.persistent_run(n, plan.threads, v, plan.min_run, _cuda.sm_count(xs.device),
                                   bps)
    _cuda.launch("hash_grid_fwd", xs.device, xs.data_ptr(), tables.data_ptr(),
                 levels.data_ptr(), out.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                 spec.n_features, spec.n_rows, plan.table_floats, plan.threads, int(plan.tile),
                 plan.carveout, run, route=route)
    return out


# The persistent grid of `hash_grid_bwd` (csrc/hash_grid_bwd.cu): threads a
# block (the kernel's kThreads), the fewest consecutive points a group of F
# lanes takes, the resident waves the grid fills (2 ran 3% faster than 1 on
# the H100, see PERF.md), and the largest level slice rows_l * F it
# accumulates in shared memory (64 KB). A spec none of whose levels fits
# adds to global memory: by the vector route where F = 4 or 8 and the
# cotangent and gradient are 16-byte aligned (HASH_BWD_VECTOR), and level
# by level where the gradient is over the L2 (HASH_BWD_LEVEL_MAJOR). The
# kernel's route numbers.
HASH_BWD_THREADS = 512
HASH_BWD_MIN_RUN = 4
HASH_BWD_WAVES = 2
HASH_BWD_SMEM_FLOATS = 16384
HASH_BWD_VECTOR = True
HASH_BWD_LEVEL_MAJOR = True
HASH_BWD_ROUTES = {"lanes": 0, "vector": 1}


class BwdLaunch(NamedTuple):
    """One launch of `hash_grid_bwd`: the shared-memory accumulator's floats
    (0: every level adds to global memory), the route (a HASH_BWD_ROUTES
    key), and the grids over which `persistent_run` spreads HASH_BWD_WAVES
    resident waves (levels x variants; variants alone when level-major)."""
    smem_floats: int
    route: str
    grids: int

    @property
    def label(self):
        """The route as the route counters name it: shared, global or
        vector."""
        if self.route == "vector":
            return "vector"
        return "shared" if self.smem_floats else "global"


def _smem_floats(spec: HashEncoderSpec):
    """The kernel's shared-memory accumulator: the largest level slice
    rows_l * F that fits HASH_BWD_SMEM_FLOATS, else 0; a level above it adds
    to the global gradient directly."""
    fits = [r * spec.n_features for r in spec.table_sizes
            if r * spec.n_features <= HASH_BWD_SMEM_FLOATS]
    return max(fits, default=0)


def hash_bwd_launch(spec: HashEncoderSpec, n_variants, l2_bytes, cot_ptr=0, dtab_ptr=0):
    """The `BwdLaunch` of `hash_grid_bwd` for V = n_variants point sets of
    `spec` on a card with `l2_bytes` of L2, whose cotangent and gradient
    start at cot_ptr and dtab_ptr.

    A spec with a level in the shared accumulator takes the lane route
    (lane f of a group of F adds feature f) over HASH_BWD_WAVES waves of all
    levels and variants at once. A spec with none adds every level to global
    memory, where the L2 performs the reductions at a rate of reductions,
    not of bytes: by the vector route (one 16-byte reduction a 4-feature
    chunk of a row, so F = 4 or 8 and 16-byte aligned rows: every level's
    offset x F x 4 bytes is a multiple of 16 then, and the wrapper makes the
    cotangent aligned), else by the lane route. Where the gradient is over
    the L2 (`tables_over_l2`) it goes level-major: HASH_BWD_WAVES waves for
    each level, so that the blocks in flight add to one level's slice (8 MB
    at the reference widths) while it stays in the L2."""
    smem = _smem_floats(spec)
    if smem:
        return BwdLaunch(smem, "lanes", spec.n_levels * n_variants)
    vector = (HASH_BWD_VECTOR and spec.n_features % 4 == 0
              and cot_ptr % 16 == 0 and dtab_ptr % 16 == 0)
    level_major = HASH_BWD_LEVEL_MAJOR and tables_over_l2(spec, n_variants, l2_bytes)
    grids = n_variants if level_major else spec.n_levels * n_variants
    return BwdLaunch(0, "vector" if vector else "lanes", grids)


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
    cot = _cuda.aligned(cot)
    plan = hash_bwd_launch(spec, v, _cuda.l2_bytes(xs.device), cot.data_ptr(), dtab.data_ptr())
    route = HASH_BWD_ROUTES[plan.route]
    bps = _cuda.blocks_per_sm("hash_grid_bwd_blocks_per_sm", spec.n_dims, spec.n_features,
                              plan.smem_floats, route)
    run = _cuda.persistent_run(n, HASH_BWD_THREADS // spec.n_features, plan.grids,
                               HASH_BWD_MIN_RUN, _cuda.sm_count(xs.device), bps, HASH_BWD_WAVES)
    _cuda.launch("hash_grid_bwd", xs.device, xs.data_ptr(), cot.data_ptr(),
                 levels.data_ptr(), dtab.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                 spec.n_features, spec.n_rows, run, plan.smem_floats, route, route=plan.label)
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


# ------------------------------------------------- the TPU kernels' numerics
#
# Plain versions of what the reference's Pallas kernels compute on the TPU,
# witnesses of whether that arithmetic moves a run's quality and never the
# main path: nothing here is called unless a caller swaps them in for the
# kernel wrappers (`chip_smoke.tpu_numerics`). The factorized backward
# (`_bwd_kernel_fact`, `_bwd_kernel_fact_grouped`) multiplies bfloat16 corner
# weights by the bfloat16 cotangent on the MXU and accumulates in float32.
# The factorized forward (`_fwd_call_fact`, `_fwd_call_fact_grouped`) takes
# its gather form where the packed table's HI * F rows fill 8-row groups and
# F divides 8, and there looks rows up in exact float32; its one-hot form
# rounds the table and the weights to bfloat16. A product of two bfloat16
# values is exact in float32, so the twins form the same products and add
# them in float32 (in another order than the MXU: ~1 float32 ulp).

TPU_CHUNK = 1 << 18                 # points a forward twin holds at once (`_chunks`)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def tpu_fwd_gathers(spec: HashEncoderSpec):
    """Whether the TPU's factorized forward at this spec is its exact
    float32 gather form (else the bfloat16 one-hot form)."""
    hf = -(-max(spec.table_sizes) // 128) * spec.n_features
    return hf % 8 == 0 and 8 % spec.n_features == 0


def _chunks(n):
    return [(s, min(s + TPU_CHUNK, n)) for s in range(0, n, TPU_CHUNK)]


def hash_grid_fwd_tpu(spec: HashEncoderSpec, tables, xs):
    """`hash_grid_fwd` as the TPU computes it: [V, rows, F], [V, N, d] ->
    [V, N, L*F]. Exact float32 where the TPU gathers (`tpu_fwd_gathers`),
    else the table and the corner weights rounded to bfloat16, their
    products added in float32."""
    v, n, _ = xs.shape
    f = spec.n_features
    one_hot = not tpu_fwd_gathers(spec)
    out = torch.empty((v, n, spec.n_levels, f), dtype=torch.float32, device=xs.device)
    for vi in range(v):
        table = _bf16(tables[vi]) if one_hot else tables[vi]
        for s, e in _chunks(n):
            idx, w = _all_indices(spec, xs[vi, s:e])
            if one_hot:
                w = _bf16(w)
            out[vi, s:e] = torch.sum(table[idx] * w[..., None], dim=1).transpose(0, 1)
    return out.reshape(v, n, spec.n_levels * f)


def hash_grid_bwd_tpu(spec: HashEncoderSpec, xs, cot, n_tables=None):
    """`hash_grid_bwd` as the TPU computes it (`_bwd_kernel_fact`,
    `_bwd_kernel_fact_grouped`): every corner's bfloat16 weight times the
    bfloat16 cotangent, scattered into a float32 gradient. Returns
    [n_tables, rows, F]."""
    v, n, _ = xs.shape
    f = spec.n_features
    n_tables = v if n_tables is None else n_tables
    dtab = torch.zeros((n_tables, spec.n_rows, f), dtype=torch.float32, device=xs.device)
    cot = _bf16(cot.reshape(v, n, spec.n_levels, f))
    for vi in range(v):
        for s, e in _chunks(n):
            idx, w = _all_indices(spec, xs[vi, s:e])
            upd = _bf16(w)[..., None] * cot[vi, s:e].transpose(0, 1)[:, None]  # [L, C, n, F]
            dtab[vi].index_add_(0, idx.reshape(-1), upd.reshape(-1, f))
    return dtab
