"""Multi-sequence training: one field per sequence, S sequences stepped together.

Port of `lidar4d_tpu/parallel/multiseq.py`. The reference stacks S
sequences' train states (every leaf gains a leading [S] axis) and vmaps its
step over them. `torch.func.vmap` cannot go through the port's kernels
(ctypes calls), so here the step is a loop over the sequences in one
process: sequence s steps on the views [s] of the stacked state, which its
update writes in place, with its own generators (seeded seed + s), as S
single-sequence steps would. With a sequence mesh (`make_seq_mesh`) each
rank holds and steps only its contiguous block of the sequences, the loop
running over that block; no collective runs between sequences.
"""

import torch

from lidar4d_tpu_torch.interop import tree_map
from lidar4d_tpu_torch.parallel.mesh import Mesh, shard_rays, world_and_rank
from lidar4d_tpu_torch.train.ema import EmaState, ema_init
from lidar4d_tpu_torch.train.optimizer import AdamState, make_optimizer
from lidar4d_tpu_torch.train.train_step import TrainState, make_train_step

SEQ_AXIS = "seq"


def make_seq_mesh(n_seq):
    """The group's ranks as a 1-D sequence layout; the n_seq sequences split
    over them in contiguous blocks."""
    world, rank = world_and_rank()
    if n_seq % world:
        raise ValueError(f"{n_seq} sequences do not split evenly over {world} ranks")
    return Mesh((SEQ_AXIS,), (world,), rank)


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def init_multiseq_state(field, seed=0, n_seq=1, lr=1e-2, iters=30000, mesh=None, params=None):
    """(stacked TrainState, optimizer). Sequence s starts from
    field.init(seed + s), or from slice s of `params`, a stacked tree (e.g.
    `interop.stacked_params_from_jax`). Every leaf of the parameters, the
    Adam moments and the EMA shadow has a leading [S] axis, or with `mesh`
    [S / size]: this rank's block of the sequences."""
    if params is None:
        params = _stack([field.init(seed + s) for s in range(n_seq)])
    if mesh is not None:
        params = tree_map(lambda x: shard_rays(mesh, x).clone(), params)
    one = tree_map(lambda x: x[0], params)
    opt = make_optimizer(lr, iters, field.param_group_labels(one))
    return TrainState(params, opt.init(params), ema_init(params), 0), opt


def _view(state, j):
    """Sequence j's state: views of the stacked tensors."""
    def pick(x):
        return x[j]

    opt = state.opt_state
    return TrainState(tree_map(pick, state.params),
                      AdamState([m[j] for m in opt.mu], [v[j] for v in opt.nu], opt.count),
                      EmaState(tree_map(pick, state.ema.shadow), state.ema.num_updates),
                      state.step)


def make_multiseq_train_step(field, opt, loss_cfg, *, H, W, fov_lidar, num_rays=1024,
                             num_steps=768, patch_size=1, mesh=None, num_coarse=0, num_fine=0,
                             seed=0):
    """Returns step(state_S, frames_S, flow_caches_S=None, draws_S=None) ->
    (state_S, metrics [S] or, with `mesh`, [S / size]).

    frames_S: the S sequences' frames, one each (frame dicts of
    `TrainStep`); flow_caches_S and draws_S: one each, or None. With `mesh`
    every rank is given all S and steps its own block.
    """
    steps = {}

    def step(state, frames, flow_caches=None, draws=None):
        seqs = range(len(frames))
        if mesh is not None:
            seqs = shard_rays(mesh, seqs)
        metrics = []
        for j, s in enumerate(seqs):
            if s not in steps:
                steps[s] = make_train_step(
                    field, opt, loss_cfg, H=H, W=W, fov_lidar=fov_lidar, num_rays=num_rays,
                    num_steps=num_steps, patch_size=patch_size, num_coarse=num_coarse,
                    num_fine=num_fine, seed=seed + s)
            _, m = steps[s](_view(state, j), frames[s],
                            None if flow_caches is None else flow_caches[s],
                            None if draws is None else draws[s])
            metrics.append(m)
        state.opt_state.count += 1
        state.step += 1
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return step
