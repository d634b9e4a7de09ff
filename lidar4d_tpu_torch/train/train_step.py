"""The LiDAR4D training step.

Port of `lidar4d_tpu/train/train_step.py`: one step samples a batch of
rays, renders them with perturbation, assembles the composite loss
(depth / ray-drop / intensity, batch chamfer, flow consistency with ground
zero-flow, optional patch gradient and line-of-sight losses), takes its
gradient, and applies one grouped Adam update.

Randomness: every draw of a step can be injected (`draws`), so a test can
feed the reference's own draws in: `inds` [N] ray pixel indices,
`z_jitter` and `u_jitter` (the renderer's U(0, 1) draws, see
`models.renderer.render_draws`) and `t_rand`, the scalar time of the
ground zero-flow term. Without `draws` the step draws the tensors from a
`torch.Generator` on the field's device and `t_rand` from one on the host
(it sets host-side Lagrange weights, so a device draw would stall the
host on the device).

Ray parallelism (`mesh`, a layout of `parallel.mesh`): every rank takes the
same global draws (rank 0's, broadcast), renders its contiguous block of
the batch's rays and computes a local loss such that the ranks' local
losses sum to the single-process loss: the per-ray lidar and line-of-sight
sums over its own rays (the latter over the global count of valid rays),
and the terms that need the whole batch or no ray at all (the batch
chamfer and the patch gradient loss on the gathered operands, the flow
loss) each weighted by 1 / size. One all-reduce then sums the gradients
and the metrics, so every rank applies the single-process update.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from lidar4d_tpu_torch.interop import tree_leaves
from lidar4d_tpu_torch.models.renderer import render_draws, render_rays
from lidar4d_tpu_torch.ops.chamfer import chamfer_distance_fast
from lidar4d_tpu_torch.ops.rays import get_lidar_rays, patch_dims, sample_ray_indices
from lidar4d_tpu_torch.parallel.mesh import all_reduce, gather_rays, replicate, shard_rays
from lidar4d_tpu_torch.train.ema import EmaState, ema_init
from lidar4d_tpu_torch.train.losses import (
    LossConfig,
    conv2d_same,
    cosine_similarity,
    elementwise_loss,
    sobel_kernels,
)
from lidar4d_tpu_torch.train.optimizer import AdamState, make_optimizer


@dataclass
class TrainState:
    params: Any
    opt_state: AdamState
    ema: EmaState
    step: int


def init_train_state(field, seed=0, lr=1e-2, iters=30000, params=None):
    """(TrainState, optimizer) from the field's seeded init, or from `params`
    (e.g. a JAX tree carried over by `interop.params_from_jax`)."""
    params = field.init(seed) if params is None else params
    opt = make_optimizer(lr, iters, field.param_group_labels(params))
    return TrainState(params, opt.init(params), ema_init(params), 0), opt


def flow_cache_to_device(cache, device):
    """The flow cache's numpy arrays as float32 tensors on `device` (once,
    not every step)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in cache.items()}


# --------------------------------------------------------------------- losses
def _gradient_loss(pred_depth, gt_depth, gt_raydrop, cfg: LossConfig, px, py):
    """Patch-mode gradient losses (reference `_gradient_loss`). Inputs [N]."""
    crit = elementwise_loss(cfg.depth_grad_loss, cfg.scale)
    pd = pred_depth.reshape(-1, 1, px, py) / cfg.scale
    gt = gt_depth.reshape(-1, 1, px, py) / cfg.scale
    rd = gt_raydrop.reshape(-1, 1, px, py)

    if cfg.sobel_grad:
        kx, ky = sobel_kernels(pd.device)
        pred_gx, pred_gy = conv2d_same(pd, kx), conv2d_same(pd, ky)
        gt_gx = conv2d_same(gt, kx)
    else:
        pred_gy = torch.abs(pd[:, :, :-1, :] - pd[:, :, 1:, :])
        pred_gx = torch.abs(pd[:, :, :, :-1] - pd[:, :, :, 1:])
        gt_gx = gt[:, :, :, :-1] - gt[:, :, :, 1:]

    dy = torch.abs(pred_gy)
    dx = torch.abs(pred_gx)

    loss = 0.0
    if cfg.grad_norm_smooth:
        loss += cfg.alpha_grad_norm * (torch.mean(torch.exp(-dx)) + torch.mean(torch.exp(-dy)))
    if cfg.spatial_smooth:
        loss += cfg.alpha_spatial * (torch.mean(dx ** 2) + torch.mean(dy ** 2))
    if cfg.tv_loss:
        loss += cfg.alpha_tv * (torch.mean(dx) + torch.mean(dy))

    if cfg.grad_loss:
        mask_x = (torch.abs(gt_gx) < 0.01).float()
        mdx = rd * mask_x if cfg.sobel_grad else rd[:, :, :, :-1] * mask_x
        if cfg.depth_grad_loss == "cos":
            pn = pred_gx.shape[0]
            g = cosine_similarity((pred_gx * mdx).reshape(pn, -1), (gt_gx * mdx).reshape(pn, -1))
            gl = torch.sum(1.0 - g)
        else:
            gl = torch.sum(crit(pred_gx * mdx, gt_gx * mdx))
        loss += cfg.alpha_grad * gl
    return loss


def _flow_loss(field, params, cache, frame_idx, t, t_rand):
    """Flow consistency over the 4 neighbour pairs (+1, -1, +2, -2) as one
    batched chamfer, plus ground zero-flow at time t_rand (reference
    `_flow_loss`). cache: the device tensors of `flow_cache_to_device`."""
    points, mask, valid = cache["points"], cache["mask"], cache["valid"]
    n_frames = points.shape[0]
    pc, pc_m = points[frame_idx], mask[frame_idx]
    flow = field.flow(params, pc, t)
    fwd, bwd = flow["forward"], flow["backward"]

    steps = (1, -1, 2, -2)
    nbr = [min(max(frame_idx + s, 0), n_frames - 1) for s in steps]
    in_range = torch.tensor([float(0 <= frame_idx + s <= n_frames - 1) for s in steps],
                            device=points.device)
    nbr_exists = in_range * (valid[nbr] > 0).float() * (valid[frame_idx] > 0).float()

    preds = torch.stack([pc + fwd * 1.0, pc + bwd * 1.0, pc + fwd * 2.0, pc + bwd * 2.0])
    d1, d2, _, _ = chamfer_distance_fast(preds, points[nbr])
    per_pair = 0.5 * (torch.sum(d1 * pc_m[None], dim=1) + torch.sum(d2 * mask[nbr], dim=1))
    loss = torch.sum(per_pair * nbr_exists)

    zf = field.flow(params, cache["ground"][frame_idx], t_rand)
    g_abs = (torch.abs(zf["forward"]) + torch.abs(zf["backward"])) \
        * cache["gmask"][frame_idx][:, None]
    return loss + 0.001 * torch.sum(g_abs) * valid[frame_idx]


def _urf_loss(weights, z_vals, gt_depth, step, cfg: LossConfig, mesh=None):
    """Line-of-sight loss (reference `_urf_loss`); with `mesh`, this rank's
    share: its rays' sums over the whole batch's valid-ray count and
    largest density."""
    eps = float(np.float32(0.02) * np.float32(0.1) ** np.minimum(
        np.float32(step) / np.float32(cfg.iters), np.float32(1.0)))
    gt = gt_depth.reshape(z_vals.shape[0], 1)
    n_valid = torch.sum((gt > 0.0).float())

    mask_empty = ((z_vals < gt - eps) | (z_vals > gt + eps)).float()

    mask_near = ((z_vals > gt - eps) & (z_vals < gt + eps)).float()
    distance = mask_near * (z_vals - gt)
    sigma = eps / 3.0
    distr = 1.0 / (sigma * np.sqrt(2 * np.pi)) * torch.exp(-(distance ** 2) / (2 * sigma ** 2))
    distr_max = torch.max(distr)
    if mesh is not None:
        counts = gather_rays(mesh, torch.stack([n_valid, distr_max])).reshape(-1, 2)
        n_valid, distr_max = counts[:, 0].sum(), counts[:, 1].max()
    n_valid = torch.clamp(n_valid, min=1.0)
    loss_empty = torch.sum((mask_empty * weights) ** 2) / n_valid
    distr = distr / torch.clamp(distr_max, min=1e-12)
    distr = distr * mask_near
    loss_near = torch.sum((mask_near * weights - distr) ** 2) / n_valid
    return 0.1 * loss_empty + 0.1 * loss_near


# ----------------------------------------------------------------- the step
class TrainStep:
    """One training step of one sampling mode (`make_train_step`).

    step(state, frame, flow_cache, draws=None) -> (state, metrics): frame is
    dict(pose [4, 4], image [H, W, 3] = (ray-drop, intensity, depth * scale),
    time), as numpy arrays or tensors; flow_cache the device tensors of
    `flow_cache_to_device` (or None). The state's parameters are updated in
    place; metrics are 0-d device tensors. With `mesh` every rank of it
    calls the step with the same state, frame and cache; the batch (the
    draws' rays: in patch mode, whole patches) must split evenly over the
    ranks, and metrics and gradients come back summed over them.
    """

    def __init__(self, field, opt, loss_cfg: LossConfig, *, H, W, fov_lidar, num_rays=1024,
                 num_steps=768, patch_size=1, num_coarse=0, num_fine=0, seed=0,
                 generators=None, mesh=None):
        self.field, self.opt, self.cfg = field, opt, loss_cfg
        self.H, self.W, self.fov_lidar = H, W, tuple(fov_lidar)
        self.num_rays, self.num_steps = num_rays, num_steps
        self.num_coarse, self.num_fine = num_coarse, num_fine
        self.px, self.py = patch_dims(patch_size)
        self.mesh = mesh
        if mesh is not None:
            n = min(num_rays, H * W)
            if self.px > 1 and (n // (self.px * self.py)) % mesh.size:
                raise ValueError(
                    f"{n // (self.px * self.py)} patches of {self.px}x{self.py} rays do not "
                    f"split evenly over {mesh.size} ranks: a rank's block of the batch must "
                    "hold whole patches")
            if self.px == 1 and n % mesh.size:
                raise ValueError(f"num_rays {n} does not split evenly over {mesh.size} ranks")
        if generators is None:
            generators = (torch.Generator(device=field.device), torch.Generator())
            for g in generators:
                g.manual_seed(seed)
        self.generator, self.host_generator = generators
        self.depth_crit = elementwise_loss(loss_cfg.depth_loss, loss_cfg.scale)
        self.raydrop_crit = elementwise_loss(loss_cfg.raydrop_loss, loss_cfg.scale)
        self.intensity_crit = elementwise_loss(loss_cfg.intensity_loss, loss_cfg.scale)

    def draw(self):
        """One step's random draws (see the module docstring)."""
        dev = self.field.device
        inds = sample_ray_indices(self.H, self.W, self.num_rays, (self.px, self.py),
                                  self.generator, dev)
        draws = render_draws(inds.shape[0], self.num_steps, self.num_coarse, self.num_fine,
                             self.generator, dev)
        draws["inds"] = inds
        draws["t_rand"] = float(torch.rand((), generator=self.host_generator))
        return replicate(self.mesh, draws)

    def loss_fn(self, params, frame, flow_cache, draws, step):
        """(loss, metrics) of one batch; with the mesh, this rank's share of
        each (see the module docstring)."""
        cfg, field, mesh = self.cfg, self.field, self.mesh
        dev = field.device
        pose = torch.as_tensor(frame["pose"], dtype=torch.float32, device=dev)
        image = torch.as_tensor(frame["image"], dtype=torch.float32, device=dev)
        t = np.float32(frame["time"])
        if mesh is not None:
            draws = {k: shard_rays(mesh, torch.as_tensor(v, device=dev)) if k != "t_rand" else v
                     for k, v in draws.items()}
        rays = get_lidar_rays(pose, self.fov_lidar, self.H, self.W, N=self.num_rays,
                              patch_size=(self.px, self.py), inds=draws["inds"])
        rays_o, rays_d, inds = rays["rays_o"], rays["rays_d"], rays["inds"]

        pixels = image.reshape(-1, 3)[inds]
        gt_raydrop = pixels[:, 0]
        gt_intensity = pixels[:, 1] * gt_raydrop
        gt_depth = pixels[:, 2] * gt_raydrop

        out = render_rays(field, params, rays_o, rays_d, t, num_steps=self.num_steps,
                          num_coarse=self.num_coarse, num_fine=self.num_fine, perturb=True,
                          with_aux=True, draws=draws)
        pred_raydrop = out["image_lidar"][:, 0]
        pred_intensity = out["image_lidar"][:, 1] * gt_raydrop
        pred_depth = out["depth_lidar"] * gt_raydrop

        if cfg.raydrop_loss == "bce":
            pred_raydrop = torch.sigmoid(pred_raydrop)
        gt_raydrop_smooth = torch.clamp(gt_raydrop, cfg.smooth_factor, 1.0 - cfg.smooth_factor)
        lidar_loss = (cfg.alpha_d * self.depth_crit(pred_depth, gt_depth)
                      + cfg.alpha_r * self.raydrop_crit(pred_raydrop, gt_raydrop_smooth)
                      + cfg.alpha_i * self.intensity_crit(pred_intensity, gt_intensity))
        loss = torch.sum(lidar_loss)
        metrics = {"lidar_loss": loss}

        def whole_batch(term):
            """A term every rank computes alike: its share of the sum."""
            return term if mesh is None else term / mesh.size

        # the whole batch's rays, for the terms that need them all
        batch_d, batch_pred, batch_gt, batch_drop = rays_d, pred_depth, gt_depth, gt_raydrop
        if mesh is not None:
            cols = gather_rays(mesh, torch.cat(
                [rays_d, pred_depth[:, None], gt_depth[:, None], gt_raydrop[:, None]], 1))
            batch_d, batch_pred, batch_gt, batch_drop = (
                cols[:, :3], cols[:, 3], cols[:, 4], cols[:, 5])
        pred_lidar = batch_d * batch_pred[:, None] / cfg.scale
        gt_lidar = batch_d * batch_gt[:, None] / cfg.scale
        d1, d2, _, _ = chamfer_distance_fast(pred_lidar[None], gt_lidar[None])
        chamfer_l = whole_batch(torch.mean(d1 + d2) * 0.5)
        loss = loss + chamfer_l
        metrics["chamfer_loss"] = chamfer_l

        if cfg.flow_loss and flow_cache is not None:
            frame_idx = int(np.floor(t * np.float32(cfg.num_frames - 1) + np.float32(0.5)))
            fl = whole_batch(_flow_loss(field, params, flow_cache, frame_idx, t,
                                        np.float32(draws["t_rand"])))
            loss = loss + fl
            metrics["flow_loss"] = fl

        if cfg.urf_loss:
            ul = _urf_loss(out["weights"], out["z_vals"], gt_depth, step, cfg, mesh)
            loss = loss + ul
            metrics["urf_loss"] = ul

        if self.px > 1:
            gl = whole_batch(_gradient_loss(batch_pred, batch_gt, batch_drop, cfg, self.px,
                                            self.py))
            loss = loss + gl
            metrics["grad_loss"] = gl

        metrics["loss"] = loss
        return loss, metrics

    def grads(self, params, frame, flow_cache, draws, step):
        """(gradient of every parameter leaf in tree order, None where a leaf
        takes no part, metrics); with the mesh, both summed over its ranks
        in one all-reduce."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = self.loss_fn(params, frame, flow_cache, draws, step)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.mesh is None:
            return grads, metrics
        live = [g for g in grads if g is not None]
        names = sorted(metrics)
        flat = all_reduce(self.mesh, torch.cat(
            [g.reshape(-1) for g in live] + [torch.stack([metrics[k] for k in names])]))
        parts = iter(flat.split([g.numel() for g in live] + [len(names)]))
        grads = [None if g is None else next(parts).view_as(g) for g in grads]
        return grads, dict(zip(names, next(parts).unbind()))

    def __call__(self, state: TrainState, frame, flow_cache, draws=None):
        draws = self.draw() if draws is None else draws
        grads, metrics = self.grads(state.params, frame, flow_cache, draws, state.step)
        self.opt.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, metrics


def make_train_step(field, opt, loss_cfg: LossConfig, *, H, W, fov_lidar, num_rays=1024,
                    num_steps=768, patch_size=1, num_coarse=0, num_fine=0, seed=0,
                    generators=None, mesh=None):
    """Build the train step of one sampling mode (see `TrainStep`). It draws
    from `generators`, a (device, host) pair of torch.Generators that several
    steps may share, or from its own pair seeded with `seed`; with `mesh`
    the batch's rays are split over its ranks."""
    return TrainStep(field, opt, loss_cfg, H=H, W=W, fov_lidar=fov_lidar, num_rays=num_rays,
                     num_steps=num_steps, patch_size=patch_size, num_coarse=num_coarse,
                     num_fine=num_fine, seed=seed, generators=generators, mesh=mesh)
