"""Training orchestration: epochs, evaluation, checkpoints, refine, test.

Port of `lidar4d_tpu/train/trainer.py` (the reference's `Trainer`,
`model/runner.py:32-1073`):
  * train / train_one_epoch: the patch size alternates by epoch, the first
    `hier_warmup_iters` steps take the uniform sampler and the rest
    hierarchical sampling, one train step per (H, W, patch, sampler); the
    EMA and a parameter finiteness check once an epoch; a full checkpoint
    every `ckpt_interval` epochs and at the last; evaluation every
    `eval_interval` epochs;
  * evaluate_one_epoch: the EMA weights, a full-frame render of each frame,
    the optional U-Net refine, the eval-time composite loss, the four meters
    and, where cv2 exists, validation panels; best = the lowest CD;
  * test: point-cloud npys, and PNGs or videos where cv2 / imageio exist;
  * refine: the U-Net on every train frame's render (`train.refine`).

Ray parallelism (`--num_devices` / `--mesh` / `--num_hosts`, as the JAX
trainer reads them): in a process group of N ranks, one a device, every
rank runs this Trainer alike on its own device; the steps split each batch
and the renders each chunk over the ranks (`parallel.mesh`); parameters,
EMA and the flow cache are rank 0's, broadcast; rank 0 alone writes logs,
metrics, panels, checkpoints and test outputs, the others waiting for it
after each checkpoint. The U-Net refine trains on every rank (so that none
waits minutes in a collective) and rank 0's is broadcast: its card
convolutions are not deterministic, so the ranks' U-Nets drift apart.

What the JAX trainer does only for its own framework is left out:
`jax.profiler` (`--profile` traces with `torch.profiler`); the orbax
checkpoint layouts and their legacy-optimizer fallbacks (one `torch.save`
layout here, which a params-only restore reads too). The first step of a new
step variant still runs before the epoch clock starts: there it hides the
XLA compile, here the kernels' first launch. Where the JAX trainer moves a
frame to the device every step, the port keeps each split's frames on the
device.
"""

import functools
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from lidar4d_tpu_torch.interop import tree_leaves, tree_map, tree_paths
from lidar4d_tpu_torch.models.renderer import frame_chunk, render_staged
from lidar4d_tpu_torch.ops.pano import pano_to_lidar
from lidar4d_tpu_torch.ops.rays import get_lidar_rays
from lidar4d_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    make_hierarchical_mesh,
    make_mesh,
    replicate,
)
from lidar4d_tpu_torch.train.checkpoints import CheckpointManager
from lidar4d_tpu_torch.train.ema import EmaState, ema_init, ema_params, ema_update
from lidar4d_tpu_torch.train.flow_cache import build_flow_cache
from lidar4d_tpu_torch.train.losses import elementwise_loss
from lidar4d_tpu_torch.train.optimizer import AdamState
from lidar4d_tpu_torch.train.refine import refine_unet
from lidar4d_tpu_torch.train.train_step import (
    flow_cache_to_device,
    init_train_state,
    make_train_step,
)


@functools.lru_cache(maxsize=None)
def _cv2():
    """cv2 where it is installed, else None; looked up once, since a failed
    import searches the whole path again every time."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _same_shapes(a, b):
    return tree_map(lambda t: tuple(t.shape), a) == tree_map(lambda t: tuple(t.shape), b)


def mesh_from_options(opt):
    """The ray-parallel layout of --num_devices / --mesh / --num_hosts: None
    for one device (--num_devices 0 or 1 without a process group, or a
    group of one); else every rank of the process group, one a device, 1-D
    or (dcn, ici)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = getattr(opt, "num_devices", 0) or world
    if world > 1 and n_dev != world:
        raise ValueError(f"--num_devices {n_dev} in a process group of {world} ranks: one rank "
                         f"a device, so give 0 or {world}")
    if n_dev <= 1:
        return None
    if getattr(opt, "mesh", "dp") == "dcn,ici":
        return make_hierarchical_mesh(n_hosts=getattr(opt, "num_hosts", 0) or 0)
    return make_mesh(n_dev)


class Trainer:
    def __init__(
        self,
        name,
        opt,              # parsed options namespace (cli.config)
        field,            # LiDAR4DField, on the device to train on
        loss_cfg,
        workspace="workspace",
        lidar_metrics=(),
        use_checkpoint="latest",
        ema_decay=0.95,
        eval_interval=50,
        max_keep_ckpt=1,
        seed=0,
    ):
        self.name = name
        self.opt = opt
        self.field = field
        self.device = field.device
        self.loss_cfg = loss_cfg
        self.workspace = workspace
        self.lidar_metrics = list(lidar_metrics)
        self.ema_decay = ema_decay
        self.eval_interval = eval_interval
        self.use_refine = True
        # True once the U-Net has been trained in this state (refine(), a
        # refine checkpoint or the refine overlay); see _resolve_use_refine
        self._refine_trained = False
        self.mesh = mesh_from_options(opt)
        self.is_main = self.mesh is None or self.mesh.rank == 0

        self.ckpt = CheckpointManager(workspace, name=name, max_keep=max_keep_ckpt)
        self.log_path = os.path.join(workspace, f"log_{name}.txt")
        self.metrics_path = os.path.join(workspace, f"metrics_{name}.jsonl")
        self.writer = self._summary_writer() if self.is_main else None

        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [], "best_result": None}
        self.eval_seconds = {}

        self.state, self.optimizer = init_train_state(field, seed, lr=opt.lr, iters=opt.iters)
        self._steps = {}          # (H, W, patch, num_coarse, num_fine) -> train step
        self._warmed = set()      # ids of the steps that have run at least once
        self._rng = np.random.default_rng(seed)
        # (device, host) generators every step variant and the refine draw from
        self._generators = (torch.Generator(device=self.device), torch.Generator())
        for g in self._generators:
            g.manual_seed(seed + 1)
        self._frames = {}         # id(dataset) -> (dataset, its frames on the device)
        self.flow_cache = None

        n_params = sum(p.numel() for p in tree_leaves(self.state.params))
        self.log(f"[INFO] Trainer: {name} | {self.device} | "
                 f"{time.strftime('%Y-%m-%d_%H-%M-%S')} | {workspace}")
        self.log(f"[INFO] #parameters: {n_params}")
        if self.mesh is not None:
            self.log(f"[INFO] ray-parallel over {self.mesh.size} ranks, mesh "
                     f"{dict(zip(self.mesh.axis_names, self.mesh.shape))}")

        if use_checkpoint != "scratch":
            self.load_checkpoint(use_checkpoint)
        # rank 0's state on every rank: the seeded init and a restore of the
        # same file agree already, this holds them to it
        s = self.state
        replicate(self.mesh, [s.params, s.opt_state.mu, s.opt_state.nu, s.ema.shadow])

    # ------------------------------------------------------------------- log
    def _summary_writer(self):
        try:
            import tensorboardX
        except ImportError:
            return None
        return tensorboardX.SummaryWriter(os.path.join(self.workspace, "run", self.name))

    def log(self, *args):
        if not self.is_main:
            return
        msg = " ".join(str(a) for a in args)
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def log_metrics(self, record):
        if not self.is_main:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({k: float(v) if hasattr(v, "item") else v
                                for k, v in record.items()}) + "\n")

    # ------------------------------------------------------------- stepping
    def _sampler(self):
        """(num_steps, num_coarse, num_fine) of the next step: the uniform
        sampler with num_coarse + num_fine samples for the first
        hier_warmup_iters steps (importance sampling needs a usable coarse
        density), then hierarchical sampling."""
        num_coarse = getattr(self.opt, "num_coarse", 0)
        num_fine = getattr(self.opt, "num_fine", 0)
        if num_coarse > 0 and self.global_step < getattr(self.opt, "hier_warmup_iters", 0):
            return num_coarse + num_fine, 0, 0
        return self.opt.num_steps, num_coarse, num_fine

    def _get_step(self, dataset, patch_size):
        num_steps, num_coarse, num_fine = self._sampler()
        key = (dataset.H_lidar, dataset.W_lidar, tuple(np.atleast_1d(patch_size)),
               num_coarse, num_fine)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.field, self.optimizer, self.loss_cfg, H=dataset.H_lidar,
                W=dataset.W_lidar, fov_lidar=tuple(dataset.fov_lidar),
                num_rays=self.opt.num_rays_lidar, num_steps=num_steps,
                patch_size=patch_size, num_coarse=num_coarse, num_fine=num_fine,
                generators=self._generators, mesh=self.mesh)
        return self._steps[key]

    def _next_draws(self, step_fn):
        """One step's random draws (`TrainStep.draw`); the one place a step
        draws, so that a test can feed it another trainer's draws."""
        return step_fn.draw()

    def _device_frames(self, dataset):
        """The split's frames with pose and image on the device, once."""
        held = self._frames.get(id(dataset))
        if held is None or held[0] is not dataset:
            held = self._frames[id(dataset)] = (dataset, [
                {"pose": torch.as_tensor(f["pose"], device=self.device),
                 "image": torch.as_tensor(f["image"], device=self.device),
                 "time": f["time"]}
                for f in (dataset.frame(i) for i in range(len(dataset)))])
        return held[1]

    def _load_or_build_flow_cache(self, refine_ds):
        """The flow loss's point clouds, cached next to the dataset under a
        name that covers everything their contents depend on: sequence,
        subsample cap, scene scale (the clouds are stored world-scaled) and
        frame count."""
        cap = int(getattr(self.opt, "flow_cloud_max_points", 0) or 0)
        path = getattr(self.opt, "path", None)
        seq = getattr(self.opt, "sequence_id", "seq")
        scale_tag = f"{float(self.opt.scale):.8g}"
        nf = int(getattr(self.opt, "num_frames", 0) or 0)
        cache_file = (os.path.join(path, f"flow_cache_{seq}_cap{cap}_s{scale_tag}_f{nf}.npz")
                      if path and os.path.isdir(path) else None)
        if cache_file and os.path.exists(cache_file):
            z = np.load(cache_file)
            return {k: z[k] for k in z.files}
        cache = build_flow_cache(refine_ds, self.opt.scale, self.opt.num_frames,
                                 verbose=False, max_points=cap)
        if cache_file:
            try:
                np.savez_compressed(cache_file, **cache)
            except OSError as e:
                self.log(f"[WARN] flow cache not saved: {e}")
        return cache

    # ----------------------------------------------------------------- train
    def train(self, train_ds, valid_ds, refine_ds, max_epochs, run_refine=True):
        if self.loss_cfg.flow_loss and self.flow_cache is None:
            self.log("Preparing Point Clouds ...")
            cache = self._load_or_build_flow_cache(refine_ds) if self.is_main else None
            self.flow_cache = flow_cache_to_device(broadcast_object(self.mesh, cache),
                                                   self.device)

        change = np.atleast_1d(self.opt.change_patch_size_lidar)[0] > 1
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            if change and epoch % self.opt.change_patch_size_epoch == 0:
                patch = tuple(self.opt.change_patch_size_lidar)
            else:
                patch = 1
            self.train_one_epoch(train_ds, patch)

            ckpt_every = max(1, int(getattr(self.opt, "ckpt_interval", 1)))
            if epoch % ckpt_every == 0 or epoch == max_epochs:
                self.save_checkpoint()

            if epoch % self.eval_interval == 0:
                self.use_refine = False
                self.evaluate_one_epoch(valid_ds)
                self.save_checkpoint(best=True)

        if run_refine:
            self.refine(refine_ds)

    def _profiler(self):
        """A torch.profiler context for --profile's epoch 2 (rank 0's), else
        None."""
        if not (getattr(self.opt, "profile", False) and self.epoch == 2 and self.is_main):
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        return profile(activities=acts)

    def train_one_epoch(self, dataset, patch_size):
        sampler = "uniform" if self._sampler()[1] == 0 else "hierarchical"
        step_fn = self._get_step(dataset, patch_size)
        frames = self._device_frames(dataset)
        order = dataset.epoch_order(self._rng)
        last_metrics = None

        # the first step of a new step variant runs before the epoch clock
        # starts, so the logged rays/s is the steady state's
        if id(step_fn) not in self._warmed and len(order) > 1:
            self.state, metrics = step_fn(self.state, frames[int(order[0])], self.flow_cache,
                                          self._next_draws(step_fn))
            float(metrics["loss"])
            self._warmed.add(id(step_fn))
            self.global_step += 1
            order = order[1:]
        t0 = time.perf_counter()

        prof = self._profiler()
        if prof is not None:
            prof.__enter__()
        for i in order:
            self.state, last_metrics = step_fn(self.state, frames[int(i)], self.flow_cache,
                                               self._next_draws(step_fn))
            self.global_step += 1
        loss_val = float(last_metrics["loss"])        # waits for the last step
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            trace = os.path.join(self.workspace, "profile", f"epoch{self.epoch}.json")
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            prof.export_chrome_trace(trace)
            self.log(f"[INFO] profile trace saved to {trace}")
        rays_per_sec = len(order) * self.opt.num_rays_lidar / max(dt, 1e-9)

        # EMA once an epoch (runner.py:534-535)
        self.state.ema = ema_update(self.state.ema, self.state.params, self.ema_decay)
        # finite printed losses do not imply finite parameters: halt at the
        # poisoned epoch, before its checkpoint overwrites the last good one
        self._assert_params_finite()
        self.stats["loss"].append(loss_val)
        patch = "x".join(str(int(p)) for p in np.atleast_1d(patch_size))
        self.log(f"==> Epoch {self.epoch} | loss {loss_val:.4f} | {rays_per_sec:,.0f} rays/s | "
                 f"step {self.global_step} | {sampler} sampler, patch {patch}")
        self.log_metrics({"epoch": self.epoch, "loss": loss_val, "rays_per_sec": rays_per_sec,
                          "sampler": sampler, "patch": patch})
        if self.writer is not None:
            self.writer.add_scalar("train/loss", loss_val, self.global_step)
            self.writer.add_scalar("train/rays_per_sec", rays_per_sec, self.global_step)

    def _assert_params_finite(self):
        leaves = [p for p in tree_leaves(self.state.params) if p.is_floating_point()]
        if bool(torch.stack([torch.isfinite(p).all() for p in leaves]).all()):
            return
        bad = [n for n, p in zip(tree_paths(self.state.params), tree_leaves(self.state.params))
               if p.is_floating_point() and not bool(torch.isfinite(p).all())]
        msg = (f"non-finite parameters after epoch {self.epoch} (step {self.global_step}): "
               f"{bad} - halting before the epoch checkpoint. Finite printed losses do NOT "
               "imply finite parameters.")
        self.log(f"[ERROR] {msg}")
        raise RuntimeError(msg)

    # ------------------------------------------------------------------ eval
    def _eval_params(self):
        return ema_params(self.state.ema) if self.state.ema.num_updates > 0 \
            else self.state.params

    def _render_frame(self, params, dataset, i):
        """(raydrop, intensity, depth) [H, W] numpy of frame i."""
        H, W = dataset.H_lidar, dataset.W_lidar
        frame = dataset.frame(i)
        rays = get_lidar_rays(torch.as_tensor(frame["pose"], device=self.device),
                              dataset.intrinsics_lidar, H, W, N=-1)
        out = render_staged(self.field, params, rays["rays_o"], rays["rays_d"],
                            np.float32(frame["time"]), num_steps=self.opt.num_steps,
                            chunk=frame_chunk(self.field),
                            num_coarse=getattr(self.opt, "num_coarse", 0),
                            num_fine=getattr(self.opt, "num_fine", 0), mesh=self.mesh)
        image = out["image_lidar"].cpu().numpy()
        return (image[:, 0].reshape(H, W), image[:, 1].reshape(H, W),
                out["depth_lidar"].cpu().numpy().reshape(H, W))

    @torch.no_grad()
    def _apply_refine(self, params, raydrop, intensity, depth):
        x = torch.as_tensor(np.stack([raydrop, intensity, depth])[None], device=self.device)
        return self.field.unet.apply(params["unet"], x)[0, 0].cpu().numpy()

    def evaluate_one_epoch(self, dataset, name=None):
        self.log(f"++> Evaluate at epoch {self.epoch} ...")
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"
        for m in self.lidar_metrics:
            m.clear()
        params = self._eval_params()

        # the eval-time composite loss (runner.py:418-424, 589-594): the train
        # criteria mean-reduced per frame, predictions masked by the
        # thresholded ray-drop
        cfg = self.loss_cfg
        depth_crit = elementwise_loss(cfg.depth_loss, cfg.scale)
        raydrop_crit = elementwise_loss(cfg.raydrop_loss, cfg.scale)
        intensity_crit = elementwise_loss(cfg.intensity_loss, cfg.scale)

        def mean_loss(crit, a, b):
            return float(torch.mean(crit(torch.from_numpy(a), torch.from_numpy(b))))

        total_loss = 0.0
        t_phase = {"render": 0.0, "refine": 0.0, "loss": 0.0, "meters": 0.0, "panel": 0.0}
        for i in range(len(dataset)):
            img = np.asarray(dataset.images_lidar[i])
            gt_raydrop = img[..., 0]
            gt_intensity = img[..., 1] * gt_raydrop
            gt_depth = img[..., 2] * gt_raydrop

            t0 = time.perf_counter()
            raydrop, intensity, depth = self._render_frame(params, dataset, i)
            if self.opt.raydrop_loss == "bce":
                raydrop = 1 / (1 + np.exp(-raydrop))
            t1 = time.perf_counter()
            if self.use_refine:
                raydrop = self._apply_refine(params, raydrop, intensity, depth)
            mask = (raydrop > 0.5).astype(np.float32)
            t2 = time.perf_counter()

            total_loss += (cfg.alpha_d * mean_loss(depth_crit, depth * mask, gt_depth)
                           + cfg.alpha_r * mean_loss(raydrop_crit, raydrop, gt_raydrop)
                           + cfg.alpha_i * mean_loss(intensity_crit, intensity * mask,
                                                     gt_intensity))
            t3 = time.perf_counter()

            for mi, meter in enumerate(self.lidar_metrics):
                tm = time.perf_counter()
                if mi == 0:
                    meter.update(raydrop[None], gt_raydrop[None])
                elif mi == 1:
                    meter.update((intensity * mask)[None], gt_intensity[None])
                else:
                    meter.update((depth * mask)[None], gt_depth[None])
                tag = getattr(meter, "tag", type(meter).__name__)
                t_phase[f"m:{tag}"] = t_phase.get(f"m:{tag}", 0.0) + time.perf_counter() - tm
            t4 = time.perf_counter()

            self._save_validation_panel(name, i + 1, raydrop, intensity, depth, mask)
            t5 = time.perf_counter()
            for k, a, b in (("render", t0, t1), ("refine", t1, t2), ("loss", t2, t3),
                            ("meters", t3, t4), ("panel", t4, t5)):
                t_phase[k] += b - a

        self.eval_seconds = dict(t_phase, frames=len(dataset))
        self.log("    eval time: " + " ".join(f"{k} {v:.1f}s" for k, v in t_phase.items()))

        average_loss = total_loss / max(len(dataset), 1)
        self.stats["valid_loss"].append(average_loss)
        if self.lidar_metrics:
            self.stats["results"].append(float(self.lidar_metrics[-1].measure()[0]))  # CD
        else:
            self.stats["results"].append(average_loss)
        eval_record = {"epoch": self.epoch, "valid_loss": average_loss}
        for meter in self.lidar_metrics:
            self.log(meter.report())
            if self.writer is not None:
                meter.write(self.writer, self.global_step, prefix="evaluate")
            tag = getattr(meter, "tag", type(meter).__name__)
            eval_record[tag] = [float(v) for v in np.atleast_1d(meter.measure())]
            if hasattr(meter, "lpips_calibrated"):
                # surrogate-mode LPIPS never passes for the published LPIPS
                eval_record[f"{tag}_lpips_calibrated"] = bool(meter.lpips_calibrated)
        self.log_metrics(eval_record)
        if self.writer is not None:
            self.writer.add_scalar("evaluate/loss", average_loss, self.global_step)
        self.log(f"++> Evaluate epoch {self.epoch} Finished. valid_loss {average_loss:.4f}")

    def _save_validation_panel(self, name, idx, raydrop, intensity, depth, mask):
        cv2 = _cv2()
        if cv2 is None or not self.is_main:
            return
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)

        def cm(x, cmap):
            return cv2.applyColorMap((np.clip(x, 0, 1) * 255).astype(np.uint8), cmap)

        img_raydrop = cv2.cvtColor((np.clip(raydrop, 0, 1) * 255).astype(np.uint8),
                                   cv2.COLOR_GRAY2BGR)
        img_mask = cv2.cvtColor((mask * 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
        panel = cv2.vconcat([img_raydrop, cm(intensity, 1), cm(depth, 20),
                             img_mask, cm(intensity * mask, 1), cm(depth * mask, 20)])
        cv2.imwrite(os.path.join(out_dir, f"{name}_{idx:04d}.png"), panel)

    def _resolve_use_refine(self, refine):
        """Downgrade a use_refine request when the U-Net was never trained:
        `--test_eval` after a `--train_only` run would otherwise mask every
        prediction with a random-init U-Net (the reference has the same hole,
        runner.py:413-416). Warn and evaluate unrefined instead."""
        if refine and not self._refine_trained:
            self.log("[WARN] use_refine requested but the U-Net has never been trained "
                     "(no refine stage ran, no refine checkpoint found) - an untrained "
                     "refiner masks depth/intensity with noise. Evaluating with "
                     "use_refine=False; run --refine first for refined metrics.")
            return False
        return refine

    def evaluate(self, dataset, name=None, refine=True):
        self.use_refine = self._resolve_use_refine(refine)
        self.evaluate_one_epoch(dataset, name)

    # ------------------------------------------------------------------ test
    def test(self, dataset, save_path=None, name=None, write_video=True, refine=True):
        """Render the test split: npy point clouds always, and mp4 videos
        (write_video, runner.py:783-815) or per-frame PNGs where cv2 exists."""
        if save_path is None:
            save_path = os.path.join(self.workspace, "results")
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"
        if self.is_main:
            os.makedirs(save_path, exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        self.use_refine = self._resolve_use_refine(refine)
        params = self._eval_params()
        cv2 = _cv2()
        all_preds, all_preds_depth = [], []

        for i in range(len(dataset)):
            raydrop, intensity, depth = self._render_frame(params, dataset, i)
            if not self.is_main:
                continue
            if self.opt.raydrop_loss == "bce":
                raydrop = 1 / (1 + np.exp(-raydrop))
            if self.use_refine:
                raydrop = self._apply_refine(params, raydrop, intensity, depth)
            mask = (raydrop > 0.5).astype(np.float32)
            if self.opt.alpha_r > 0:
                intensity = intensity * mask
                depth = depth * mask

            pred_lidar = pano_to_lidar(depth / self.opt.scale, dataset.intrinsics_lidar)
            np.save(os.path.join(save_path, f"test_{name}_{i + 1:04d}_depth_lidar.npy"),
                    pred_lidar)
            if cv2 is None:
                continue
            u8_intensity = (np.clip(intensity, 0, 1) * 255).astype(np.uint8)
            u8_depth = (np.clip(depth, 0, 1) * 255).astype(np.uint8)
            if write_video:
                all_preds.append(cv2.cvtColor(cv2.applyColorMap(u8_intensity, 1),
                                              cv2.COLOR_BGR2RGB))
                all_preds_depth.append(cv2.cvtColor(cv2.applyColorMap(u8_depth, 20),
                                                    cv2.COLOR_BGR2RGB))
            else:
                stem = os.path.join(save_path, f"test_{name}_{i + 1:04d}")
                cv2.imwrite(f"{stem}_raydrop.png", (mask * 255).astype(np.uint8))
                cv2.imwrite(f"{stem}_intensity.png", cv2.applyColorMap(u8_intensity, 1))
                cv2.imwrite(f"{stem}_depth.png", cv2.applyColorMap(u8_depth, 20))

        if write_video and all_preds:
            self._write_video(os.path.join(save_path, f"{name}_lidar_rgb.mp4"),
                              np.stack(all_preds, axis=0))
            self._write_video(os.path.join(save_path, f"{name}_depth.mp4"),
                              np.stack(all_preds_depth, axis=0))
        self.log("==> Finished Test.")

    def _write_video(self, path, frames, fps=25):
        """imageio mp4 writer (runner.py:805-815); the frames go to an npz
        where imageio or its ffmpeg backend is missing."""
        try:
            import imageio

            imageio.mimwrite(path, frames, fps=fps, quality=8, macro_block_size=1)
            self.log(f"[INFO] wrote video {path}")
        except Exception as e:  # noqa: BLE001 - imageio or ffmpeg missing
            alt = path + ".npz"
            np.savez_compressed(alt, frames=frames, fps=fps)
            self.log(f"[WARN] mp4 writer unavailable ({e}); frames -> {alt}")

    # ---------------------------------------------------------------- refine
    def refine(self, dataset):
        # copy the EMA weights in and DROP the EMA (runner.py:819-821): the
        # U-Net is trained only here, so its EMA shadow is still the random
        # init, and a later eval through ema_params would run an untrained
        # refiner
        if self.state.ema.num_updates > 0:
            ema_in = ema_params(self.state.ema)
            self.state.params = ema_in
            self.state.ema = ema_init(ema_in)
        params = self.state.params

        self.log("Preparing for Raydrop Refinement ...")
        inputs, gts = [], []
        for i in range(len(dataset)):
            raydrop, intensity, depth = self._render_frame(params, dataset, i)
            inputs.append(np.stack([raydrop, intensity, depth]))
            gts.append(np.asarray(dataset.images_lidar[i][..., 0])[None])
        inputs = torch.as_tensor(np.stack(inputs), device=self.device)   # [B, 3, H, W]
        gts = torch.as_tensor(np.stack(gts), device=self.device)         # [B, 1, H, W]

        self.log("Start UNet Optimization ...")
        params["unet"] = refine_unet(self.field.unet, params["unet"], inputs, gts,
                                     steps=1000, lr=1e-3, generator=self._generators[0],
                                     log_fn=self.log)
        replicate(self.mesh, params["unet"])
        self._refine_trained = True
        if self.is_main:
            self.ckpt.save_refine({"params": params, "epoch": self.epoch}, self.epoch)
        barrier(self.mesh)

    # ----------------------------------------------------------- checkpoints
    def _full_state_tree(self):
        s = self.state
        return {
            "state": {"params": s.params,
                      "opt_state": {"mu": s.opt_state.mu, "nu": s.opt_state.nu,
                                    "count": s.opt_state.count},
                      "ema": {"shadow": s.ema.shadow, "num_updates": s.ema.num_updates},
                      "step": s.step},
            "epoch": self.epoch,
            "global_step": self.global_step,
            "best_result": -1.0 if self.stats["best_result"] is None
            else float(self.stats["best_result"]),
        }

    def save_checkpoint(self, best=False):
        """Rank 0 writes; every rank waits for it."""
        self._save_checkpoint(best)
        barrier(self.mesh)

    def _save_checkpoint(self, best):
        if not best:
            if self.is_main:
                self.ckpt.save_epoch(self._full_state_tree(), self.epoch)
            return
        if not self.stats["results"]:
            self.log("[WARN] no evaluated results found, skip saving best checkpoint.")
            return
        latest = self.stats["results"][-1]
        # a non-finite result never becomes the best checkpoint (the reference
        # has no such guard, model/runner.py:661-668)
        if not np.isfinite(latest):
            self.log(f"[ERROR] eval result {latest} is non-finite; refusing to save a best "
                     "checkpoint from a poisoned eval.")
            return
        if self.stats["best_result"] is None or latest < self.stats["best_result"]:
            self.log(f"[INFO] New best result: {self.stats['best_result']} --> {latest}")
            self.stats["best_result"] = latest
            # best stores the EMA weights (runner.py:998-1008)
            if self.is_main:
                self.ckpt.save_best({"params": ema_params(self.state.ema), "epoch": self.epoch,
                                     "global_step": self.global_step})

    def _checked_params(self, path, params):
        if not _same_shapes(params, self.state.params):
            raise ValueError(f"checkpoint {path} params tree does not match the model config")
        return params

    def load_checkpoint(self, which="latest", model_only=False):
        include_refine = which == "latest_model" or str(which).endswith("_refine")
        path = self.ckpt.resolve(which, include_refine=include_refine)
        if path is None:
            self.log("[WARN] No checkpoint found, model randomly initialized.")
            return
        self.log(f"[INFO] Loading checkpoint {path} ...")
        tree = self.ckpt.restore(path, self.device)
        if path.endswith("_refine") or os.path.basename(path).endswith("_best"):
            self.state.params = self._checked_params(path, tree["params"])
            self.epoch = int(tree.get("epoch", 0))
            if path.endswith("_refine"):
                self._refine_trained = True
            self.log("[INFO] loaded model (weights only).")
            return
        if model_only or which == "latest_model":
            self._restore_model_only(path, tree)
            return
        st = tree["state"]
        self.state.params = self._checked_params(path, st["params"])
        self.state.opt_state = AdamState(st["opt_state"]["mu"], st["opt_state"]["nu"],
                                         int(st["opt_state"]["count"]))
        self.state.ema = EmaState(self._checked_params(path, st["ema"]["shadow"]),
                                  int(st["ema"]["num_updates"]))
        self.state.step = int(st["step"])
        self.epoch = int(tree["epoch"])
        self.global_step = int(tree["global_step"])
        best = float(tree["best_result"])
        self.stats["best_result"] = None if best < 0 else best
        self.log(f"[INFO] load at epoch {self.epoch}, global step {self.global_step}")
        if which == "latest":
            self._overlay_refine_checkpoint()

    def _restore_model_only(self, path, tree):
        """Parameters and EMA of an epoch checkpoint, without its optimizer
        state (the optimizer starts afresh)."""
        st = tree["state"]
        params = self._checked_params(path, st["params"])
        self.state.params = params
        self.state.ema = EmaState(self._checked_params(path, st["ema"]["shadow"]),
                                  int(st["ema"]["num_updates"]))
        self.epoch = int(tree.get("epoch", 0))
        self.global_step = int(tree.get("global_step", 0))
        best = float(tree.get("best_result", -1.0))
        self.stats["best_result"] = None if best < 0 else best
        self.log(f"[INFO] loaded model at epoch {self.epoch}, global step "
                 f"{self.global_step} (params+EMA only).")

    def _overlay_refine_checkpoint(self):
        """If a refine checkpoint at or after the restored epoch exists, lay
        its parameters (the trained U-Net among them) over the restored state
        and drop the EMA, as the in-process refine() hands over. Without it a
        standalone `--test_eval` after a whole run would evaluate the full
        checkpoint's EMA, whose U-Net is still the random init."""
        newest = self.ckpt.latest_path(include_refine=True)
        if newest is None or not newest.endswith("_refine"):
            return
        tree = self.ckpt.restore(newest, self.device)
        if int(tree.get("epoch", 0)) < self.epoch:
            return  # a stale refine from an earlier schedule
        params = self._checked_params(newest, tree["params"])
        self.state.params = params
        self.state.ema = ema_init(params)
        self._refine_trained = True
        self.log(f"[INFO] overlaid refine checkpoint {newest} (EMA dropped).")
