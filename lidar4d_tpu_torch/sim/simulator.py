"""Novel space-time LiDAR simulator.

Port of `lidar4d_tpu/sim/simulator.py`: renders a field along a (novel)
trajectory at any sensor configuration (fov / H / W), optionally refines the
ray-drop mask with the U-Net, and back-projects each frame to a point cloud.
Writing point clouds, image panels and a video is optional; `cv2` and
`imageio` are imported only when images or a video are asked for, and the
images and the video are best-effort as in the reference: without `cv2`
none is made, and a failed video write warns. The point clouds always come
back.
"""

import os
import warnings

import numpy as np
import torch

from lidar4d_tpu_torch.models.renderer import frame_chunk, render_frames_staged
from lidar4d_tpu_torch.ops._cuda import resolve_device
from lidar4d_tpu_torch.ops.pano import pano_to_lidar_with_intensities
from lidar4d_tpu_torch.ops.rays import pano_ray_directions


def build_novel_rays(poses, H, W, fov_lidar):
    """Full-frame ray grids for poses [B, 4, 4] at a sensor config.
    Returns numpy rays_o, rays_d [B, H*W, 3]."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    dirs = pano_ray_directions(i.reshape(-1), j.reshape(-1), H, W, *fov_lidar)
    rays_d = np.einsum("nk,bjk->bnj", dirs, poses[:, :3, :3])
    rays_o = np.broadcast_to(poses[:, None, :3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def shift_trajectory(rays_o, shift_x, shift_y, shift_z, scale, align_axis=False):
    """Translate ray origins, optionally aligning x to the motion direction."""
    out = rays_o.copy()
    forward = np.array([1.0, 0.0, 0.0])
    B = rays_o.shape[0]
    for i in range(B):
        sx, sy = shift_x, shift_y
        if align_axis:
            if i < B - 1:
                delta = rays_o[i + 1, 0] - rays_o[i, 0]
                n = np.linalg.norm(delta)
                if n > 1e-9:
                    forward = delta / n
            left = np.array([-forward[1], forward[0], forward[2]])
            v = shift_x * forward + shift_y * left
            sx, sy = v[0], v[1]
        out[i, :, 0] += sx * scale
        out[i, :, 1] += sy * scale
        out[i, :, 2] += shift_z * scale
    return out


class Simulator:
    def __init__(self, name, opt, field, params, workspace="simulation",
                 use_refine=True, H_lidar=66, W_lidar=1030, device="cuda"):
        self.name = name
        self.opt = opt
        self.field = field
        self.params = params
        self.workspace = workspace
        self.use_refine = use_refine
        self.H_lidar, self.W_lidar = H_lidar, W_lidar
        self.device = resolve_device(device)

    @torch.no_grad()
    def _refine(self, raydrop, intensity, depth):
        x = torch.stack([raydrop, intensity, depth])[None]
        return self.field.unet.apply(self.params["unet"], x)[0, 0]

    def render(self, rays_o, rays_d, times, save_pc=True, save_img=True,
               save_video=True, mesh=None, frame_batch=8):
        """rays_o / rays_d: [B, H*W, 3]; times: [B] in [0, 1].

        Renders `frame_batch` frames per `render_frames_staged` call, in the
        reference's chunk of rays for the field (`frame_chunk`). With
        `mesh` (every rank calls this alike, with its own device) each
        frame's rays are split over the ranks, every rank gets the whole
        frame, and rank 0 alone writes files.
        Returns the last frame's point cloud [M, 4] (xyz + intensity).
        """
        if mesh is not None and mesh.rank != 0:
            save_pc = save_img = save_video = False
        H, W = self.H_lidar, self.W_lidar
        b_total = rays_o.shape[0]
        video = []
        pred_lidar = None
        for s in range(0, b_total, frame_batch):
            out = render_frames_staged(
                self.field, self.params, rays_o[s:s + frame_batch],
                rays_d[s:s + frame_batch], np.asarray(times[s:s + frame_batch], np.float32),
                num_steps=self.opt.num_steps,
                num_coarse=getattr(self.opt, "num_coarse", 0),
                num_fine=getattr(self.opt, "num_fine", 0),
                chunk=frame_chunk(self.field), device=self.device, mesh=mesh,
            )
            for k in range(out["depth_lidar"].shape[0]):
                i = s + k
                raydrop = out["image_lidar"][k, :, 0].reshape(H, W)
                intensity = out["image_lidar"][k, :, 1].reshape(H, W)
                depth = out["depth_lidar"][k].reshape(H, W)
                if self.use_refine:
                    raydrop = self._refine(raydrop, intensity, depth)
                raydrop = raydrop.cpu().numpy()
                depth = depth.cpu().numpy()
                intensity = intensity.cpu().numpy()
                mask = (raydrop > 0.5).astype(np.float32)
                intensity = intensity * mask
                depth = depth * mask

                pred_lidar = pano_to_lidar_with_intensities(
                    depth / self.opt.scale, intensity, self.opt.fov_lidar)
                if save_pc:
                    d = os.path.join(self.workspace, "points")
                    os.makedirs(d, exist_ok=True)
                    np.save(os.path.join(d, f"lidar4d_{i:04d}.npy"), pred_lidar)
                panel = _panel(raydrop, intensity, depth) if save_img or save_video else None
                if panel is not None:
                    import cv2

                    if save_img:
                        d = os.path.join(self.workspace, "images")
                        os.makedirs(d, exist_ok=True)
                        cv2.imwrite(os.path.join(d, f"lidar4d_{i:04d}.png"), panel)
                    if save_video:
                        video.append(cv2.cvtColor(panel, cv2.COLOR_BGR2RGB))

        if save_video and video:
            try:
                import imageio

                d = os.path.join(self.workspace, "video")
                os.makedirs(d, exist_ok=True)
                imageio.mimwrite(os.path.join(d, "lidar4d_sim.mp4"), np.stack(video),
                                 fps=5, quality=8, macro_block_size=1)
            except Exception as e:  # the video is best-effort, as in the reference
                warnings.warn(f"video write failed: {e!r}")
        return pred_lidar


def _panel(raydrop, intensity, depth):
    """Stacked raydrop / intensity / depth colour panel (BGR, uint8), or
    None without cv2 (images and video are then skipped, as in the
    reference)."""
    try:
        import cv2
    except ImportError:
        return None
    img_raydrop = cv2.cvtColor(
        (np.clip(raydrop, 0, 1) * 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    img_intensity = cv2.applyColorMap((np.clip(intensity, 0, 1) * 255).astype(np.uint8), 1)
    img_depth = cv2.applyColorMap((np.clip(depth, 0, 1) * 255).astype(np.uint8), 20)
    return cv2.vconcat([img_raydrop, img_intensity, img_depth])
