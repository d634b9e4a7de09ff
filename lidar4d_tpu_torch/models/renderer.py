"""LiDAR volume renderer: the training ray render and the chunked renders.

Port of `lidar4d_tpu/models/renderer.py`: uniform or hierarchical (coarse +
inverse-CDF fine) sampling, training-time jitter, alpha compositing, and
the chunked full-frame inference renders (under `torch.no_grad()`). The
reference's TPU rewrites of `sample_pdf`'s lookups (one-hot contraction) and `merge_sorted` (rank
arithmetic) are proven bitwise-equal to a gather and a stable argsort
(tests/test_models.py), so this port uses `torch.searchsorted`,
`torch.gather` and `torch.sort(stable=True)` directly. That holds for
finite values: a +inf sigma (the density head's input above ~88.7)
becomes NaN for every sample of its ray in the reference's one-hot merge
(0 * inf) and stays +inf here, as in the reference's argsort path
(tests/test_torch_density_overflow.py). The reference's
host-loop twin `render_staged_host` existed only to dodge a TPU fault; here
it is another name of the one chunk loop, `render_staged`. The reference's
`density_chunk` / `remat_density`, a TPU memory policy, has no counterpart
either: each density call takes all samples of a ray chunk (16,384 rays x
256 fine samples = 4.2 M points on the flagship config, 4,096 rays x 768 =
3.1 M on the reference config) and of a train batch; PERF.md records the
peak device memory this costs.
"""

import torch

from lidar4d_tpu_torch.ops._cuda import resolve_device
from lidar4d_tpu_torch.parallel.mesh import gather_rays, shard_rays


def sample_pdf(z_mid, weights, n_samples, u_jitter=None):
    """Inverse-CDF importance sampling of z values.

    z_mid [N, C] sorted bin centres, weights [N, C] -> [N, n_samples] z
    (sorted per ray). u_jitter: None for the midpoints u = (i + 0.5) / S, or
    U(0, 1) draws [N, S] for stratified jitter, u += (draw - 0.5) / S
    clipped to [1e-6, 1 - 1e-6] (reference `sample_pdf` with a key).
    """
    n, c = weights.shape
    pdf = weights + 1e-5
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)     # [N, C+1]

    u = (torch.arange(n_samples, dtype=torch.float32, device=z_mid.device) + 0.5) / n_samples
    u = u.expand(n, n_samples)
    if u_jitter is not None:
        u = torch.clamp(u + (u_jitter - 0.5) / n_samples, 1e-6, 1.0 - 1e-6)
    u = u.contiguous()
    # count of cdf entries <= u, minus one (cdf is nondecreasing)
    below = torch.searchsorted(cdf, u, right=True) - 1
    below = torch.clamp(below, 0, c - 1)

    z_shift = torch.cat([z_mid[:, 1:], z_mid[:, -1:]], dim=-1)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, below + 1)
    z_lo = torch.gather(z_mid, 1, below)
    z_hi = torch.gather(z_shift, 1, below)
    denom = torch.clamp(cdf_hi - cdf_lo, min=1e-8)
    frac = (u - cdf_lo) / denom
    return z_lo + frac * (z_hi - z_lo)


def merge_sorted(z_a, z_b, values):
    """Merge two per-ray sorted z arrays and co-sort per-sample values.

    Stable: ties keep a-before-b and original order within each input.
    values: arrays [N, A+B] or [N, A+B, F] in (a, b) order.
    """
    z_all = torch.cat([z_a, z_b], dim=-1)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    outs = []
    for v in values:
        v = v.to(z_a.dtype)
        if v.ndim == 2:
            outs.append(torch.gather(v, 1, order))
        else:
            outs.append(torch.gather(v, 1, order[..., None].expand(-1, -1, v.shape[2])))
    return z_sorted, outs


def _composite_weights(cfg, sigma, z_vals, sample_dist):
    """Alpha compositing weights. sigma / z_vals [N, T]."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], sample_dist)], dim=-1)
    exponent = 2.0 if cfg.active_sensor else 1.0
    alphas = 1.0 - torch.exp(-exponent * deltas * cfg.density_scale * sigma)
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-15], dim=-1)
    return alphas * torch.cumprod(shifted, dim=-1)[:, :-1]


def _query_density(field, params, rays_o, rays_d, z_vals, t, bound):
    n, steps = z_vals.shape
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    xyz = torch.clamp(xyz, -bound, bound).reshape(-1, 3)
    dens = field.density(params, xyz, t)
    return dens["sigma"].reshape(n, steps), dens["geo_feat"].reshape(n, steps, -1)


def render_draws(n, num_steps, num_coarse, num_fine, generator, device):
    """The U(0, 1) draws of one perturbed render: z jitter [n, num_coarse]
    (or [n, num_steps] without hierarchical sampling) and, hierarchical,
    sample_pdf's u jitter [n, num_fine]."""
    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    if num_coarse > 0:
        return {"z_jitter": rand(n, num_coarse), "u_jitter": rand(n, num_fine)}
    return {"z_jitter": rand(n, num_steps)}


def render_rays(field, params, rays_o, rays_d, t, num_steps=768, num_coarse=0,
                num_fine=0, perturb=False, with_aux=True, draws=None):
    """Render a batch of rays through the field (differentiable).

    rays_o, rays_d: [N, 3]; t: scalar time in [0, 1]. With num_coarse > 0,
    two-pass hierarchical sampling (num_coarse uniform + num_fine
    inverse-CDF samples, merged; the coarse weights that place the fine
    samples are detached); else num_steps uniform samples. perturb=True
    jitters the z samples by up to half a bin and the inverse-CDF u by up to
    half a stratum, with the U(0, 1) draws `draws` (see `render_draws`).
    Returns dict(depth_lidar [N], image_lidar [N, 2], weights_sum_lidar [N],
    and with with_aux weights [N, T], z_vals [N, T]).
    """
    cfg = field.cfg
    n = rays_o.shape[0]
    near, far = cfg.near_lidar, cfg.far_lidar
    bound = cfg.bound
    dev = rays_o.device

    if num_coarse > 0:
        zc = near + (far - near) * torch.linspace(0.0, 1.0, num_coarse, device=dev)
        zc = zc.expand(n, num_coarse)
        dist_c = (far - near) / num_coarse
        if perturb:
            zc = zc + (draws["z_jitter"] - 0.5) * dist_c
        zc = zc.contiguous()
        sigma_c, geo_c = _query_density(field, params, rays_o, rays_d, zc, t, bound)
        w_c = _composite_weights(cfg, sigma_c.detach(), zc, dist_c)
        zf = sample_pdf(zc, w_c, num_fine, draws["u_jitter"] if perturb else None)
        sigma_f, geo_f = _query_density(field, params, rays_o, rays_d, zf, t, bound)
        z_vals, (sigma, geo) = merge_sorted(
            zc, zf,
            [torch.cat([sigma_c, sigma_f], -1), torch.cat([geo_c, geo_f], 1)],
        )
        num_steps = num_coarse + num_fine
        sample_dist = (far - near) / num_steps
    else:
        z_vals = near + (far - near) * torch.linspace(0.0, 1.0, num_steps, device=dev)
        z_vals = z_vals.expand(n, num_steps)
        sample_dist = (far - near) / num_steps
        if perturb:
            z_vals = z_vals + (draws["z_jitter"] - 0.5) * sample_dist
        z_vals = z_vals.contiguous()
        sigma, geo = _query_density(field, params, rays_o, rays_d, z_vals, t, bound)

    weights = _composite_weights(cfg, sigma, z_vals, sample_dist)
    mask = (weights > 1e-4).reshape(-1)
    dirs = rays_d[:, None, :].expand(n, num_steps, 3).reshape(-1, 3)
    attr = field.attribute(params, dirs, geo.reshape(-1, geo.shape[-1]))
    attr = torch.where(mask[:, None], attr, torch.zeros_like(attr)).reshape(n, num_steps, -1)

    out = {
        "depth_lidar": torch.sum(weights * z_vals, dim=-1),
        "image_lidar": torch.sum(weights[..., None] * attr, dim=-2),
        "weights_sum_lidar": torch.sum(weights, dim=-1),
    }
    if with_aux:
        out["weights"] = weights
        out["z_vals"] = z_vals
    return out


@torch.no_grad()
def render_staged(field, params, rays_o, rays_d, t, num_steps=768, chunk=4096,
                  num_coarse=0, num_fine=0, mesh=None):
    """Full-frame render of rays_o / rays_d [N, 3] in chunks of `chunk` rays.

    With `mesh` (`parallel.mesh`; every rank calls this with the same rays
    and parameters) each chunk's rays are split over the ranks, a chunk that
    does not split evenly padded with rays along +x that are dropped after,
    and the outputs gathered: every rank returns the whole frame.
    """
    depths, images = [], []
    for s in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[s:s + chunk], rays_d[s:s + chunk]
        n = o.shape[0]
        if mesh is not None:
            pad = (-n) % mesh.size
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, o.new_tensor([1.0, 0.0, 0.0]).expand(pad, 3)])
            o, d = shard_rays(mesh, o, d)
        r = render_rays(field, params, o, d, t, num_steps=num_steps, num_coarse=num_coarse,
                        num_fine=num_fine, with_aux=False)
        depth, image = r["depth_lidar"], r["image_lidar"]
        if mesh is not None:
            out = gather_rays(mesh, torch.cat([depth[:, None], image], 1))[:n]
            depth, image = out[:, 0], out[:, 1:]
        depths.append(depth)
        images.append(image)
    return {"depth_lidar": torch.cat(depths), "image_lidar": torch.cat(images)}


# The reference renders gather-path fields through its host-loop twin of
# `render_staged` and one-hot fields through `render_staged`; here both are
# this chunk loop.
render_staged_host = render_staged

# Rays a chunk of the full-frame renders, by the reference's rule (its
# trainer's and its Simulator's): 16,384 for a field inside the one-hot
# window, 4,096 for any other. The chunk changes memory, not results.
ONEHOT_CHUNK, GATHER_CHUNK = 16384, 4096


def frame_chunk(field):
    return ONEHOT_CHUNK if field.in_onehot_window else GATHER_CHUNK


@torch.no_grad()
def render_frames_staged(field, params, rays_o, rays_d, times, num_steps=768,
                         chunk=ONEHOT_CHUNK, num_coarse=0, num_fine=0, device="cuda", mesh=None):
    """Multi-frame render, the simulator's hot path.

    rays_o / rays_d: [B, N, 3] (numpy or tensors), times: B scalars in [0, 1].
    Everything runs on `device` (CUDA unless told otherwise); the field's
    parameters must live there. With `mesh`, each chunk's rays are split
    over its ranks (`render_staged`). Returns depth [B, N] and image
    [B, N, 2].
    """
    device = resolve_device(device)
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=device)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=device)
    times = torch.as_tensor(times, dtype=torch.float32).cpu().numpy()
    outs = [render_staged(field, params, rays_o[b], rays_d[b], times[b],
                          num_steps=num_steps, chunk=chunk, num_coarse=num_coarse,
                          num_fine=num_fine, mesh=mesh)
            for b in range(rays_o.shape[0])]
    return {"depth_lidar": torch.stack([o["depth_lidar"] for o in outs]),
            "image_lidar": torch.stack([o["image_lidar"] for o in outs])}
