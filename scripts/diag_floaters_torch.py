#!/usr/bin/env python3
"""Where a trained field's chamfer distance lives, frame by frame: the
port's counterpart of `scripts/diag_floaters.py`, which runs the JAX
package; the same buckets and the same JSON schema.

Each validation frame is rendered from the checkpoint (`--ckpt`: best,
latest or a path), masked by its thresholded ray-drop as the evaluation
masks it, back-projected, and every point's squared nearest-neighbour
distance is attributed to its range-image pixel:

  dist1 (prediction -> ground truth) splits into
    * FP points: a predicted return where the ground truth dropped the ray;
    * TP points: both return, so the distance is depth error;
  dist2 (ground truth -> prediction) is geometry the prediction misses.

For each bucket: its share of the CD sum, the share of its top 1% of points
and their pano-row histogram (8 bands of rows: sky and horizon rows on top,
ground rows below). Writes `<workspace>/diag/summary.json` (or `--out`) and
each frame's sqrt(dist1) / sqrt(dist2) maps beside it.

    python3 scripts/diag_floaters_torch.py --config configs/bench_flagship_10k_phash.txt \\
        --workspace WS --path SCENE --dataloader synthetic \\
        --ckpt WS/kept/lidar4d_ep0054_best --out diag_summary_ep54.json
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pano_pixel_indices(pano):
    """Row/col of each point pano_to_lidar would emit (row-major nonzero)."""
    rows, cols = np.where(pano != 0.0)
    return rows, cols


def bucket_stats(dists, rows, H, label, top_frac=0.01):
    total = float(dists.sum()) if dists.size else 0.0
    out = {"label": label, "n_points": int(dists.size), "sum": total,
           "mean": float(dists.mean()) if dists.size else 0.0}
    if dists.size:
        k = max(1, int(top_frac * dists.size))
        top = np.sort(dists)[-k:]
        out["top1pct_share"] = float(top.sum() / max(total, 1e-12))
        # row histogram of the top-k contributors (where the tail lives)
        top_idx = np.argsort(dists)[-k:]
        hist, _ = np.histogram(rows[top_idx], bins=8, range=(0, H))
        out["top1pct_row_hist"] = hist.tolist()
    return out


def nearest_sq_distances(pred_pts, gt_pts, device):
    """dist1 [P] (each predicted point to the ground truth) and dist2 [Q],
    squared, as the evaluation's PointsMeter computes them."""
    import torch

    from lidar4d_tpu_torch.eval.meters import squared_distances
    from lidar4d_tpu_torch.ops.chamfer import chamfer_distance

    x = torch.from_numpy(pred_pts).to(device)
    y = torch.from_numpy(gt_pts).to(device)
    _, _, i1, i2 = chamfer_distance(x[None], y[None])
    return (squared_distances(x, y[i1[0]]).cpu().numpy(),
            squared_distances(y, x[i2[0]]).cpu().numpy())


def frame_stats(i, pred_pano, gt_pano, gt_raydrop, fov, device, render_s):
    """One frame's record (the JAX script's schema) and its error maps."""
    from lidar4d_tpu_torch.ops.pano import pano_to_lidar

    H, W = gt_pano.shape
    pred_pts = pano_to_lidar(pred_pano, fov).astype(np.float32)
    gt_pts = pano_to_lidar(gt_pano, fov).astype(np.float32)
    pr, pc = pano_pixel_indices(pred_pano)
    gr, gc = pano_pixel_indices(gt_pano)
    d1, d2 = nearest_sq_distances(pred_pts, gt_pts, device)

    fp = gt_raydrop[pr, pc] == 0  # predicted return where gt dropped
    stats = {
        "frame": i,
        "cd": float(d1.mean() + d2.mean()),
        "cd_pred_side": float(d1.mean()),
        "cd_gt_side": float(d2.mean()),
        "render_s": round(render_s, 2),
        "pred_points": int(d1.size),
        "gt_points": int(d2.size),
        "buckets": [
            bucket_stats(d1[fp], pr[fp], H, "pred FP (mask disagrees)"),
            bucket_stats(d1[~fp], pr[~fp], H, "pred TP (depth error)"),
            bucket_stats(d2, gr, H, "gt->pred (missing geometry)"),
        ],
    }
    s_fp, s_tp = stats["buckets"][0]["sum"], stats["buckets"][1]["sum"]
    stats["fp_share_of_pred_cd"] = float(s_fp / max(s_fp + s_tp, 1e-12))
    err_pred = np.zeros((H, W), np.float32)
    err_pred[pr, pc] = np.sqrt(np.maximum(d1, 0.0))
    err_gt = np.zeros((H, W), np.float32)
    err_gt[gr, gc] = np.sqrt(np.maximum(d2, 0.0))
    return stats, err_pred, err_gt


def summarize(frames, ckpt_epoch):
    return {
        "mean_cd": float(np.mean([s["cd"] for s in frames])),
        "mean_fp_share_of_pred_cd": float(np.mean([s["fp_share_of_pred_cd"] for s in frames])),
        "mean_pred_side": float(np.mean([s["cd_pred_side"] for s in frames])),
        "mean_gt_side": float(np.mean([s["cd_gt_side"] for s in frames])),
        "frames": len(frames),
        "ckpt_epoch": ckpt_epoch,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default="best")
    ap.add_argument("--workspace", default=None)
    ap.add_argument("--path", default=None, help="the scene (default the config's)")
    ap.add_argument("--dataloader", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="summary JSON (default <workspace>/diag/"
                                                "summary.json)")
    args = ap.parse_args(argv)

    from lidar4d_tpu_torch.cli.config import (
        build_loss_config,
        build_model_config,
        get_arg_parser,
    )
    from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.ops._cuda import resolve_device
    from lidar4d_tpu_torch.train.trainer import Trainer

    cli = ["--config", args.config, "--test_eval"]
    for flag in ("workspace", "path", "dataloader", "device"):
        if getattr(args, flag):
            cli += [f"--{flag}", getattr(args, flag)]
    opt = get_arg_parser().parse_args(cli)
    device = resolve_device(opt.device)
    opt.near_lidar = opt.near_lidar * opt.scale
    opt.far_lidar = opt.far_lidar * opt.scale

    field = LiDAR4DField(build_model_config(opt), device=device)
    trainer = Trainer("lidar4d", opt, field, build_loss_config(opt), workspace=opt.workspace,
                      lidar_metrics=[], use_checkpoint=args.ckpt,
                      eval_interval=opt.eval_interval, seed=opt.seed)
    print(f"loaded epoch {trainer.epoch} step {trainer.global_step} on {device}", flush=True)
    params = trainer._eval_params()

    ds = KITTI360Dataset(split="val", root_path=opt.path, sequence_id=opt.sequence_id,
                         scale=opt.scale, offset=opt.offset, fov_lidar=opt.fov_lidar)
    out = args.out or os.path.join(opt.workspace, "diag", "summary.json")
    diag_dir = os.path.join(os.path.dirname(os.path.abspath(out)), "diag_maps")
    os.makedirs(diag_dir, exist_ok=True)

    frames = []
    for i in range(len(ds)):
        img = np.asarray(ds.images_lidar[i])
        gt_raydrop = img[..., 0]
        gt_depth = img[..., 2] * gt_raydrop
        t0 = time.perf_counter()
        raydrop, _, depth = trainer._render_frame(params, ds, i)
        if opt.raydrop_loss == "bce":
            raydrop = 1 / (1 + np.exp(-raydrop))
        mask = (raydrop > 0.5).astype(np.float32)
        render_s = time.perf_counter() - t0
        stats, err_pred, err_gt = frame_stats(i, depth * mask / opt.scale, gt_depth / opt.scale,
                                              gt_raydrop, opt.fov_lidar, device, render_s)
        frames.append(stats)
        print(json.dumps(stats), flush=True)
        np.save(os.path.join(diag_dir, f"err_pred_{i:04d}.npy"), err_pred)
        np.save(os.path.join(diag_dir, f"err_gt_{i:04d}.npy"), err_gt)

    summary = summarize(frames, trainer.epoch)
    print("SUMMARY " + json.dumps(summary), flush=True)
    with open(out, "w") as f:
        json.dump({"summary": summary, "frames": frames}, f, indent=1)
    print("DIAG DONE", flush=True)
    return summary


if __name__ == "__main__":
    main()
