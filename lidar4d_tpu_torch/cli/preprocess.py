"""Preprocessing CLI, port of `lidar4d_tpu/cli/preprocess.py`: the
reference's `preprocess_data.sh` (three `python -m data.preprocess.*` steps)
in one command, on the host (it takes no --device):

  python -m lidar4d_tpu_torch.cli.preprocess --dataset kitti360 --sequence_id 4950 \
      --path data/kitti360

Also exposes the synthetic-sequence generator for data-free environments:

  python -m lidar4d_tpu_torch.cli.preprocess --dataset synthetic --sequence_id 9000 \
      --path data/synthetic --num_frames 51 --H 66 --W 1030
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="kitti360",
                   choices=["kitti360", "synthetic"])
    p.add_argument("--sequence_id", type=str, default="4950")
    p.add_argument("--path", type=str, default="data/kitti360")
    p.add_argument("--configs_dir", type=str, default="configs")
    # synthetic options
    p.add_argument("--num_frames", type=int, default=51)
    p.add_argument("--H", type=int, default=66)
    p.add_argument("--W", type=int, default=1030)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.dataset == "synthetic":
        from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence

        scale, offset = generate_synthetic_sequence(
            args.path, sequence_id=args.sequence_id,
            num_frames=args.num_frames, H=args.H, W=args.W, seed=args.seed,
        )
        os.makedirs(args.configs_dir, exist_ok=True)
        cfg = os.path.join(args.configs_dir, f"synthetic_{args.sequence_id}.txt")
        with open(cfg, "w") as f:
            f.write("dataloader = kitti360\n")
            f.write(f"path = {args.path}\n")
            f.write(f"sequence_id = {args.sequence_id}\n")
            f.write(f"num_frames = {args.num_frames}\n")
            f.write("fov_lidar = [2.0, 26.9]\n")
            f.write(f"scale = {scale}\n")
            f.write(f"offset = {offset}\n")
        print(f"Saved {cfg} (scale={scale}, offset={offset}).")
        return

    from lidar4d_tpu_torch.data.preprocess import (
        cal_seq_config,
        generate_rangeview,
        kitti360_to_nerf,
    )

    generate_rangeview(args.path, args.sequence_id)
    kitti360_to_nerf(args.path, args.sequence_id)
    cal_seq_config(args.path, args.sequence_id, dataset=args.dataset,
                   configs_dir=args.configs_dir)


if __name__ == "__main__":
    main()
