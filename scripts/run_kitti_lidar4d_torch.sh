#! /bin/bash
# Reference-parity training run with the PyTorch/CUDA port: the flags of
# scripts/run_kitti_lidar4d.sh, in a workspace of its own (the port refuses
# a workspace that holds the JAX package's checkpoints).
python -m lidar4d_tpu_torch.cli.main_lidar4d \
  --config configs/kitti360_4950.txt \
  --workspace log/kitti360_lidar4d_f4950_release_torch \
  --lr 1e-2 \
  --num_rays_lidar 1024 \
  --iters 30000 \
  --alpha_d 1 \
  --alpha_i 0.1 \
  --alpha_r 0.01 \
  "$@"

# --refine
# --test_eval
