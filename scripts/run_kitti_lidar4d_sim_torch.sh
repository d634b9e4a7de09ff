#! /bin/bash
# Novel-trajectory simulation with the PyTorch/CUDA port from a checkpoint
# that scripts/run_kitti_lidar4d_torch.sh trained: the flags of
# scripts/run_kitti_lidar4d_sim.sh, on that script's workspace.
python -m lidar4d_tpu_torch.cli.main_lidar4d_sim \
  --config configs/kitti360_4950.txt \
  --workspace log/kitti360_lidar4d_f4950_release_torch \
  --ckpt latest_model \
  --fov_lidar 2.0 26.9 \
  --H_lidar 66 \
  --W_lidar 1030 \
  --shift_x 0 --shift_y 0 --shift_z 0 \
  "$@"
