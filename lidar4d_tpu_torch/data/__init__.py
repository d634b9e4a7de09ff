"""Datasets (numpy): KITTI-360 range images and the synthetic scene."""
