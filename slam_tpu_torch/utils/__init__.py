"""Synthetic scenes, trajectory metrics and KITTI IO (numpy)."""
