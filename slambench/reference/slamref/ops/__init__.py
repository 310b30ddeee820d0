"""Tensor compute for stereo SLAM, with hand-written CUDA kernels."""
