"""slam_tpu_torch — the stereo visual SLAM pipeline in PyTorch and CUDA.

A port of ``slam_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference; every module here has a
counterpart of the same name there and is held against it by the parity
tests (``tests/test_torch_*.py``).

Layer map:
  ops/       tensor code: SE(3), stereo camera, features, matching,
             RANSAC, bundle adjustment, pose graph, and the hand-written
             CUDA kernels behind them (ops/cuda_kernels.py, csrc/)
  models/    pipeline stages: frontend, bundles, pose graph, loop closure
  utils/     numpy synthetic scenes
  pipeline.py  run_pipeline / evaluate

The config (``slam_tpu.config``), the track store, the covariance graph
and the metrics are shared with the JAX package: those modules are numpy
only. This package never imports ``jax``.

Importing the package sets the geometry precision policy once: float32
matmuls and convolutions without TF32 (ops/precision.py).
"""

from .ops import precision as _precision  # noqa: F401  (sets the policy)

__version__ = "0.1.0"
