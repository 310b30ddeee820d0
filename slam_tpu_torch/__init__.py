"""slam_tpu_torch — the stereo visual SLAM pipeline in PyTorch and CUDA.

A port of ``slam_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference; every module here has a
counterpart of the same name there and is held against it by the parity
tests (``tests/test_torch_*.py``).

Layer map:
  ops/       tensor code: SE(3), stereo camera, features, matching,
             RANSAC, bundle adjustment, pose graph, and the hand-written
             CUDA kernels behind them (ops/cuda_kernels.py, csrc/)
  models/    pipeline stages: frontend, track store, bundles, pose graph,
             loop closure
  utils/     numpy synthetic scenes and trajectory metrics
  config.py  SlamConfig (the JAX package's dataclasses and JSON form)
  pipeline.py  run_pipeline / evaluate

This package never imports ``jax`` nor any module of the JAX package:
the numpy-only modules it needs from there (config, track store,
metrics) are copies of its own.

Importing the package sets the geometry precision policy once: float32
matmuls and convolutions without TF32 (ops/precision.py).
"""

from .ops import precision as _precision  # noqa: F401  (sets the policy)

__version__ = "0.1.0"
