"""Float32 precision policy for the geometry stack.

Counterpart of ``slam_tpu/ops/precision.py``. On the card a float32
matmul runs in full float32 by default, but a float32 convolution goes
through cuDNN in TF32 (about three decimal digits). Normal equations,
SE(3) chains, Schur complements and covariance inverses amplify that into
meter-level trajectory error, and the detector's convolutions feed the
subpixel keypoint fit. So both TF32 switches are turned off, once, when
the package is imported. bf16 stays where the JAX package uses it: the
matcher's similarity products (ops/matching.py, ops/cuda_kernels.py).
The JAX package's ``full_precision`` decorator, which scopes JAX's
matmul precision to one function, has no counterpart: torch's switches
are process-wide, and the port sets them here for every function.
"""

from __future__ import annotations

import torch


def set_geometry_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_geometry_precision()
