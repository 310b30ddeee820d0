"""Calibrated rectified-stereo camera model on torch tensors.

Counterpart of ``slam_tpu/ops/stereo.py``. A stereo measurement is
``(uL, uR, v)``; calibration is the flat vector
``calib = [fx, fy, cx, cy, baseline]``.
"""

from __future__ import annotations

import numpy as np
import torch


def project(calib: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> stereo measurements (..., 3). The
    right camera sits ``baseline`` along +x of the left one."""
    fx, fy, cx, cy, b = (calib[..., i] for i in range(5))
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9,
                              torch.full_like(z, 1e-9), z)
    uL = fx * x * inv_z + cx
    uR = fx * (x - b) * inv_z + cx
    v = fy * y * inv_z + cy
    return torch.stack([uL, uR, v], dim=-1)


def project_jacobian(calib: torch.Tensor, pts_cam: torch.Tensor):
    """d project / d pts_cam: (..., 3) camera-frame points -> (..., 3, 3),
    rows (uL, uR, v)."""
    fx, fy, b = calib[0], calib[1], calib[4]
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([fx * iz, zero, -fx * (x - b) * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
    ], dim=-2)


def backproject(calib: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """Stereo measurement (..., 3) -> camera-frame point (..., 3), depth
    from disparity ``z = fx * b / (uL - uR)``."""
    fx, fy, cx, cy, b = (calib[..., i] for i in range(5))
    uL, uR, v = meas[..., 0], meas[..., 1], meas[..., 2]
    disp = uL - uR
    disp = torch.where(torch.abs(disp) < 1e-6, torch.full_like(disp, 1e-6),
                       disp)
    z = fx * b / disp
    x = (uL - cx) * z / fx
    y = (v - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def backproject_np(calib, meas) -> np.ndarray:
    """Host-numpy :func:`backproject` (same formula in float32), for the
    host-side landmark initializations of the bundle and loop stages."""
    meas = np.asarray(meas, np.float32)
    fx, fy, cx, cy, b = (float(v) for v in np.asarray(calib).ravel()[:5])
    uL, uR, v = meas[..., 0], meas[..., 1], meas[..., 2]
    disp = uL - uR
    disp = np.where(np.abs(disp) < 1e-6, 1e-6, disp)
    z = fx * b / disp
    x = (uL - cx) * z / fx
    y = (v - cy) * z / fy
    return np.stack([x, y, z], axis=-1).astype(np.float32)
