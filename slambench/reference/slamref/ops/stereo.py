"""Calibrated rectified-stereo camera model on torch tensors.

Counterpart of ``slam_tpu/ops/stereo.py``. A stereo measurement is
``(uL, uR, v)``; calibration is the flat vector
``calib = [fx, fy, cx, cy, baseline]``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import se3


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


def calib_from_K(K: torch.Tensor, baseline: float) -> torch.Tensor:
    """A 3x3 intrinsics matrix and a baseline -> the flat float32 calib
    vector, on K's device."""
    return torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                        torch.as_tensor(baseline, device=K.device)]
                       ).to(torch.float32)


def K_from_calib(calib: torch.Tensor) -> torch.Tensor:
    """The flat calib vector -> its 3x3 intrinsics matrix."""
    fx, fy, cx, cy = (calib[i] for i in range(4))
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx]),
                        torch.stack([zero, fy, cy]),
                        torch.stack([zero, zero, one])])


def project_world(calib: torch.Tensor, T_w2c: torch.Tensor,
                  pts_world: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) through extrinsics T_w2c -> stereo
    measurements."""
    return project(calib, se3.transform_points(T_w2c, pts_world))


def projection_matrices(K: torch.Tensor, T_w2c_left: torch.Tensor,
                        baseline: float):
    """The left and right 3x4 projection matrices (the reference's P and
    Q): the right camera sits ``baseline`` along the left one's x axis, so
    its extrinsics shift the translation by -baseline in x."""
    M1 = T_w2c_left[:3, :]
    M2 = M1.clone()
    M2[0, 3] -= baseline
    return K @ M1, K @ M2


def monocular_project(calib: torch.Tensor,
                      pts_cam: torch.Tensor) -> torch.Tensor:
    """Left-camera pixels (..., 3) -> (..., 2) = (u, v)."""
    return project(calib, pts_cam)[..., [0, 2]]


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
