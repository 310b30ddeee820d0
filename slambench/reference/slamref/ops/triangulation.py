"""Batched linear least-squares stereo triangulation.

Counterpart of ``slam_tpu/ops/triangulation.py``: one batched 4x4
eigendecomposition over all correspondences (the DLT system's smallest
right singular vector is the eigenvector of A^T A with the smallest
eigenvalue), on the tensors' device.
"""

from __future__ import annotations

import torch

from . import stereo


def _dlt_system(P: torch.Tensor, Q: torch.Tensor, pts_left: torch.Tensor,
                pts_right: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) DLT matrices, rows xl*P3-P1, yl*P3-P2, xr*Q3-Q1,
    yr*Q3-Q2."""
    xl, yl = pts_left[:, 0, None], pts_left[:, 1, None]
    xr, yr = pts_right[:, 0, None], pts_right[:, 1, None]
    return torch.stack([xl * P[2] - P[0], yl * P[2] - P[1],
                        xr * Q[2] - Q[0], yr * Q[2] - Q[1]], dim=1)


def triangulate(P: torch.Tensor, Q: torch.Tensor, pts_left: torch.Tensor,
                pts_right: torch.Tensor) -> torch.Tensor:
    """Triangulate N correspondences: P, Q the 3x4 left / right projection
    matrices, pts_left / pts_right (N, 2) pixels. Returns (N, 3) points; a
    degenerate homogeneous solution (|w| < 1e-10) is returned unscaled."""
    A = _dlt_system(P, Q, pts_left, pts_right)
    # row-normalized for conditioning: pixel-scale rows would otherwise
    # dwarf the homogeneous column in float32
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-12)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]
    w = X[:, 3:]
    small = torch.abs(w) < 1e-10
    return torch.where(small, X[:, :3],
                       X[:, :3] / torch.where(small, torch.ones_like(w), w))


def triangulate_links(P: torch.Tensor, Q: torch.Tensor,
                      links: torch.Tensor) -> torch.Tensor:
    """Stereo links (N, 3) = (xl, xr, y) -> (N, 3) points; both rows use
    the shared rectified y."""
    xl, xr, y = links[..., 0], links[..., 1], links[..., 2]
    return triangulate(P, Q, torch.stack([xl, y], dim=-1),
                       torch.stack([xr, y], dim=-1))


def triangulate_rectified(calib: torch.Tensor,
                          links: torch.Tensor) -> torch.Tensor:
    """Closed-form disparity backprojection of links (..., 3) in the left
    camera's frame: for an ideally rectified pair the DLT solution."""
    return stereo.backproject(calib, links)
