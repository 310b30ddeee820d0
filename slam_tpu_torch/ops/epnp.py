"""Minimal-set rigid alignment and Gauss-Newton pose refinement.

Counterpart of the parts of ``slam_tpu/ops/epnp.py`` the pipeline runs:
the SVD-free 3-point alignment that generates RANSAC hypotheses and the
stereo-reprojection GN refinement. EPnP itself is off the pipeline's path.
"""

from __future__ import annotations

import torch

from . import se3, stereo


def rigid_align_3pt(pa: torch.Tensor, pb: torch.Tensor):
    """Rigid T with pb ~= T pa from minimal 3-point sets (..., 3, 3):
    orthonormal triads of both triples composed as R = B A^T. Exact for
    consistent correspondences. Degenerate (collinear) triples give
    ok=False and the identity. Returns (T (..., 4, 4), ok (...))."""

    def triad(p):
        u = p[..., 1, :] - p[..., 0, :]
        v = p[..., 2, :] - p[..., 0, :]
        c = torch.linalg.cross(u, v)
        n_u = torch.linalg.vector_norm(u, dim=-1)
        n_c = torch.linalg.vector_norm(c, dim=-1)
        ok = (n_u > 1e-9) & (n_c > 1e-9 * torch.clamp(n_u, min=1e-9))
        e1 = u / torch.clamp(n_u, min=1e-12)[..., None]
        e3 = c / torch.clamp(n_c, min=1e-12)[..., None]
        e2 = torch.linalg.cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-1), ok  # columns

    A, ok_a = triad(pa)
    Bt, ok_b = triad(pb)
    R = Bt @ A.transpose(-1, -2)
    t = pb.mean(dim=-2) - se3.mv3(R, pa.mean(dim=-2))
    ok = ok_a & ok_b & torch.isfinite(R).flatten(-2).all(-1)
    eye = torch.eye(3, dtype=pa.dtype, device=pa.device).expand_as(R)
    R = torch.where(ok[..., None, None], R, eye)
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    return se3.make_T(R, t), ok


def refine_pose_gn(T_w2c, pw, meas, weights, calib, iters: int = 5):
    """Gauss-Newton on weighted stereo reprojection residuals, batched:
    T (B, 4, 4), pw / meas (B, N, 3), weights (B, N). A step is kept only
    where it lowers the cost and stays finite. Returns T (B, 4, 4)."""
    def res_jac(T):
        Xc = se3.transform_points(T, pw)
        r = (stereo.project(calib, Xc) - meas) * weights[..., None]
        JR = se3.mm33(stereo.project_jacobian(calib, Xc),
                      T[..., None, :3, :3])
        J_rot = -se3.mm33(JR, se3.hat(pw))
        J = torch.cat([J_rot, JR], dim=-1) * weights[..., None, None]
        return r, J

    r, J = res_jac(T_w2c)
    cost = torch.sum(r * r, dim=(-1, -2))
    T = T_w2c
    eye6 = 1e-6 * torch.eye(6, dtype=T.dtype, device=T.device)
    Bn = T.shape[0]
    for _ in range(iters):
        Jf = J.reshape(Bn, -1, 6)
        H = Jf.transpose(1, 2) @ Jf + eye6
        g = Jf.transpose(1, 2) @ r.reshape(Bn, -1, 1)
        xi = -torch.linalg.solve_ex(H, g)[0][..., 0]
        T_new = se3.retract(T, xi)
        r_new, J_new = res_jac(T_new)
        cost_new = torch.sum(r_new * r_new, dim=(-1, -2))
        better = (cost_new < cost) & torch.isfinite(T_new).flatten(-2).all(-1)
        T = torch.where(better[:, None, None], T_new, T)
        r = torch.where(better[:, None, None], r_new, r)
        J = torch.where(better[:, None, None, None], J_new, J)
        cost = torch.where(better, cost_new, cost)
    return T
