"""EPnP, rigid alignment and Gauss-Newton pose refinement, batched.

Counterpart of ``slam_tpu/ops/epnp.py``. The pipeline runs the SVD-free
3-point alignment that generates RANSAC hypotheses and the
stereo-reprojection GN refinement; the weighted alignment
(:func:`rigid_align`) seeds ``models/db_odometry.py``; EPnP
(:func:`solve_pnp_epnp`) is the n >= 6 solver of the external API. Every
function takes any leading batch dimensions, on the tensors' device
(batched ``torch.linalg.eigh`` / ``svd``).
"""

from __future__ import annotations

import torch

from . import se3, stereo


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _proper_rotation(H: torch.Tensor):
    """Procrustes rotation R = V D U^T of the SVD H = U S V^T, with D the
    reflection fix diag(1, 1, det(V U^T)) that keeps det(R) = +1. Returns
    (R, S)."""
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.ones(S.shape, dtype=H.dtype, device=H.device)
    D[..., 2] = d
    return (V * D[..., None, :]) @ U.transpose(-1, -2), S


def _control_points(pw: torch.Tensor) -> torch.Tensor:
    """World control points (..., 4, 3): the centroid and the centroid
    plus each principal axis scaled by its standard deviation."""
    c0 = pw.mean(dim=-2)
    A = pw - c0[..., None, :]
    cov = A.transpose(-1, -2) @ A / pw.shape[-2]
    lam, V = torch.linalg.eigh(cov + 1e-12 * _eye3(pw))
    # a tiny eigenvalue (planar or degenerate set) is floored
    s = torch.sqrt(torch.clamp(lam, min=1e-8))
    cs = c0[..., None, :] + (V * s[..., None, :]).transpose(-1, -2)
    return torch.cat([c0[..., None, :], cs], dim=-2)


def _barycentric(pw: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates (..., N, 4) of pw w.r.t. 4 control points."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)
    Binv = torch.linalg.inv(B + 1e-12 * _eye3(pw))
    a123 = (pw - ctrl[..., :1, :]) @ Binv.transpose(-1, -2)
    return torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)


def solve_pnp_epnp(pw: torch.Tensor, pix: torch.Tensor, calib: torch.Tensor):
    """EPnP from N >= 6 world <-> left-pixel correspondences (single-beta
    case, then Procrustes): pw (..., N, 3), pix (..., N, 2), calib
    [fx, fy, cx, cy, b]. Returns (T_w2c (..., 4, 4), ok (...)); where the
    geometry is degenerate ok is False and T the identity.

    The camera-frame control points are the null vector of M^T M, known
    up to scale and sign: the scale matches the control points' pairwise
    distances to the world ones, and the sign is the one that puts the
    points' mean depth in front of the camera."""
    fx, fy, cx, cy = calib[0], calib[1], calib[2], calib[3]
    ctrl_w = _control_points(pw)
    alphas = _barycentric(pw, ctrl_w)                      # (..., N, 4)
    u, v = pix[..., 0], pix[..., 1]
    zeros = torch.zeros_like(alphas)
    # per point two rows over the 12 unknowns (4 control points x 3)
    row_u = torch.stack([alphas * fx, zeros, alphas * (cx - u)[..., None]],
                        dim=-1).flatten(-2)
    row_v = torch.stack([zeros, alphas * fy, alphas * (cy - v)[..., None]],
                        dim=-1).flatten(-2)
    M = torch.cat([row_u, row_v], dim=-2)                  # (..., 2N, 12)
    _, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    ctrl_c = V[..., :, 0].reshape(V.shape[:-2] + (4, 3))
    ii, jj = torch.triu_indices(4, 4, 1, device=pw.device)
    dw = torch.linalg.vector_norm(ctrl_w[..., ii, :] - ctrl_w[..., jj, :],
                                  dim=-1)
    dc = torch.linalg.vector_norm(ctrl_c[..., ii, :] - ctrl_c[..., jj, :],
                                  dim=-1)
    denom = (dc * dc).sum(dim=-1)
    beta = (dc * dw).sum(dim=-1) / torch.where(
        denom < 1e-12, torch.ones_like(denom), denom)
    pc = alphas @ (ctrl_c * beta[..., None, None])         # (..., N, 3)
    sign = torch.where(pc[..., 2].mean(dim=-1) < 0.0, -1.0, 1.0)
    pc = pc * sign[..., None, None]
    wbar, cbar = pw.mean(dim=-2), pc.mean(dim=-2)
    R, _ = _proper_rotation((pw - wbar[..., None, :]).transpose(-1, -2)
                            @ (pc - cbar[..., None, :]))
    t = cbar - se3.mv3(R, wbar)
    ok = (torch.isfinite(R).flatten(-2).all(-1) & torch.isfinite(t).all(-1)
          & (denom > 1e-12))
    R = torch.where(ok[..., None, None], R, _eye3(pw).expand_as(R))
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    return se3.make_T(R, t), ok


def rigid_align(pa: torch.Tensor, pb: torch.Tensor,
                w: torch.Tensor | None = None):
    """Weighted closed-form rigid alignment (Kabsch without scale): T with
    pb ~= T pa, for pa, pb (..., N, 3) and weights w (..., N) (all ones by
    default; a zero weight drops a point). Degenerate sets (collinear
    points, fewer than three weighted points, all weights zero) give
    ok=False and the identity. Returns (T (..., 4, 4), ok (...))."""
    if w is None:
        w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device)
    wsum = w.sum(dim=-1, keepdim=True) + 1e-12
    abar = (pa * w[..., None]).sum(dim=-2) / wsum
    bbar = (pb * w[..., None]).sum(dim=-2) / wsum
    A = (pa - abar[..., None, :]) * w[..., None]
    B = pb - bbar[..., None, :]
    R, S = _proper_rotation(A.transpose(-1, -2) @ B)
    t = bbar - se3.mv3(R, abar)
    # near-collinear points: two tiny singular values
    ok = (torch.isfinite(R).flatten(-2).all(-1)
          & (S[..., 1] > 1e-6 * (S[..., 0] + 1e-12)))
    R = torch.where(ok[..., None, None], R, _eye3(pa).expand_as(R))
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    return se3.make_T(R, t), ok


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
