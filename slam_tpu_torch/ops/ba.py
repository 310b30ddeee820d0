"""Batched sparse bundle adjustment: Levenberg-Marquardt with the Schur
complement, over a batch of windows at once.

Counterpart of ``slam_tpu/ops/ba.py``, with the window batch written out
as the leading dimension where the JAX package vmaps. One window:

  poses    (P, 4, 4) extrinsics T_win2cam (window frame = first camera)
  points   (L, 3)    landmarks in the window frame
  cam_idx  (M,)      observation -> pose row
  lm_idx   (M,)      observation -> landmark row
  meas     (M, 3)    stereo measurements (uL, uR, v)
  w        (M,)      observation weights (0 = padding / pruned)

Each (pose, landmark) pair is observed at most once. Pose 0 is frozen
(gauge). The Hessian blocks are built by ``index_add_`` (the JAX
package's "scatter" engine; its one-hot and bf16 engines are TPU
workarounds and are not ported). ``index_add_`` on CUDA sums in a varying
order, so results agree with the JAX package to float32 rounding, not
bit for bit.

The reduced pose system is factorized with ``torch.linalg.cholesky_ex``.
A failed factorization gives a NaN step, which LM rejects (its cost is
not finite), as the JAX package's NaN Cholesky does; it never raises.
"""

from __future__ import annotations

import torch

from . import se3, stereo


def _outer3(Ja, Jb):
    """(..., 3, a), (..., 3, b) -> (..., a, b): sum over the 3 rows."""
    return Ja.transpose(-1, -2) @ Jb


def _jtr3(J, r):
    """(..., 3, a), (..., 3) -> (..., a)."""
    return (J.transpose(-1, -2) @ r[..., None])[..., 0]


def _gather_obs(poses, points, cam_idx, lm_idx):
    """Per-observation poses (B, M, 4, 4) and landmarks (B, M, 3)."""
    b = torch.arange(poses.shape[0], device=poses.device)[:, None]
    return poses[b, cam_idx], points[b, lm_idx]


def _residuals_tx(T, X, meas, w, calib):
    """Weighted stereo reprojection residuals (B, M, 3) and the camera-
    frame points, from gathered poses / landmarks."""
    Xc = se3.mv3(T[..., :3, :3], X) + T[..., :3, 3]
    return (stereo.project(calib, Xc) - meas) * w[..., None], Xc


def _jacobians_tx(T, X, w, calib, Xc):
    """Analytic Jacobians: J_pose (B, M, 3, 6) w.r.t. the right
    perturbation T exp([w, v]) of the observing pose, J_lm (B, M, 3, 3).
      d(T exp(d) X)/dd = R [-hat(X) | I],   d(T (X + dX))/dX = R."""
    JR = se3.mm33(stereo.project_jacobian(calib, Xc), T[..., :3, :3])
    J_lm = JR * w[..., None, None]
    J_rot = -se3.mm33(JR, se3.hat(X))
    J_pose = torch.cat([J_rot, JR], dim=-1) * w[..., None, None]
    return J_pose, J_lm


def _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx, P, L):
    """Gradient / Hessian blocks by index_add_: g_p (B, P, 6),
    g_l (B, L, 3), Hpp (B, P, 6, 6), Hll (B, L, 3, 3) and the dense cross
    blocks Wc (B, L, P, 6, 3)."""
    B, M = cam_idx.shape
    dev, dt = J_pose.device, J_pose.dtype
    off = torch.arange(B, device=dev)[:, None]
    ci = (off * P + cam_idx).reshape(-1)
    li = (off * L + lm_idx).reshape(-1)
    pair = ((off * L + lm_idx) * P + cam_idx).reshape(-1)

    def add(n, idx, vals):
        out = torch.zeros((n,) + vals.shape[2:], dtype=dt, device=dev)
        return out.index_add_(0, idx, vals.reshape((-1,) + vals.shape[2:]))

    g_p = add(B * P, ci, _jtr3(J_pose, r)).reshape(B, P, 6)
    g_l = add(B * L, li, _jtr3(J_lm, r)).reshape(B, L, 3)
    Hpp = add(B * P, ci, _outer3(J_pose, J_pose)).reshape(B, P, 6, 6)
    Hll = add(B * L, li, _outer3(J_lm, J_lm)).reshape(B, L, 3, 3)
    Wc = add(B * L * P, pair, _outer3(J_pose, J_lm)).reshape(B, L, P, 6, 3)
    return g_p, g_l, Hpp, Hll, Wc


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co10, co11, co12], -1),
        torch.stack([co20, co21, co22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _gauge_mask(P, dtype, device):
    m = torch.ones((P * 6,), dtype=dtype, device=device)
    m[:6] = 0.0
    return m


def _reduced_system(Hpp, Hll_inv, Wc, g_p, g_l):
    """Schur complement on the poses: S (B, 6P, 6P) with the gauge rows
    replaced by identity, ghat (B, 6P), and the flat cross blocks."""
    B, L, P = Wc.shape[:3]
    WHinv = Wc @ Hll_inv[:, :, None]                        # (B, L, P, 6, 3)
    A = WHinv.permute(0, 2, 3, 1, 4).reshape(B, P * 6, L * 3)
    Bm = Wc.permute(0, 2, 3, 1, 4).reshape(B, P * 6, L * 3)
    U = A @ Bm.transpose(1, 2)
    eyeP = torch.eye(P, dtype=Wc.dtype, device=Wc.device)
    blockdiag = (Hpp[:, :, :, None, :] * eyeP[None, :, None, :, None]
                 ).reshape(B, P * 6, P * 6)
    S = blockdiag - U
    ghat = g_p.reshape(B, P * 6) - (A @ g_l.reshape(B, L * 3, 1))[..., 0]
    mask = _gauge_mask(P, Wc.dtype, Wc.device)
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    return S, ghat * mask, Bm


def _spd_solve(S, g):
    """Batched Cholesky solve of S x = g; NaN where the factorization
    fails (LM rejects that step)."""
    Lc, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(g[..., None], Lc)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.full_like(x, float("nan")))


def _schur_solve(J_pose, J_lm, r, cam_idx, lm_idx, P, L, lam):
    """Damped normal equations by landmark marginalization. lam (B,).
    Returns (delta_poses (B, P, 6), delta_points (B, L, 3))."""
    g_p, g_l, Hpp, Hll, Wc = _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx,
                                           P, L)
    dt, dev = Hpp.dtype, Hpp.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_d = Hpp + lam[:, None, None, None] * eye6
    Hll_inv = _inv3x3(Hll + lam[:, None, None, None] * eye3 + 1e-8 * eye3)
    S, ghat, Bm = _reduced_system(Hpp_d, Hll_inv, Wc, g_p, g_l)
    dp = -_spd_solve(S, ghat)
    Wt_dp = (Bm.transpose(1, 2) @ dp[..., None])[..., 0].reshape(-1, L, 3)
    dl = -se3.mv3(Hll_inv, g_l + Wt_dp)
    return dp.reshape(-1, P, 6), dl


def _cost(poses, points, cam_idx, lm_idx, meas, w, calib):
    """Half squared error per window (B,)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    r, _ = _residuals_tx(T, X, meas, w, calib)
    return 0.5 * torch.sum(r * r, dim=(1, 2))


def _huber_weights(r, delta: float):
    """IRLS sqrt-weights of the Huber loss per observation (3-vector)."""
    nrm = torch.linalg.vector_norm(r, dim=-1)
    return torch.sqrt(delta / torch.clamp(nrm, min=delta))


def optimize_bundle(poses, points, cam_idx, lm_idx, meas, w, calib,
                    iters: int = 20, lam0: float = 1e-4,
                    huber_delta: float = 0.0):
    """LM on a batch of windows: a fixed number of iterations, per window
    accept -> lam / 3, reject -> lam * 4 and keep the state.
    ``huber_delta > 0`` reweights observations by IRLS Huber.
    Returns (poses, points, cost (B,), lam (B,))."""
    P, L = poses.shape[1], points.shape[1]
    cost = _cost(poses, points, cam_idx, lm_idx, meas, w, calib)
    lam = torch.full_like(cost, lam0)
    for _ in range(iters):
        T, X = _gather_obs(poses, points, cam_idx, lm_idx)
        r, Xc = _residuals_tx(T, X, meas, w, calib)
        w_eff = w
        if huber_delta > 0.0:
            hw = _huber_weights(r, huber_delta)
            r = r * hw[..., None]
            w_eff = w * hw
        J_pose, J_lm = _jacobians_tx(T, X, w_eff, calib, Xc)
        dp, dl = _schur_solve(J_pose, J_lm, r, cam_idx, lm_idx, P, L, lam)
        new_poses = se3.retract(poses, dp)
        new_points = points + dl
        new_cost = _cost(new_poses, new_points, cam_idx, lm_idx, meas, w,
                         calib)
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        poses = torch.where(ok[:, None, None, None], new_poses, poses)
        points = torch.where(ok[:, None, None], new_points, points)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(ok, new_cost, cost)
    return poses, points, cost, lam


def prune_depth_weights(poses, points, cam_idx, lm_idx, w,
                        min_depth: float = 0.1, max_depth: float = 1000.0):
    """Zero every observation of a landmark that falls behind or too far
    from ANY observing camera (depth pruning as masking)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    z = torch.sum(T[..., 2, :3] * X, dim=-1) + T[..., 2, 3]
    bad_obs = (z < min_depth) | (z > max_depth)
    bad_lm = torch.zeros(points.shape[:2], device=w.device).scatter_add_(
        1, lm_idx, bad_obs.float()) > 0
    return torch.where(torch.gather(bad_lm, 1, lm_idx), 0.0, w)


def optimize_bundle_pruned(poses, points, cam_idx, lm_idx, meas, w, calib,
                           iters: int = 20, prune_rounds: int = 2,
                           min_depth: float = 0.1, max_depth: float = 1000.0,
                           huber_delta: float = 0.0):
    """LM with interleaved depth pruning: prune, optimize, repeat, prune.
    Returns (poses, points, w, cost (B,))."""
    for _ in range(prune_rounds):
        w = prune_depth_weights(poses, points, cam_idx, lm_idx, w, min_depth,
                                max_depth)
        poses, points, _, _ = optimize_bundle(
            poses, points, cam_idx, lm_idx, meas, w, calib, iters=iters,
            huber_delta=huber_delta)
    w = prune_depth_weights(poses, points, cam_idx, lm_idx, w, min_depth,
                            max_depth)
    return poses, points, w, _cost(poses, points, cam_idx, lm_idx, meas, w,
                                   calib)


def pose_covariances(poses, points, cam_idx, lm_idx, meas, w, calib):
    """Marginal 6x6 covariance of every pose (B, P, 6, 6), pose 0 fixed:
    the diagonal blocks of the inverse undamped Gauss-Newton Schur
    complement. Row 0 is zero (the gauge)."""
    B, P, L = poses.shape[0], poses.shape[1], points.shape[1]
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    r, Xc = _residuals_tx(T, X, meas, w, calib)
    J_pose, J_lm = _jacobians_tx(T, X, w, calib, Xc)
    g_p, g_l, Hpp, Hll, Wc = _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx,
                                           P, L)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    S, _, _ = _reduced_system(Hpp, _inv3x3(Hll + 1e-6 * eye3), Wc, g_p, g_l)
    S = S + 1e-8 * torch.eye(P * 6, dtype=S.dtype, device=S.device)
    cov = torch.linalg.inv_ex(S)[0].reshape(B, P, 6, P, 6)
    d = torch.arange(P, device=S.device)
    out = cov[:, d, :, d, :].permute(1, 0, 2, 3)              # (B, P, 6, 6)
    out = 0.5 * (out + out.transpose(-1, -2))
    mask = _gauge_mask(P, S.dtype, S.device).reshape(P, 6)
    return out * mask[None, :, :, None]
