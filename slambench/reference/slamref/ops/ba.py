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
(gauge). The Hessian blocks are built by a scatter (the JAX package's
"scatter" engine; its one-hot and bf16 engines are TPU workarounds and
are not ported, and neither is ``default_engine``, which chooses among
them by JAX backend): each observation's terms to its own (landmark,
pose) slot, then sums over the slots in a fixed order, so that a run on
the card gives the same blocks bit for bit every time (``index_add_``'s
atomics straight into the blocks sum in a varying order, and the
float32 LM's accept path then parts between runs of the same inputs).
Results agree with the JAX package to float32 rounding.

Every reduced pose system is solved by kernel B6
(``cuda_kernels.cholesky_solve``: a batched Cholesky factorization and
both substitutions) on the card, and by its plain version
(``cholesky_ex`` + ``cholesky_solve``) on the CPU. The JAX package takes
its counterpart only under ``SLAM_TPU_CHOL_LANES=1`` on a TPU, with a
batch of at least 32, ``N % 8 == 0`` and ``N <= 152`` (its lane and
sublane tiling and its VMEM; ``slam_tpu/ops/ba.py:276-302``), and only
under vmap. Here B6 has no switch and no such condition (on an H100 it
is faster than cuSOLVER's pair at BA's shapes and in the BA engine,
PERF.md); its only limit is ``slam_cholesky_max_n()``, above which the
wrapper raises, and it also serves the loop-closure mini-bundle (N = 12,
one system), as the port's ``optimize_bundle`` is always batched.

A failed factorization gives a NaN step, which LM rejects (its cost is
not finite), as the JAX package's default Cholesky does; it never raises.

``optimize_bundle`` and ``solve_windows`` (a window batch's device work
between its upload and its read-back, the window BA's and the
loop-closure pair's: the initial cost, ``optimize_bundle_pruned``, the
covariances and the gathers of each window's last pose) run from CUDA
graphs on the card (``runtime.graphs``), where the JAX package jits them.
The covariances' inverse is an LU inverse per window (cuSOLVER on the
card), which a graph captures: ``torch.linalg.inv_ex``'s batched LU at
BA's (B, 144, 144) synchronises with the host and cannot be captured
(``scripts/probe_linalg_capture.py``).
"""

from __future__ import annotations

import torch

from ..runtime import graphs
from . import cuda_kernels, se3, stereo


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


def _tree_sum(x, dim: int):
    """Sum over ``dim`` by pairwise halving (x[i] + x[i + n/2], an odd
    last entry carried): every output is the same tree of additions
    whatever the other dimensions' sizes, so a window's sums do not depend
    on the batch it is solved in, as ``torch.sum``'s order may."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        n, h = x.shape[0], x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if n % 2 else y
    return x[0]


def _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx, P, L):
    """Gradient / Hessian blocks: g_p (B, P, 6), g_l (B, L, 3),
    Hpp (B, P, 6, 6), Hll (B, L, 3, 3) and the dense cross blocks
    Wc (B, L, P, 6, 3). Each observation's terms go to its own
    (landmark, pose) slot of a dense (B, L, P, 72) array by
    ``index_add_``; a pair is observed at most once, so a slot takes at
    most one nonzero term (padded lanes add zeros) and the atomics'
    order cannot change it. The pose blocks are then sums over the
    landmarks, the landmark blocks sums over the poses (``_tree_sum``):
    the same window gives the same blocks bit for bit, in any batch."""
    B, M = cam_idx.shape
    dev, dt = J_pose.device, J_pose.dtype
    off = torch.arange(B, device=dev)[:, None]
    pair = ((off * L + lm_idx) * P + cam_idx).reshape(-1)
    terms = torch.cat([_jtr3(J_pose, r), _outer3(J_pose, J_pose).flatten(-2),
                       _jtr3(J_lm, r), _outer3(J_lm, J_lm).flatten(-2),
                       _outer3(J_pose, J_lm).flatten(-2)], dim=-1)
    slots = torch.zeros((B * L * P, terms.shape[-1]), dtype=dt, device=dev)
    slots = slots.index_add_(0, pair, terms.reshape(B * M, -1)).reshape(
        B, L, P, -1)
    pose = _tree_sum(slots[..., :42], 1)                       # (B, P, 42)
    lm = _tree_sum(slots[..., 42:54], 2)                       # (B, L, 12)
    return (pose[..., :6], lm[..., :3], pose[..., 6:].reshape(B, P, 6, 6),
            lm[..., 3:].reshape(B, L, 3, 3),
            slots[..., 54:].reshape(B, L, P, 6, 3))


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


def _schur_terms(Hll_inv, Wc, g_l):
    """The landmark sums of the Schur complement: U = sum_l W_l Hll_l^-1
    W_l^T (B, 6P, 6P), Ag = sum_l W_l Hll_l^-1 g_l (B, 6P), and the flat
    cross blocks Bm (B, 6P, 3L)."""
    B, L, P = Wc.shape[:3]
    WHinv = Wc @ Hll_inv[:, :, None]                        # (B, L, P, 6, 3)
    A = WHinv.permute(0, 2, 3, 1, 4).reshape(B, P * 6, L * 3)
    Bm = Wc.permute(0, 2, 3, 1, 4).reshape(B, P * 6, L * 3)
    U = A @ Bm.transpose(1, 2)
    Ag = (A @ g_l.reshape(B, L * 3, 1))[..., 0]
    return U, Ag, Bm


def _pose_system(Hpp, g_p, U, Ag):
    """S = blockdiag(Hpp) - U (B, 6P, 6P) with the gauge rows replaced by
    identity, and ghat = g_p - Ag (B, 6P), gauge rows zero."""
    B, P = Hpp.shape[:2]
    eyeP = torch.eye(P, dtype=Hpp.dtype, device=Hpp.device)
    blockdiag = (Hpp[:, :, :, None, :] * eyeP[None, :, None, :, None]
                 ).reshape(B, P * 6, P * 6)
    S = blockdiag - U
    ghat = g_p.reshape(B, P * 6) - Ag
    mask = _gauge_mask(P, Hpp.dtype, Hpp.device)
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    return S, ghat * mask


def _reduced_system(Hpp, Hll_inv, Wc, g_p, g_l):
    """Schur complement on the poses: S (B, 6P, 6P) with the gauge rows
    replaced by identity, ghat (B, 6P), and the flat cross blocks."""
    U, Ag, Bm = _schur_terms(Hll_inv, Wc, g_l)
    S, ghat = _pose_system(Hpp, g_p, U, Ag)
    return S, ghat, Bm


def _spd_solve(S, g):
    """Batched Cholesky solve of S x = g by kernel B6; NaN where the
    factorization fails (LM rejects that step)."""
    return cuda_kernels.cholesky_solve(S, g)


def _damped_system(blocks, lam):
    """The LM-damped reduced system from the blocks of _build_blocks:
    (S (B, 6P, 6P), ghat (B, 6P), Bm, Hll_inv (B, L, 3, 3))."""
    g_p, g_l, Hpp, Hll, Wc = blocks
    dt, dev = Hpp.dtype, Hpp.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_d = Hpp + lam[:, None, None, None] * eye6
    Hll_inv = _inv3x3(Hll + lam[:, None, None, None] * eye3 + 1e-8 * eye3)
    S, ghat, Bm = _reduced_system(Hpp_d, Hll_inv, Wc, g_p, g_l)
    return S, ghat, Bm, Hll_inv


def _back_substitute(dp, Bm, Hll_inv, g_l):
    """Landmark steps (B, L, 3) from the pose step dp (B, 6P)."""
    Wt_dp = (Bm.transpose(1, 2) @ dp[..., None])[..., 0].reshape(g_l.shape)
    return -se3.mv3(Hll_inv, g_l + Wt_dp)


def _schur_solve(J_pose, J_lm, r, cam_idx, lm_idx, P, L, lam):
    """Damped normal equations by landmark marginalization. lam (B,).
    Returns (delta_poses (B, P, 6), delta_points (B, L, 3))."""
    blocks = _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx, P, L)
    S, ghat, Bm, Hll_inv = _damped_system(blocks, lam)
    dp = -_spd_solve(S, ghat)
    return dp.reshape(-1, P, 6), _back_substitute(dp, Bm, Hll_inv, blocks[1])


def _cost(poses, points, cam_idx, lm_idx, meas, w, calib):
    """Half squared error per window (B,)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    r, _ = _residuals_tx(T, X, meas, w, calib)
    return 0.5 * torch.sum(r * r, dim=(1, 2))


def _huber_weights(r, delta: float):
    """IRLS sqrt-weights of the Huber loss per observation (3-vector)."""
    nrm = torch.linalg.vector_norm(r, dim=-1)
    return torch.sqrt(delta / torch.clamp(nrm, min=delta))


def _linearize(poses, points, cam_idx, lm_idx, meas, w, calib,
               huber_delta: float = 0.0):
    """Residuals and Jacobians at the current state, IRLS-reweighted when
    ``huber_delta > 0``: (J_pose, J_lm, r)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    r, Xc = _residuals_tx(T, X, meas, w, calib)
    w_eff = w
    if huber_delta > 0.0:
        hw = _huber_weights(r, huber_delta)
        r = r * hw[..., None]
        w_eff = w * hw
    J_pose, J_lm = _jacobians_tx(T, X, w_eff, calib, Xc)
    return J_pose, J_lm, r


@graphs.graphed(static=("iters", "lam0", "huber_delta"))
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
        J_pose, J_lm, r = _linearize(poses, points, cam_idx, lm_idx, meas, w,
                                     calib, huber_delta)
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
    from ANY observing camera (depth pruning as masking). Only lanes that
    hold an observation (w > 0) count: a padded lane points at landmark 0
    from camera 0, and the JAX package's ``prune_depth_weights`` counts it
    too, so there landmark 0 is pruned whenever it lies behind camera 0,
    observed from it or not (ROADMAP.md queue C)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx)
    z = torch.sum(T[..., 2, :3] * X, dim=-1) + T[..., 2, 3]
    bad_obs = ((z < min_depth) | (z > max_depth)) & (w > 0)
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


def _covariance_system(poses, points, cam_idx, lm_idx, meas, w, calib):
    """The undamped Gauss-Newton Schur complement on the poses whose
    inverse ``pose_covariances`` reads: S + 1e-8 I (B, 6P, 6P), the gauge
    rows identity."""
    P, L = poses.shape[1], points.shape[1]
    J_pose, J_lm, r = _linearize(poses, points, cam_idx, lm_idx, meas, w,
                                 calib)
    g_p, g_l, Hpp, Hll, Wc = _build_blocks(J_pose, J_lm, r, cam_idx, lm_idx,
                                           P, L)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    S, _, _ = _reduced_system(Hpp, _inv3x3(Hll + 1e-6 * eye3), Wc, g_p, g_l)
    return S + 1e-8 * torch.eye(P * 6, dtype=S.dtype, device=S.device)


def _marginals(S):
    """The diagonal 6x6 blocks (B, P, 6, 6) of S^-1, symmetrized, the
    gauge block zero. S^-1 is an LU inverse with partial pivoting, as the
    JAX package's ``jnp.linalg.inv``, one window at a time: the batched LU
    of ``torch.linalg.inv_ex`` at BA's (B, 144, 144) synchronises with the
    host and cannot be captured in a CUDA graph, a single matrix's can. S
    need not be positive definite in float32 (a weakly held landmark's
    Schur term cancels). A window whose LU meets a zero pivot gets NaN
    blocks, on the device."""
    B, P = S.shape[0], S.shape[1] // 6
    d = torch.arange(P, device=S.device)
    blocks = []
    for b in range(B):
        inv, info = torch.linalg.inv_ex(S[b])
        blk = inv.reshape(P, 6, P, 6)[d, :, d, :]                 # (P, 6, 6)
        blocks.append(torch.where(info > 0, torch.full_like(blk, torch.nan),
                                  blk))
    out = torch.stack(blocks)
    out = 0.5 * (out + out.transpose(-1, -2))
    mask = _gauge_mask(P, S.dtype, S.device).reshape(P, 6)
    return out * mask[None, :, :, None]


def pose_covariances(poses, points, cam_idx, lm_idx, meas, w, calib):
    """Marginal 6x6 covariance of every pose (B, P, 6, 6), pose 0 fixed:
    the diagonal blocks of the inverse undamped Gauss-Newton Schur
    complement. Row 0 is zero (the gauge)."""
    return _marginals(_covariance_system(poses, points, cam_idx, lm_idx,
                                         meas, w, calib))


@graphs.graphed(static=("iters", "min_depth", "max_depth", "huber_delta"))
def solve_windows(poses0, points0, cam_idx, lm_idx, meas, w, last, calib,
                  iters: int = 20, min_depth: float = 0.1,
                  max_depth: float = 1000.0, huber_delta: float = 0.0):
    """A window batch from its device inputs to its results: the initial
    cost, ``optimize_bundle_pruned``, ``pose_covariances`` at the result,
    and each window's pose row ``last`` (B,) and its covariance. Returns
    (poses, points, w, cost, cost0, rel_T (B, 4, 4), rel_cov (B, 6, 6)).
    One CUDA graph on the card."""
    cost0 = _cost(poses0, points0, cam_idx, lm_idx, meas, w, calib)
    poses, points, w2, cost = optimize_bundle_pruned(
        poses0, points0, cam_idx, lm_idx, meas, w, calib, iters=iters,
        min_depth=min_depth, max_depth=max_depth, huber_delta=huber_delta)
    covs = pose_covariances(poses, points, cam_idx, lm_idx, meas, w2, calib)
    b = torch.arange(poses.shape[0], device=poses.device)
    return poses, points, w2, cost, cost0, poses[b, last], covs[b, last]
