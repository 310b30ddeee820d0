"""Trajectory accuracy metrics.

The port's own copy of ``slam_tpu/utils/metrics.py`` (numpy only); the
parity tests hold the two equal.

The numeric core of the reference's analysis suite
(final_project/analysis.py:442-557 absolute errors, :490-505 rotation error
in degrees, :801-920 KITTI-style relative sub-sequence errors) as plain
functions returning numbers — the regression gate against BASELINE.md.
Poses are extrinsics T_w2c (world -> camera); camera centers are
``-R^T t``.
"""

from __future__ import annotations

import numpy as np


def camera_centers(T_w2c: np.ndarray) -> np.ndarray:
    """(F, 4, 4) extrinsics -> (F, 3) camera centers in world frame."""
    R = T_w2c[..., :3, :3]
    t = T_w2c[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)


def ate_rmse(T_est: np.ndarray, T_gt: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error (RMSE of camera-center L2 distances).

    With ``align=True`` the estimated trajectory is first rigidly aligned
    to ground truth (closed-form Kabsch on the centers) — the standard ATE
    protocol; without it, both trajectories are compared as anchored at
    the origin (the reference's convention, analysis.py:508-557).
    """
    a = camera_centers(T_est)
    b = camera_centers(T_gt)
    if align:
        a = rigid_align_points(a, b)
    d = a - b
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def rigid_align_points(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rigidly align point set a to b (no scale), returning transformed a."""
    abar, bbar = a.mean(0), b.mean(0)
    H = (a - abar).T @ (b - bbar)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return (a - abar) @ R.T + bbar


def abs_location_error(T_est: np.ndarray, T_gt: np.ndarray) -> np.ndarray:
    """Per-frame per-axis + L2 location error, shape (F, 4) [x, y, z, L2].

    Matches the reference's absolute-error plots (analysis.py:508-557).
    """
    d = camera_centers(T_est) - camera_centers(T_gt)
    l2 = np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([np.abs(d), l2], axis=-1)


def rotation_error_deg(T_est: np.ndarray, T_gt: np.ndarray) -> np.ndarray:
    """Per-frame rotation error in degrees (analysis.py:490-505)."""
    R_rel = np.einsum("...ij,...kj->...ik", T_est[..., :3, :3], T_gt[..., :3, :3])
    tr = np.trace(R_rel, axis1=-2, axis2=-1)
    cos_t = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(cos_t))


def relative_subsequence_error(
    T_est: np.ndarray,
    T_gt: np.ndarray,
    lengths: tuple[int, ...] = (100, 400, 800),
) -> dict:
    """KITTI-style relative error over fixed-length sub-sections.

    For every start frame f and length L: the error of the estimated
    relative motion f -> f+L against ground truth, normalized by the
    ground-truth distance traveled — translation in m/m, rotation in deg/m
    (reference rel_pnp_seq_err / rel_bundle_seq_err, analysis.py:801-920,
    961-1075).
    """
    F = T_est.shape[0]
    cum = dist_traveled(T_gt)
    inv_est = np.linalg.inv(T_est)
    inv_gt = np.linalg.inv(T_gt)
    out = {}
    for L in lengths:
        if L >= F:
            continue
        t, r, dist = _rel_section_errors(T_est, T_gt, inv_est, inv_gt, cum, L)
        keep = dist >= 1e-6  # zero-motion starts carry no defined rate
        if keep.any():
            out[L] = {
                "trans_m_per_m_mean": float(np.mean(t[keep])),
                "trans_m_per_m_median": float(np.median(t[keep])),
                "rot_deg_per_m_mean": float(np.mean(r[keep])),
                "rot_deg_per_m_median": float(np.median(r[keep])),
            }
    return out


def _rel_section_errors(T_est, T_gt, inv_est, inv_gt, cum, L):
    """Vectorized per-start-frame L-section errors: (t m/m, r deg/m, dist m).

    One batched 4x4 chain per start frame instead of the former Python
    loop (O(F*L) host work at 3360 frames — the analysis stage hotspot)."""
    s = np.arange(T_est.shape[0] - L)
    rel_est = T_est[s + L] @ inv_est[s]
    rel_gt = T_gt[s + L] @ inv_gt[s]
    err = rel_est @ np.linalg.inv(rel_gt)
    dist = cum[s + L] - cum[s]
    safe = np.maximum(dist, 1e-6)
    t = np.linalg.norm(err[:, :3, 3], axis=-1) / safe
    tr = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                 -1.0, 1.0)
    r = np.degrees(np.arccos(tr)) / safe
    return t, r, dist


def relative_subsequence_curves(
    T_est: np.ndarray,
    T_gt: np.ndarray,
    lengths: tuple[int, ...] = (100, 400, 800),
) -> dict:
    """Per-start-frame relative sub-section error curves (the data behind
    the reference's rel_sub_section_error_* plots, analysis.py:801-920:
    one curve per length over all start frames, normalized by GT distance
    traveled). Vectorized over start frames.

    Returns {L: {"x": starts, "trans_m_per_m": (S,), "rot_deg_per_m": (S,)}}.
    """
    F = T_est.shape[0]
    cum = dist_traveled(T_gt)
    inv_est = np.linalg.inv(T_est)
    inv_gt = np.linalg.inv(T_gt)
    out = {}
    for L in lengths:
        if L >= F:
            continue
        t, r, dist = _rel_section_errors(T_est, T_gt, inv_est, inv_gt, cum, L)
        # Same undefined-rate treatment as relative_subsequence_error: a
        # zero-motion start (dist < 1e-6) has no defined per-meter rate.
        # NaN makes matplotlib break the line instead of drawing the
        # 1e-6-clamp spike.
        bad = dist < 1e-6
        t = np.where(bad, np.nan, t)
        r = np.where(bad, np.nan, r)
        out[L] = {"x": np.arange(F - L), "trans_m_per_m": t,
                  "rot_deg_per_m": r}
    return out


def dist_traveled(T_w2c: np.ndarray) -> np.ndarray:
    """Cumulative distance traveled along a trajectory, (F,) with 0 first
    (reference gtsam_utils.calculate_dist_traveled :226-239)."""
    c = camera_centers(T_w2c)
    seg = np.linalg.norm(np.diff(c, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def trajectory_summary(T_est: np.ndarray, T_gt: np.ndarray) -> dict:
    """One-call metric bundle (printed by the analysis stage)."""
    loc = abs_location_error(T_est, T_gt)
    return {
        "ate_rmse_m": ate_rmse(T_est, T_gt),
        "mean_l2_m": float(np.mean(loc[:, 3])),
        "max_l2_m": float(np.max(loc[:, 3])),
        "mean_rot_deg": float(np.mean(rotation_error_deg(T_est, T_gt))),
        "relative": relative_subsequence_error(T_est, T_gt),
    }
