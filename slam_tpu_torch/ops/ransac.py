"""Batched RANSAC pose estimation from 3D <-> stereo correspondences.

Counterpart of ``slam_tpu/ops/ransac.py``: a fixed budget of 3-point
hypotheses (rigid 3D-3D alignment of stereo backprojections), scored with
one batched reprojection test in both rectified views, then two GN
refinement passes with a re-gate in between. Batched over frame pairs.

Hypotheses are drawn without replacement from the valid correspondences
by the Gumbel-top-k trick with a ``torch.Generator``. Those draws cannot
reproduce ``jax.random``'s; a caller that needs the JAX package's exact
hypotheses passes them as ``hyp_idx``.
"""

from __future__ import annotations

import math

import torch

from . import epnp, se3, stereo

DEFAULT_THRESHOLD = 2.0
MIN_SET = 3


def stereo_agreement(T_w2c, pw, meas, valid, calib,
                     threshold: float = DEFAULT_THRESHOLD):
    """Inlier mask (..., N): |d_uL|, |d_uR|, |d_v| < threshold and positive
    depth, for poses (..., 4, 4) against (..., N, 3) correspondences."""
    pc = se3.transform_points(T_w2c, pw)
    err = torch.abs(stereo.project(calib, pc) - meas)
    return (err < threshold).all(dim=-1) & (pc[..., 2] > 0.0) & valid


def sample_hypotheses(valid: torch.Tensor, num_hypotheses: int,
                      generator: torch.Generator | None = None):
    """(B, H, 3) index sets drawn uniformly without replacement from the
    valid entries of each row of ``valid`` (B, N), by Gumbel top-k."""
    B, N = valid.shape
    u = torch.rand((B, num_hypotheses, N), generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    logits = torch.where(valid, 0.0, -math.inf)[:, None, :]
    return torch.topk(logits + g, MIN_SET, dim=-1).indices


def ransac_pnp(pw, meas, valid, calib, num_hypotheses: int = 256,
               threshold: float = DEFAULT_THRESHOLD, refine_iters: int = 5,
               generator: torch.Generator | None = None,
               hyp_idx: torch.Tensor | None = None) -> dict:
    """Robust poses from B padded, masked correspondence sets.

    pw (B, N, 3) points in the previous camera, meas (B, N, 3) stereo
    observations (uL, uR, v) in the current one, valid (B, N).
    ``hyp_idx`` (B, H, 3) replaces the sampled hypotheses.

    Returns T_w2c (B, 4, 4), inliers (B, N), num_inliers (B,), ok (B,).
    """
    B, N, _ = pw.shape
    ok_input = valid.sum(dim=1) >= MIN_SET
    if hyp_idx is None:
        hyp_idx = sample_hypotheses(valid, num_hypotheses, generator)
    hyp_idx = hyp_idx.to(pw.device).long()
    pc_cur = stereo.backproject(calib, meas)

    def pick(x):  # (B, N, 3) -> (B, H, 3, 3)
        Hn = hyp_idx.shape[1]
        idx = hyp_idx.reshape(B, Hn * MIN_SET, 1).expand(-1, -1, 3)
        return torch.gather(x, 1, idx).reshape(B, Hn, MIN_SET, 3)

    Ts, oks = epnp.rigid_align_3pt(pick(pw), pick(pc_cur))   # (B, H, ...)
    inl = stereo_agreement(Ts, pw[:, None], meas[:, None], valid[:, None],
                           calib, threshold)                 # (B, H, N)
    scores = torch.where(oks, inl.sum(dim=-1), -1)
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(B, device=pw.device)
    T_best = Ts[ar, best]
    inliers = inl[ar, best]

    T_ref = epnp.refine_pose_gn(T_best, pw, meas, inliers.to(pw.dtype), calib,
                                iters=refine_iters)
    inliers2 = stereo_agreement(T_ref, pw, meas, valid, calib, threshold)
    T_ref2 = epnp.refine_pose_gn(T_ref, pw, meas, inliers2.to(pw.dtype),
                                 calib, iters=refine_iters)
    inliers3 = stereo_agreement(T_ref2, pw, meas, valid, calib, threshold)

    improved = inliers3.sum(dim=1) >= inliers.sum(dim=1)
    T_out = torch.where(improved[:, None, None], T_ref2, T_best)
    inl_out = torch.where(improved[:, None], inliers3, inliers)
    ok = (ok_input & torch.isfinite(T_out).flatten(1).all(1)
          & (inl_out.sum(dim=1) >= MIN_SET))
    eye = torch.eye(4, dtype=pw.dtype, device=pw.device)
    T_out = torch.where(ok[:, None, None], T_out, eye)
    inl_out = inl_out & ok[:, None]
    return {"T_w2c": T_out, "inliers": inl_out,
            "num_inliers": inl_out.sum(dim=1), "ok": ok}
