"""Recompute the PnP trajectory from a track store alone.

Counterpart of ``slam_tpu/models/db_odometry.py``. Correspondences
between consecutive frames come from the track-id arrays (one
intersect per frame pair, host numpy); then every frame pair is solved
at once on ``device``: the weighted closed-form alignment of the two
frames' triangulated links seeds the batched Gauss-Newton refinement on
the current frame's stereo reprojection (the tracks are already RANSAC
inliers, so no RANSAC again). The relative poses are chained by a prefix
product of log depth: ceil(log2 F) batched 4x4 products, where a loop
over frames would launch F of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import epnp, stereo
from ..ops.cuda_kernels import resolve_device
from .trackstore import NO_ID


def consecutive_correspondences(db, max_corr: int = 512):
    """For every frame pair (f, f+1), padded arrays of the links of their
    common tracks: (prev_links (F-1, C, 3), cur_links (F-1, C, 3),
    valid (F-1, C))."""
    F, _ = db.track_ids.shape
    C = max_corr
    prev_links = np.zeros((F - 1, C, 3), np.float32)
    cur_links = np.zeros((F - 1, C, 3), np.float32)
    valid = np.zeros((F - 1, C), bool)
    for f in range(F - 1):
        ta, tb = db.track_ids[f], db.track_ids[f + 1]
        ia = np.nonzero(ta != NO_ID)[0]
        ib = np.nonzero(tb != NO_ID)[0]
        common, ca, cb = np.intersect1d(ta[ia], tb[ib], return_indices=True)
        n = min(len(common), C)
        if n == 0:
            continue
        prev_links[f, :n] = db.links[f, ia[ca[:n]]]
        cur_links[f, :n] = db.links[f + 1, ib[cb[:n]]]
        valid[f, :n] = True
    return prev_links, cur_links, valid


def prefix_products(T: torch.Tensor) -> torch.Tensor:
    """out[k] = T[k] @ T[k-1] @ ... @ T[0] for T (F, 4, 4), by doubling
    (Hillis-Steele): after the step of stride d, out[k] holds the product
    of the 2d factors ending at k."""
    out = T.clone()
    d = 1
    while d < out.shape[0]:
        out[d:] = out[d:] @ out[:-d]
        d *= 2
    return out


def pnp_trajectory_from_db(db, calib, max_corr: int = 512,
                           gn_iters: int = 10, device="cuda") -> np.ndarray:
    """Global per-frame extrinsics (F, 4, 4) rebuilt from the track store,
    solved on ``device`` (the card unless the caller names the CPU). A
    pair with fewer than 3 common tracks, a degenerate alignment or a
    non-finite pose contributes the identity."""
    device = resolve_device(device)
    prev, cur, valid = consecutive_correspondences(db, max_corr)
    calib_t = torch.as_tensor(np.array(calib, np.float32), device=device)
    prev_t = torch.as_tensor(prev, device=device)
    cur_t = torch.as_tensor(cur, device=device)
    valid_t = torch.as_tensor(valid, device=device)
    w = valid_t.to(torch.float32)
    pw = stereo.backproject(calib_t, prev_t)
    pc = stereo.backproject(calib_t, cur_t)
    T0, ok = epnp.rigid_align(pw, pc, w)
    T = epnp.refine_pose_gn(T0, pw, cur_t, w, calib_t, iters=gn_iters)
    good = (ok & (valid_t.sum(dim=-1) >= 3)
            & torch.isfinite(T).flatten(-2).all(-1))
    eye = torch.eye(4, dtype=T.dtype, device=device)
    chain = prefix_products(torch.where(good[:, None, None], T, eye))
    out = np.tile(np.eye(4, dtype=np.float32), (db.num_frames, 1, 1))
    out[1:] = chain.cpu().numpy()
    return out
