"""Keyframe selection and windowed bundle adjustment over the track store.

Counterpart of ``slam_tpu/models/bundle.py``:

  1. host-side keyframe selection and window construction into one padded
     SoA batch (static capacities max_poses / max_landmarks / max_obs);
  2. one batched LM + Schur solve over all windows (ops/ba.py), in
     ``device_batch`` groups padded with zero-weight dummy windows;
  3. batched covariance extraction for the pose graph.

The host functions (``select_keyframes``, ``build_windows``,
``init_landmarks``) are numpy copies of the JAX package's, whose module
imports JAX. Windows that overflow the capacities are cut to the longest
tracks, as the JAX package does without a mesh; its TP mega-bundle
re-solve runs only with a mesh and is not ported.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from slam_tpu.config import BundleConfig, KeyframeConfig, SlamConfig
from slam_tpu.models.trackstore import NO_ID, TrackStore
from slam_tpu.utils import metrics

from ..ops import ba
from ..ops.cuda_kernels import resolve_device
from ..ops.stereo import backproject_np


# ---------------------------------------------------------------------------
# keyframe selection (host)
# ---------------------------------------------------------------------------

def select_keyframes(db: TrackStore, T_w2c: np.ndarray,
                     cfg: KeyframeConfig = KeyframeConfig(),
                     T_dist: np.ndarray | None = None,
                     start: int = 0) -> list[int]:
    """Greedy keyframe cut: advance from the current keyframe until
    distance > max_dist_m, track survival < min_track_survival, rotation >
    max_angle_deg, or gap == max_gap; never cut before min_gap."""
    F = db.num_frames
    Td = T_w2c if T_dist is None else T_dist
    centers = metrics.camera_centers(Td)
    kfs = [start]
    k = start
    while k < F - 1:
        k_tracks = db.track_ids[k]
        k_set = k_tracks[k_tracks != NO_ID]
        n0 = max(len(k_set), 1)
        cut = None
        for f in range(k + 1, F):
            gap = f - k
            if gap < cfg.min_gap:
                continue
            dist = float(np.linalg.norm(centers[f] - centers[k]))
            ang = float(
                metrics.rotation_error_deg(Td[f:f + 1], Td[k:k + 1])[0])
            f_tracks = db.track_ids[f]
            surv = len(np.intersect1d(k_set, f_tracks[f_tracks != NO_ID])) / n0
            if (gap >= cfg.max_gap or dist > cfg.max_dist_m
                    or surv < cfg.min_track_survival
                    or ang > cfg.max_angle_deg):
                cut = f
                break
        if cut is None:
            cut = F - 1
        if cut <= k:
            cut = min(k + cfg.min_gap, F - 1)
        kfs.append(cut)
        k = cut
        if cut >= F - 1:
            break
    return kfs


# ---------------------------------------------------------------------------
# window construction (host -> padded SoA batch)
# ---------------------------------------------------------------------------

@dataclass
class BundleBatch:
    """B windows padded to static shapes."""

    poses0: np.ndarray      # (B, P, 4, 4) initial T_win2cam
    points0: np.ndarray     # (B, L, 3)
    cam_idx: np.ndarray     # (B, M)
    lm_idx: np.ndarray      # (B, M)
    meas: np.ndarray        # (B, M, 3)
    w: np.ndarray           # (B, M)
    n_poses: np.ndarray     # (B,) real pose count per window
    frames: np.ndarray      # (B, P) global frame id per pose row (-1 pad)
    track_of_lm: np.ndarray  # (B, L) global track id per landmark row
    keyframes: list[int]
    obs_dropped: int = 0    # observations cut by max_obs capacity
    obs_total: int = 0      # observations offered before the cut

    @property
    def num_windows(self) -> int:
        return self.poses0.shape[0]


def _rows_of(values, table):
    """Rows of ``values`` in (possibly unsorted) ``table``; every value
    must be present."""
    sidx = np.argsort(table, kind="stable")
    return sidx[np.searchsorted(table, values, sorter=sidx)].astype(np.int64)


def build_windows(db: TrackStore, T_w2c: np.ndarray, keyframes: list[int],
                  cfg: BundleConfig = BundleConfig(),
                  sigma_growth: float = 1.0) -> BundleBatch:
    """All keyframe windows as one padded batch: window frame = first
    keyframe's camera, initial poses from the frontend chain, tracks with
    >= 2 observations in the window (the longest kept at capacity),
    landmarks initialized at their max-disparity observation (resolved by
    :func:`init_landmarks`), weights 1/(sigma growth^distance)."""
    B = len(keyframes) - 1
    P, L, M = cfg.max_poses, cfg.max_landmarks, cfg.max_obs
    poses0 = np.tile(np.eye(4, dtype=np.float32), (B, P, 1, 1))
    points0 = np.zeros((B, L, 3), np.float32)
    cam_idx = np.zeros((B, M), np.int32)
    lm_idx = np.zeros((B, M), np.int32)
    meas = np.zeros((B, M, 3), np.float32)
    w = np.zeros((B, M), np.float32)
    n_poses = np.zeros(B, np.int32)
    frames_arr = np.full((B, P), -1, np.int32)
    track_of_lm = np.full((B, L), -1, np.int32)

    # frame-sorted view of the CSR arrays: each window's entries are two
    # searchsorted cuts (stable, so entries stay track-sorted per frame)
    order_f = np.argsort(db.fr_sorted, kind="stable")
    fr_f = db.fr_sorted[order_f]
    tr_f = db.tr_sorted[order_f]
    slot_f = db.slot_sorted[order_f]

    total_obs_dropped = 0
    total_obs_offered = 0
    for bi in range(B):
        k0, k1 = keyframes[bi], keyframes[bi + 1]
        if k1 - k0 > P - 1:
            raise ValueError(
                f"keyframe gap {k1 - k0} (window {bi}: {k0}->{k1}) exceeds "
                f"BundleConfig.max_poses-1 = {P - 1}; raise max_poses or "
                f"lower KeyframeConfig.max_gap")
        n = k1 - k0 + 1
        n_poses[bi] = n
        frames_arr[bi, :n] = np.arange(k0, k1 + 1)
        poses0[bi, :n] = T_w2c[k0:k1 + 1] @ np.linalg.inv(T_w2c[k0])[None]

        a = np.searchsorted(fr_f, k0, side="left")
        b = np.searchsorted(fr_f, k1, side="right")
        sub = np.lexsort((fr_f[a:b], tr_f[a:b]))  # back to (track, frame)
        trs = tr_f[a:b][sub]
        frs = fr_f[a:b][sub]
        slots = slot_f[a:b][sub]
        uniq, counts = np.unique(trs, return_counts=True)
        good = uniq[counts >= 2]
        if len(good) > L:  # keep the longest tracks
            c = counts[counts >= 2]
            good = good[np.argsort(-c)[:L]]
        track_of_lm[bi, :len(good)] = good

        keep = np.isin(trs, good)
        trs, frs, slots = trs[keep], frs[keep], slots[keep]
        total_obs_offered += len(trs)
        if len(trs) > M:
            # keep the observations of the longest in-window tracks
            rows_lm = _rows_of(trs, good)
            cnt = np.zeros(len(good), np.int64)
            np.add.at(cnt, rows_lm, 1)
            order = np.lexsort((frs, trs, -cnt[rows_lm]))
            keep_rows = np.sort(order[:M])
            total_obs_dropped += len(trs) - M
            trs, frs, slots = trs[keep_rows], frs[keep_rows], slots[keep_rows]
            # a track cut below 2 obs no longer constrains anything
            u2, c2 = np.unique(trs, return_counts=True)
            bad = u2[c2 < 2]
            if len(bad):
                k2 = ~np.isin(trs, bad)
                total_obs_dropped += int((~k2).sum())
                trs, frs, slots = trs[k2], frs[k2], slots[k2]
        mrows = len(trs)
        li = _rows_of(trs, good).astype(np.int32)
        ci = (frs - k0).astype(np.int32)
        links = db.links[frs, slots]
        cam_idx[bi, :mrows] = ci
        lm_idx[bi, :mrows] = li
        meas[bi, :mrows] = links

        # landmark init row: max disparity per landmark, first row on ties
        disp = links[:, 0] - links[:, 1]
        init_frame = np.full(len(good), -1, np.int64)
        best_row = np.zeros(len(good), np.int64)
        if mrows:
            g_order = np.lexsort(
                (-np.arange(mrows, dtype=np.int64), disp, li))
            li_s = g_order[np.r_[li[g_order][1:] != li[g_order][:-1], True]]
            rows_sel = li_s[disp[li_s] > -1.0]
            best_row[li[rows_sel]] = rows_sel
            init_frame[li[rows_sel]] = ci[rows_sel]
        dist_from_init = np.abs(ci - init_frame[li])
        w[bi, :mrows] = (1.0 / cfg.meas_sigma_px) * (
            sigma_growth ** (-dist_from_init.astype(np.float32)))
        # rows used to init landmarks (resolved once calib is known)
        points0[bi, :len(good), 0] = best_row
        points0[bi, :len(good), 1] = -12345.0  # marker

    if total_obs_dropped:
        warnings.warn(
            f"build_windows: dropped {total_obs_dropped} observations over "
            f"{B} windows (max_obs={M} capacity); kept the longest-track "
            f"observations. Raise BundleConfig.max_obs to keep them all.",
            stacklevel=2)
    return BundleBatch(
        poses0=poses0, points0=points0, cam_idx=cam_idx, lm_idx=lm_idx,
        meas=meas, w=w, n_poses=n_poses, frames=frames_arr,
        track_of_lm=track_of_lm, keyframes=list(keyframes),
        obs_dropped=int(total_obs_dropped), obs_total=int(total_obs_offered))


def init_landmarks(batch: BundleBatch, calib) -> None:
    """Resolve the landmark initializations in place: stereo
    backprojection at the chosen observation, mapped into the window frame
    (X = R^T (pc - t)). Host numpy."""
    B = batch.points0.shape[0]
    rows = batch.points0[..., 0].astype(np.int64)
    valid = batch.points0[..., 1] == -12345.0
    links = np.take_along_axis(batch.meas, rows[..., None], axis=1)
    cams = np.take_along_axis(batch.cam_idx, rows.astype(np.int32), axis=1)
    pc = backproject_np(calib, links)
    T = batch.poses0[np.arange(B)[:, None], cams]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Xw = np.einsum("blji,blj->bli", R, pc - t)
    batch.points0[:] = np.where(valid[..., None], Xw.astype(np.float32), 0.0)


# ---------------------------------------------------------------------------
# batched optimization
# ---------------------------------------------------------------------------

@dataclass
class BundleResult:
    poses: np.ndarray        # (B, P, 4, 4) optimized T_win2cam
    points: np.ndarray       # (B, L, 3)
    w: np.ndarray            # (B, M) post-pruning weights
    cost: np.ndarray         # (B,) final half-SSE
    cost0: np.ndarray        # (B,) initial half-SSE
    num_obs: np.ndarray      # (B,) active observations after pruning
    rel_T: np.ndarray        # (B, 4, 4) kf_i -> kf_{i+1} extrinsic
    rel_cov: np.ndarray      # (B, 6, 6) covariance of rel_T
    T_w2c_keyframes: np.ndarray  # (B+1, 4, 4) chained keyframe poses
    keyframes: list[int]
    n_poses: np.ndarray
    frames: np.ndarray
    track_of_lm: np.ndarray
    meas: np.ndarray | None = None
    cam_idx: np.ndarray | None = None
    lm_idx: np.ndarray | None = None
    points0: np.ndarray | None = None
    obs_dropped: int = 0
    obs_total: int = 0


def optimize_windows(batch: BundleBatch, calib,
                     cfg: BundleConfig = BundleConfig(),
                     device_batch: int = 64, device="cuda") -> BundleResult:
    """Optimize all windows with the batched LM solver in ``device_batch``
    groups (the tail group padded with zero-weight copies of its last
    window, so every group has one shape), then extract each window's
    relative pose and covariance and chain the keyframe trajectory."""
    device = resolve_device(device)
    calib_t = torch.tensor(np.asarray(calib, np.float32), device=device)
    B = batch.num_windows
    parts = {k: [] for k in ("cost0", "poses", "points", "w", "cost", "covs")}
    for s in range(0, B, device_batch):
        e = min(s + device_batch, B)
        pad = device_batch - (e - s) if B > device_batch else 0

        def sl(a, dtype=None):
            x = a[s:e]
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            return torch.as_tensor(x, device=device, dtype=dtype)

        p0, x0 = sl(batch.poses0), sl(batch.points0)
        ci = sl(batch.cam_idx, torch.int64)
        li = sl(batch.lm_idx, torch.int64)
        ms, ww = sl(batch.meas), sl(batch.w)
        if pad:
            ww[e - s:] = 0.0  # dummy windows carry no residuals
        poses, points, w2, cost = ba.optimize_bundle_pruned(
            p0, x0, ci, li, ms, ww, calib_t, iters=cfg.lm_iters,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth,
            huber_delta=cfg.huber_delta_px)
        covs = ba.pose_covariances(poses, points, ci, li, ms, w2, calib_t)
        cost0 = ba._cost(p0, x0, ci, li, ms, ww, calib_t)
        n = e - s
        for k, v in zip(parts, (cost0, poses, points, w2, cost, covs)):
            parts[k].append(v[:n].cpu().numpy())
    out = {k: np.concatenate(v) for k, v in parts.items()}
    last = batch.n_poses - 1
    rel_T = out["poses"][np.arange(B), last]
    rel_cov = out["covs"][np.arange(B), last]
    return _assemble_bundle_result(batch, out["poses"], out["points"],
                                   out["w"], out["cost"], out["cost0"],
                                   rel_T, rel_cov)


def _assemble_bundle_result(batch, poses, points, w, cost, cost0, rel_T,
                            rel_cov) -> BundleResult:
    B = batch.num_windows
    # T_w2c[kf_{i+1}] = rel_T[i] @ T_w2c[kf_i]
    T_kf = np.zeros((B + 1, 4, 4), np.float32)
    T_kf[0] = np.eye(4)
    for i in range(B):
        T_kf[i + 1] = rel_T[i] @ T_kf[i]
    return BundleResult(
        poses=poses, points=points, w=w, cost=cost, cost0=cost0,
        num_obs=(w > 0).sum(axis=1), rel_T=rel_T, rel_cov=rel_cov,
        T_w2c_keyframes=T_kf, keyframes=batch.keyframes,
        n_poses=batch.n_poses, frames=batch.frames,
        track_of_lm=batch.track_of_lm, meas=batch.meas,
        cam_idx=batch.cam_idx, lm_idx=batch.lm_idx,
        points0=batch.points0.copy(), obs_dropped=batch.obs_dropped,
        obs_total=batch.obs_total)


_OPTIONAL = ("meas", "cam_idx", "lm_idx", "points0")


def save_bundles(res: BundleResult, path) -> None:
    """BundleResult as npz, in the JAX package's format."""
    np.savez_compressed(
        str(path), poses=res.poses, points=res.points, w=res.w,
        cost=res.cost, cost0=res.cost0, num_obs=res.num_obs,
        rel_T=res.rel_T, rel_cov=res.rel_cov,
        T_w2c_keyframes=res.T_w2c_keyframes,
        keyframes=np.asarray(res.keyframes), n_poses=res.n_poses,
        frames=res.frames, track_of_lm=res.track_of_lm,
        obs_dropped=np.int64(res.obs_dropped),
        obs_total=np.int64(res.obs_total),
        **{k: getattr(res, k) for k in _OPTIONAL
           if getattr(res, k) is not None})


def load_bundles(path) -> BundleResult:
    """Read a bundles npz written by either package."""
    with np.load(str(path)) as z:
        return BundleResult(
            poses=z["poses"], points=z["points"], w=z["w"], cost=z["cost"],
            cost0=z["cost0"], num_obs=z["num_obs"], rel_T=z["rel_T"],
            rel_cov=z["rel_cov"], T_w2c_keyframes=z["T_w2c_keyframes"],
            keyframes=[int(k) for k in z["keyframes"]],
            n_poses=z["n_poses"], frames=z["frames"],
            track_of_lm=z["track_of_lm"],
            obs_dropped=int(z["obs_dropped"]) if "obs_dropped" in z.files
            else 0,
            obs_total=int(z["obs_total"]) if "obs_total" in z.files else 0,
            **{k: z[k] for k in _OPTIONAL if k in z.files})


def run_bundles(db: TrackStore, T_w2c: np.ndarray, calib,
                cfg: SlamConfig = SlamConfig(), mesh=None,
                device="cuda") -> BundleResult:
    """Keyframes -> windows -> batched LM on ``device``."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded bundles and the TP mega-bundle are still to be "
            "ported (ROADMAP.md)")
    kfs = select_keyframes(db, T_w2c, cfg.keyframes)
    batch = build_windows(db, T_w2c, kfs, cfg.bundle)
    init_landmarks(batch, calib)
    return optimize_windows(batch, calib, cfg.bundle, device=device)


def frame_poses_from_bundles(res: BundleResult, num_frames: int) -> np.ndarray:
    """Global per-frame extrinsics from the optimized windows (in-window
    poses chained through the keyframe anchors)."""
    T = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    for bi in range(res.poses.shape[0]):
        T_anchor = res.T_w2c_keyframes[bi]
        for pi in range(int(res.n_poses[bi])):
            T[int(res.frames[bi, pi])] = res.poses[bi, pi] @ T_anchor
    return T
