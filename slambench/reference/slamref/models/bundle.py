"""Keyframe selection and windowed bundle adjustment over the track store.

Counterpart of ``slam_tpu/models/bundle.py``:

  1. host-side keyframe selection and window construction into one padded
     SoA batch (static capacities max_poses / max_landmarks / max_obs);
  2. one batched LM + Schur solve over all windows (ops/ba.py), in
     ``device_batch`` groups padded with zero-weight dummy windows, or
     under a mesh in one group padded to a multiple of its shards;
  3. batched covariance extraction for the pose graph.

The host functions (``select_keyframes``, ``build_windows``,
``init_landmarks``) are numpy copies of the JAX package's, whose module
imports JAX. Windows that overflow the capacities are cut to the longest
tracks; ``build_windows`` also records each one's full problem. The
program's mesh path re-solves those at full observation count on its
landmark-sharded TP mega-bundle; here ``run_bundles`` re-solves them, when
asked, as dense windows of their full size by the same plain LM
(``resolve_overflowed``). That re-solve prunes and weights as a dense window
does and evaluates the covariances at the optimized landmarks, where the
JAX package does neither (ROADMAP.md queue C).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import BundleConfig, KeyframeConfig, SlamConfig
from ..ops import ba
from ..ops.stereo import backproject_np
from ..parallel.mesh import host_gather, stage_device
from ..utils import metrics
from .trackstore import NO_ID, TrackStore


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
    # windows over max_obs / max_landmarks with their FULL (uncut)
    # observation sets, the TP re-solve's inputs: one dict(bi, tracks,
    # trs, frs, slots) each; not serialized
    overflow: list = field(default_factory=list)

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
    :func:`init_landmarks`), weights 1/(sigma growth^distance). Each
    window over a capacity also leaves its full problem in
    ``overflow``."""
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
    overflow_specs = []
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
        if len(good) > L or int(counts[counts >= 2].sum()) > M:
            # the window's full problem, before any capacity cut
            keep_full = np.isin(trs, good)
            overflow_specs.append({
                "bi": bi, "tracks": good.copy(),
                "trs": trs[keep_full].copy(), "frs": frs[keep_full].copy(),
                "slots": slots[keep_full].copy()})
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
        obs_dropped=int(total_obs_dropped), obs_total=int(total_obs_offered),
        overflow=overflow_specs)


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


WINDOW_INPUTS = ("poses0", "points0", "cam_idx", "lm_idx", "meas", "w")


def window_inputs(batch: BundleBatch, s: int, e: int, length: int) -> tuple:
    """Windows ``s:e`` of a batch as the step's host inputs (those of
    ``WINDOW_INPUTS``, then ``n_poses``), padded to ``length`` windows
    with copies of the last one that carry zero weight (no residual), so
    that every slice of a run has one shape."""
    pad = length - (e - s)

    def sl(a):
        x = a[s:e]
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]) if pad \
            else x

    arrs = [sl(getattr(batch, k)) for k in WINDOW_INPUTS]
    if pad:
        arrs[-1][e - s:] = 0.0  # a fresh array: the batch's w is untouched
    return (*arrs, sl(np.maximum(batch.n_poses, 1).astype(np.int64)))


def window_step(calib, device: torch.device, iters: int = 20,
                min_depth: float = 0.1, max_depth: float = 1000.0,
                huber_delta: float = 0.0):
    """The batched BA step on ``device``: fn(poses0, points0, cam_idx,
    lm_idx, meas, w, n_poses) -> (poses, points, w, cost, cost0, rel_T,
    rel_cov), host numpy in (as ``window_inputs`` gives it; uploaded from
    pinned memory on the card), device tensors out, launched on the
    current stream without waiting for the device. rel_T and rel_cov are
    each window's last pose and its covariance. Everything between the
    uploads and the read-back is ``ops.ba.solve_windows``, one CUDA graph
    per window batch shape on the card."""
    cuda = device.type == "cuda"
    calib_t = torch.as_tensor(np.asarray(calib, np.float32), device=device)

    def upload(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def step(poses0, points0, cam_idx, lm_idx, meas, w, n_poses):
        p0, x0, ms, ww = (upload(a) for a in (poses0, points0, meas, w))
        ci, li = (upload(a, torch.int64) for a in (cam_idx, lm_idx))
        last = upload(np.asarray(n_poses) - 1, torch.int64)
        return ba.solve_windows(p0, x0, ci, li, ms, ww, last, calib_t,
                                iters=iters, min_depth=min_depth,
                                max_depth=max_depth, huber_delta=huber_delta)

    return step


def optimize_windows(batch: BundleBatch, calib,
                     cfg: BundleConfig = BundleConfig(),
                     device_batch: int = 64, mesh=None,
                     device=None) -> BundleResult:
    """Optimize all windows with the batched LM solver in slices of
    ``device_batch`` (the tail slice padded with zero-weight copies of its
    last window, so every slice has one shape), extracting each window's
    relative pose and covariance, and chain the keyframe trajectory.

    Slices are pipelined as in the JAX package: slice s+1 is uploaded
    (from pinned host memory) and dispatched before slice s's results,
    copied back into pinned memory behind an event, are taken in.

    With ``mesh`` the windows are padded to a multiple of the mesh's
    shards (the JAX package's sharded BA, parallel/sharded_ba.py) and
    each rank runs its contiguous share of them as one slice on its
    device (in one process, every window on the mesh's device); the
    ranks' results are gathered on the host in window order, so that
    every rank holds the whole result. Otherwise on ``device``, the card
    unless the caller names the CPU."""
    device = stage_device(mesh, device)
    cuda = device.type == "cuda"
    B = batch.num_windows
    if mesh is not None:
        size = (B + (-B) % mesh.size) // mesh.world
        starts = [mesh.rank * size]
    else:
        size = min(device_batch, B)
        starts = range(0, B, size)
    step = window_step(calib, device, iters=cfg.lm_iters,
                       min_depth=cfg.min_depth, max_depth=cfg.max_depth,
                       huber_delta=cfg.huber_delta_px)
    parts = []

    def submit(s):
        # a rank whose share is all padding solves copies of the last
        # window, and keeps none of them
        n = max(min(s + size, B) - s, 0)
        s = min(s, B - 1)
        host = [v[:n].to("cpu", non_blocking=True)
                for v in step(*window_inputs(batch, s, s + max(n, 1),
                                             size))]
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        return host, ready

    def materialize(pend):
        host, ready = pend
        if ready is not None:
            ready.synchronize()
        parts.append([v.numpy().copy() for v in host])

    pend = None
    for s in starts:
        cur = submit(s)
        if pend is not None:
            materialize(pend)
        pend = cur
    materialize(pend)
    fields = tuple(np.concatenate(f) for f in zip(*parts))
    if mesh is not None:
        fields = host_gather(mesh, fields)
    return _assemble_bundle_result(batch, *fields)


def _chain(rel_T: np.ndarray) -> np.ndarray:
    """Keyframe poses (B + 1, 4, 4): T_w2c[kf_{i+1}] = rel_T[i] @
    T_w2c[kf_i] from the identity."""
    T_kf = np.zeros((rel_T.shape[0] + 1, 4, 4), np.float32)
    T_kf[0] = np.eye(4)
    for i in range(rel_T.shape[0]):
        T_kf[i + 1] = rel_T[i] @ T_kf[i]
    return T_kf


def _assemble_bundle_result(batch, poses, points, w, cost, cost0, rel_T,
                            rel_cov) -> BundleResult:
    return BundleResult(
        poses=poses, points=points, w=w, cost=cost, cost0=cost0,
        num_obs=(w > 0).sum(axis=1), rel_T=rel_T, rel_cov=rel_cov,
        T_w2c_keyframes=_chain(rel_T), keyframes=batch.keyframes,
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


def overflow_problem(spec: dict, batch: BundleBatch, db: TrackStore, calib,
                     cfg: BundleConfig):
    """One overflowed window's full problem from its ``batch.overflow``
    entry: (poses0 (n, 4, 4), points0 (L, 3), cam_idx, lm_idx, meas, w),
    every landmark initialized as ``init_landmarks`` does (stereo
    backprojection at its max-disparity observation, first row on ties)
    and every weight 1 / meas_sigma_px."""
    bi = spec["bi"]
    n = int(batch.n_poses[bi])
    poses0 = batch.poses0[bi, :n]
    li = _rows_of(spec["trs"], spec["tracks"]).astype(np.int32)
    ci = (spec["frs"] - batch.keyframes[bi]).astype(np.int32)
    links = db.links[spec["frs"], spec["slots"]].astype(np.float32)
    w = np.full(len(li), 1.0 / cfg.meas_sigma_px, np.float32)
    disp = links[:, 0] - links[:, 1]
    order = np.lexsort((-np.arange(len(li)), disp, li))
    best = order[np.r_[li[order][1:] != li[order][:-1], True]]
    pc = backproject_np(calib, links[best])
    T = poses0[ci[best]]
    pts0 = np.zeros((len(spec["tracks"]), 3), np.float32)
    pts0[li[best]] = np.einsum("lji,lj->li", T[:, :3, :3],
                               pc - T[:, :3, 3]).astype(np.float32)
    return poses0, pts0, ci, li, links, w


def resolve_overflowed(res: BundleResult, batch: BundleBatch,
                       db: TrackStore, calib, cfg: BundleConfig,
                       device) -> BundleResult:
    """Re-solve every capacity-overflowed window at its full size, as the
    program's mesh path does on its TP mega-bundle, here by this module's
    own plain LM: ``overflow_problem``'s full problem as one dense window
    of its n poses, all its landmarks and all their observations
    (``ops.ba.optimize_bundle_pruned``, the depth gate and Huber weights of
    ``cfg``), then ``ops.ba.pose_covariances`` at the optimized landmarks
    and pruned weights. Its poses, rel_T, rel_cov, cost and active
    observation count replace the truncated solve's; the keyframe
    trajectory is re-chained. ``res.points`` keeps the truncated solve's
    landmarks. No TP code, no mesh, no collective."""
    device = torch.device(device)
    for name in ("poses", "rel_T", "rel_cov", "cost", "num_obs"):
        setattr(res, name, np.array(getattr(res, name)))
    calib_t = torch.as_tensor(np.asarray(calib, np.float32), device=device)

    def one(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device)[None]

    for spec in batch.overflow:
        bi, n = spec["bi"], int(batch.n_poses[spec["bi"]])
        poses0, pts0, ci, li, links, w = overflow_problem(spec, batch, db,
                                                          calib, cfg)
        ci_t, li_t = one(ci, torch.int64), one(li, torch.int64)
        poses, points, w2, cost = ba.optimize_bundle_pruned(
            one(poses0), one(pts0), ci_t, li_t, one(links), one(w), calib_t,
            iters=cfg.lm_iters, min_depth=cfg.min_depth,
            max_depth=cfg.max_depth, huber_delta=cfg.huber_delta_px)
        covs = ba.pose_covariances(poses, points, ci_t, li_t, one(links), w2,
                                   calib_t)
        poses = poses[0].cpu().numpy()
        res.poses[bi, :n] = poses
        res.rel_T[bi] = poses[n - 1]
        res.rel_cov[bi] = covs[0, n - 1].cpu().numpy()
        res.cost[bi] = float(cost[0])
        res.num_obs[bi] = int((w2 > 0).sum())
    res.T_w2c_keyframes = _chain(res.rel_T)
    return res


def run_bundles(db: TrackStore, T_w2c: np.ndarray, calib,
                cfg: SlamConfig = SlamConfig(), mesh=None,
                device=None, resolve_overflow: bool = False,
                stats: dict | None = None) -> BundleResult:
    """Keyframes -> windows -> batched LM on ``device`` (the card unless
    the caller names the CPU), or with ``mesh`` every window in one batch
    on the mesh's device. With ``resolve_overflow`` and
    ``cfg.bundle.tp_overflow``, every capacity-overflowed window is then
    re-solved at full size (:func:`resolve_overflowed`: what the
    program's mesh path computes). ``stats``, when given, gets the count of
    overflowed windows (``overflowed_windows``)."""
    kfs = select_keyframes(db, T_w2c, cfg.keyframes)
    batch = build_windows(db, T_w2c, kfs, cfg.bundle)
    init_landmarks(batch, calib)
    res = optimize_windows(batch, calib, cfg.bundle, mesh=mesh,
                           device=device)
    if stats is not None:
        stats["overflowed_windows"] = len(batch.overflow)
    if batch.overflow and resolve_overflow and cfg.bundle.tp_overflow:
        res = resolve_overflowed(res, batch, db, calib, cfg.bundle,
                               stage_device(mesh, device))
    return res


def frame_poses_from_bundles(res: BundleResult, num_frames: int) -> np.ndarray:
    """Global per-frame extrinsics from the optimized windows (in-window
    poses chained through the keyframe anchors)."""
    T = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    for bi in range(res.poses.shape[0]):
        T_anchor = res.T_w2c_keyframes[bi]
        for pi in range(int(res.n_poses[bi])):
            T[int(res.frames[bi, pi])] = res.poses[bi, pi] @ T_anchor
    return T
