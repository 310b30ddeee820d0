"""Batched stereo visual-odometry frontend.

Counterpart of ``slam_tpu/models/frontend.py``. A chunk of F frames is
processed at once on the device:

  chunk of F frames
    -> detect + describe 2F images       (kernel B1 + gridded top-K)
    -> F stereo associations             (kernel B2, disparity window)
    -> F temporal associations           (kernel B2, ego-motion window)
    -> F robust poses                    (batched 3-point RANSAC + GN)

with a one-frame carry between chunks. Failed frames reuse the last good
relative pose (constant-velocity recovery), and the global chain is a
sequential float32 product of the relative poses (the JAX package uses an
associative scan; the rounding differs in the last bits).

Descriptors stay on the device as one float16 (F, K, D) tensor; only
keyframes are ever gathered from it (loop closure). Checkpoint/resume is
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from slam_tpu.config import SlamConfig

from ..ops import cuda_kernels, features, matching, ransac, stereo


@dataclass
class FrontendResult:
    """Host-side SoA output of the frontend over a sequence (K = max_kp
    slots per frame, masked); ``desc`` stays on the device."""

    xy: np.ndarray            # (F, K, 2) left-image keypoints
    desc: torch.Tensor        # (F, K, D) float16 descriptors, on the device
    valid: np.ndarray         # (F, K) keypoint-slot validity
    links: np.ndarray         # (F, K, 3) stereo links (xl, xr, y)
    link_valid: np.ndarray    # (F, K) stereo-gated validity
    match_prev: np.ndarray    # (F, K) idx into frame f-1 slots, -1 if none
    match_dist: np.ndarray    # (F, K) descriptor distance of that match
    inlier_prev: np.ndarray   # (F, K) RANSAC-inlier flag for match_prev
    T_rel: np.ndarray         # (F, 4, 4) T_{f-1 -> f}; identity at f=0
    T_w2c: np.ndarray         # (F, 4, 4) chained global extrinsics
    num_inliers: np.ndarray   # (F,)
    inlier_frac: np.ndarray   # (F,) inliers / valid correspondences
    pose_ok: np.ndarray       # (F,) RANSAC produced a usable pose

    @property
    def num_pose_failures(self) -> int:
        """Frames (beyond frame 0) whose pose fell back to the previous
        relative transform."""
        return int((~self.pose_ok[1:]).sum())


def _pair_correspondences(prev_links, prev_link_valid, cur_links,
                          cur_link_valid, m_fwd, calib):
    """Padded 3D <-> stereo correspondences of F frame pairs (consecutive
    frames here, loop candidates in loop_closure), in the previous frame's
    slot space: slot i counts iff it has a stereo link, is matched to cur
    slot j, and j has a stereo link."""
    K = cur_links.shape[1]
    j = torch.clamp(m_fwd["target_idx"], 0, K - 1)
    valid = (m_fwd["matched"] & prev_link_valid
             & torch.gather(cur_link_valid, 1, j))
    pw = stereo.backproject(calib, prev_links)
    meas = torch.gather(cur_links, 1, j[..., None].expand(-1, -1, 3))
    return pw, meas, valid


def _check_supported(cfg: SlamConfig) -> None:
    fc, mc = cfg.features, cfg.matching
    if fc.detector != "harris" or fc.num_levels != 1 or mc.norm != "l2":
        raise NotImplementedError(
            "the port runs the single-octave Harris detector with L2 "
            "matching; AKAZE/ORB/SIFT, multiscale Harris and Hamming "
            "matching are still to be ported (ROADMAP.md)")


def search_windows(mc) -> tuple:
    """The guided (dx_min, dx_max, dy_max) windows of stereo and temporal
    matching under a MatchingConfig; (None, None) when unguided."""
    if not mc.guided:
        return None, None
    return ((-mc.max_disparity, -mc.stereo_min_disp, mc.stereo_match_dy),
            (-mc.temporal_dx, mc.temporal_dx, mc.temporal_dy))


def _shift_prev(cur: torch.Tensor, carry, fill_zero: bool) -> torch.Tensor:
    """(F, ...) 'previous frame' sequence: the carry for frame 0 (or, with
    no carry, frame 0 itself / zeros), own frames shifted by one after."""
    if carry is not None:
        first = carry[None]
    elif fill_zero:
        first = torch.zeros_like(cur[:1])
    else:
        first = cur[:1]
    return torch.cat([first, cur[:-1]], dim=0)


def process_chunk(chunk_left: torch.Tensor, chunk_right: torch.Tensor,
                  carry: dict | None, calib: torch.Tensor, cfg: SlamConfig,
                  generator: torch.Generator | None = None):
    """One chunk of frames on the device. Images (F, H, W) uint8 or float32
    in [0, 1]. With ``carry`` (the previous chunk's last frame) the first
    frame is also matched against it. RANSAC draws from ``generator``.
    Returns (per-frame dict, new carry)."""
    _check_supported(cfg)
    F = chunk_left.shape[0]
    K = cfg.features.max_kp
    imgs = torch.cat([chunk_left, chunk_right], dim=0)
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() * (1.0 / 255.0)
    feats = features.detect_and_describe_batch(imgs.contiguous(), max_kp=K)
    fl = {k: v[:F] for k, v in feats.items()}
    fr = {k: v[F:] for k, v in feats.items()}

    mc = cfg.matching
    stereo_win, temporal_win = search_windows(mc)
    sm = matching.match_stereo_pair_batched(fl, fr, window=stereo_win,
                                            max_dist=mc.max_desc_dist)
    links, link_valid = sm["links"], sm["matched"]

    desc, valid, xy = fl["desc"], fl["valid"], fl["xy"]
    c = carry or {}
    prev_desc = _shift_prev(desc, c.get("desc"), False)
    prev_valid = _shift_prev(valid, c.get("valid"), True)
    prev_links = _shift_prev(links, c.get("links"), False)
    prev_link_valid = _shift_prev(link_valid, c.get("link_valid"), True)
    prev_xy = _shift_prev(xy, c.get("xy"), False)

    tm = matching.mutual_match(prev_desc, desc, prev_valid, valid,
                               max_dist=mc.max_desc_dist, xy_a=prev_xy,
                               xy_b=xy, window=temporal_win)

    pw, meas, corr_valid = _pair_correspondences(
        prev_links, prev_link_valid, links, link_valid, tm, calib)
    rr = ransac.ransac_pnp(pw, meas, corr_valid, calib,
                           num_hypotheses=cfg.ransac.num_hypotheses,
                           threshold=cfg.ransac.threshold_px,
                           refine_iters=cfg.ransac.refine_iters,
                           generator=generator)

    # recovery: a failed frame reuses the last good relative pose (the
    # carried one before the first good frame of the chunk)
    pose_ok = rr["ok"] & (rr["num_inliers"] >= cfg.ransac.min_inliers)
    T_est = rr["T_w2c"]
    last_T0 = (torch.eye(4, dtype=T_est.dtype, device=T_est.device)
               if carry is None else carry["last_T"])
    t = torch.arange(F, device=T_est.device)
    last_ok = torch.cummax(torch.where(pose_ok, t, -1), dim=0).values
    T_rel = torch.where((last_ok >= 0)[:, None, None],
                        T_est[last_ok.clamp(min=0)], last_T0)

    # global chain T_chain[t] = T_rel[t] @ ... @ T_rel[0], in float32
    chain = [T_rel[0]]
    for i in range(1, F):
        chain.append(T_rel[i] @ chain[-1])
    T_chain = torch.stack(chain)

    # per-slot bookkeeping in cur-frame slot space; prev -> cur matches are
    # injective, and unmatched slots scatter into a dropped column K
    ok = tm["matched"]
    j = torch.where(ok, tm["target_idx"], K)
    src = torch.arange(K, device=j.device).expand(F, K)
    match_prev = torch.full((F, K + 1), -1, dtype=torch.int64,
                            device=j.device)
    match_prev.scatter_(1, j, torch.where(ok, src, -1))
    match_dist = torch.full((F, K + 1), matching.BIG, device=j.device)
    match_dist.scatter_(1, j, torch.where(ok, tm["dist"], matching.BIG))
    inlier_prev = torch.zeros((F, K + 1), dtype=torch.bool, device=j.device)
    inlier_prev.scatter_(1, j, rr["inliers"] & ok)

    num_corr = corr_valid.sum(dim=1)
    out = {
        "xy": xy,
        "desc": desc.half(),
        "valid": valid,
        "links": links,
        "link_valid": link_valid,
        "match_prev": match_prev[:, :K].int(),
        "match_dist": match_dist[:, :K],
        "inlier_prev": inlier_prev[:, :K],
        "T_rel": T_rel,
        "T_chain": T_chain,
        "num_inliers": rr["num_inliers"].int(),
        "inlier_frac": rr["num_inliers"] / torch.clamp(num_corr, min=1),
        "pose_ok": pose_ok,
    }
    new_carry = {"desc": desc[-1], "valid": valid[-1], "links": links[-1],
                 "link_valid": link_valid[-1], "xy": xy[-1],
                 "last_T": T_rel[-1]}
    return out, new_carry


def chunk_generator(cfg: SlamConfig, chunk_index: int,
                    device) -> torch.Generator:
    """Position-based RANSAC stream: chunk i always draws from the same
    seed, whatever ran before it."""
    g = torch.Generator(device=device)
    g.manual_seed(cfg.seed * 1_000_003 + chunk_index)
    return g


def run_frontend(images_left: np.ndarray, images_right: np.ndarray, calib,
                 cfg: SlamConfig = SlamConfig(), device="cuda",
                 checkpoint_path: str | None = None,
                 resume: bool = False) -> FrontendResult:
    """The frontend over a sequence of in-memory (F, H, W) images (uint8
    or float32 in [0, 1]), chunk by chunk on ``device``."""
    if checkpoint_path is not None or resume:
        raise NotImplementedError(
            "frontend checkpoint/resume is still to be ported (ROADMAP.md)")
    _check_supported(cfg)
    device = cuda_kernels.resolve_device(device)
    nF = images_left.shape[0]
    chunk = cfg.runtime.chunk_frames
    calib_t = torch.tensor(np.asarray(calib, np.float32), device=device)
    dtype = images_left.dtype if images_left.dtype == np.uint8 else np.float32

    def upload(imgs, start):
        blk = np.ascontiguousarray(imgs[start:start + chunk], dtype)
        n = blk.shape[0]
        if n < chunk:  # pad the tail chunk: one shape for every chunk
            blk = np.concatenate(
                [blk, np.zeros((chunk - n,) + blk.shape[1:], dtype)])
        return torch.from_numpy(blk).to(device, non_blocking=True), n

    outs, descs, T_w2c_all = [], [], []
    carry = None
    T_carry = np.eye(4, dtype=np.float32)
    for ci, start in enumerate(range(0, nF, chunk)):
        bl, n = upload(images_left, start)
        br, _ = upload(images_right, start)
        out, carry = process_chunk(bl, br, carry, calib_t, cfg,
                                   generator=chunk_generator(cfg, ci, device))
        descs.append(out.pop("desc")[:n])
        host = {k: v[:n].cpu().numpy() for k, v in out.items()}
        T_w2c = host["T_chain"] @ T_carry[None]
        T_carry = T_w2c[-1]
        T_w2c_all.append(T_w2c)
        outs.append(host)

    def cat(k):
        return np.concatenate([o[k] for o in outs], axis=0)

    T_rel = cat("T_rel")
    T_rel[0] = np.eye(4, dtype=T_rel.dtype)
    return FrontendResult(
        xy=cat("xy"), desc=torch.cat(descs, dim=0), valid=cat("valid"),
        links=cat("links"), link_valid=cat("link_valid"),
        match_prev=cat("match_prev"), match_dist=cat("match_dist"),
        inlier_prev=cat("inlier_prev"), T_rel=T_rel,
        T_w2c=np.concatenate(T_w2c_all, axis=0),
        num_inliers=cat("num_inliers"), inlier_frac=cat("inlier_frac"),
        pose_ok=cat("pose_ok"),
    )
