"""Batched stereo visual-odometry frontend.

Counterpart of ``slam_tpu/models/frontend.py``. A chunk of F frames is
processed at once on the device:

  chunk of F frames
    -> detect + describe 2F images       (_detect_describe, below)
    -> F stereo associations             (kernel B2, disparity window)
    -> F temporal associations           (kernel B2, ego-motion window)
    -> F robust poses                    (batched 3-point RANSAC + GN)

with a one-frame carry between chunks. Failed frames reuse the last good
relative pose (constant-velocity recovery), and the global chain is a
sequential float32 product of the relative poses (the JAX package uses an
associative scan; the rounding differs in the last bits).

Detectors: Harris at one level (kernel B1 + gridded top-K), Harris over
``num_levels`` pyramid levels (B1 at each), AKAZE (kernels B5 and B3 at
each of ``max(num_levels, 2)`` octaves), SIFT (DoG extrema over
``max(num_levels, 3) + 1`` octaves, the first at twice the resolution,
B3 at each) and ORB (FAST-9 + steered BRIEF, torch ops). Under
``MatchConfig(norm="hamming")`` the descriptors are binarized
to +-1 signs and every matching gate and reported distance is in bits.

Descriptors stay on the device as float16 (F, K, D) chunks in a
``DescriptorBank``; only keyframes are ever gathered from it (loop
closure). ``run_frontend`` overlaps the host and the device as the JAX
package's does: chunk s+1 is uploaded from pinned staging buffers on a
copy stream while chunk s computes, and chunk s's outputs are read back
into pinned memory and taken in one chunk behind. With a checkpoint path
it writes incremental checkpoints in the JAX package's format (without
descriptors, which a resumed run recomputes on demand), and resumes from
them exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import (akaze, binary, cuda_kernels, features, matching, orb,
                   ransac, sift, stereo)


class DescriptorBank:
    """The frontend's float16 descriptors, kept on the device per chunk
    and served by frame index (counterpart of the JAX package's bank).

    Only keyframes are ever read (loop closure's gathers), so nothing is
    stacked or copied to the host unless asked. Chunks resumed from a
    checkpoint hold None and are recomputed from the images on first
    access, only those that hold a frame asked for.

    Serves ``bank[int]``, ``bank[int array or tensor]`` (a gather),
    ``bank[slice]``, ``gather(frames)``, ``shape``, ``len``, ``dtype``,
    ``device`` and ``numpy()``."""

    dtype = torch.float16

    def __init__(self, chunks: list, recompute_fn=None, device="cpu"):
        # chunks: (start, n, (n, K, D) tensor or None), in frame order
        self._chunks = list(chunks)
        self._recompute = recompute_fn
        self._stacked = None
        self.device = torch.device(device)

    def _chunk(self, ci: int):
        start, n, arr = self._chunks[ci]
        if arr is None:
            if self._recompute is None:
                raise RuntimeError("descriptor chunk missing and no "
                                   "recompute source (images) available")
            arr = self._recompute(start, n)
            self._chunks[ci] = (start, n, arr)
        return start, arr

    def _ensure(self) -> torch.Tensor:
        if self._stacked is None:
            parts = [self._chunk(ci)[1] for ci in range(len(self._chunks))]
            self._stacked = torch.cat(parts) if len(parts) > 1 else parts[0]
            self._chunks = None
        return self._stacked

    def gather(self, frames) -> torch.Tensor:
        """Descriptors of the given frames (an int array or tensor of any
        shape), materializing only the chunks they live in."""
        idx = (frames.cpu().numpy() if torch.is_tensor(frames)
               else np.asarray(frames)).astype(np.int64)
        flat = np.where(idx < 0, idx + len(self), idx).reshape(-1)
        if self._stacked is not None:
            out = self._stacked[torch.as_tensor(flat, device=self.device)]
            return out.reshape(idx.shape + out.shape[1:])
        starts = np.asarray([c[0] for c in self._chunks])
        owner = np.searchsorted(starts, flat, side="right") - 1
        parts, order = [], []
        for ci in np.unique(owner):
            sel = np.nonzero(owner == ci)[0]
            start, arr = self._chunk(int(ci))
            parts.append(arr[torch.as_tensor(flat[sel] - start,
                                             device=arr.device)])
            order.append(sel)
        if not parts:
            return torch.empty(idx.shape + self.shape[1:], dtype=self.dtype,
                               device=self.device)
        out = torch.cat(parts)
        order = np.concatenate(order)
        if (order != np.arange(len(order))).any():
            out = out[torch.as_tensor(np.argsort(order), device=out.device)]
        return out.reshape(idx.shape + out.shape[1:])

    def __getitem__(self, idx):
        if self._stacked is not None and not isinstance(idx, np.ndarray):
            return self._stacked[idx]
        if isinstance(idx, (int, np.integer)):
            f = int(idx) + (len(self) if int(idx) < 0 else 0)
            for ci, (start, n, _) in enumerate(self._chunks):
                if start <= f < start + n:
                    start, arr = self._chunk(ci)
                    return arr[f - start]
            raise IndexError(f"frame {idx} out of range")
        if isinstance(idx, (list, np.ndarray)) or (
                torch.is_tensor(idx) and not idx.dtype.is_floating_point
                and idx.dtype != torch.bool):
            return self.gather(idx)
        return self._ensure()[idx]

    def __len__(self) -> int:
        if self._stacked is not None:
            return int(self._stacked.shape[0])
        return sum(n for _, n, _ in self._chunks)

    @property
    def shape(self) -> tuple:
        if self._stacked is not None:
            return tuple(self._stacked.shape)
        total = len(self)
        for _, _, arr in self._chunks:
            if arr is not None:
                return (total,) + tuple(arr.shape[1:])
        # every chunk was resumed from a checkpoint: recompute one to learn
        # (K, D) rather than break the (F, K, D) contract
        if self._chunks and self._recompute is not None:
            return (total,) + tuple(self._chunk(0)[1].shape[1:])
        return (total,)

    def numpy(self) -> np.ndarray:
        """Every frame's descriptors on the host (an explicit export; the
        pipeline never calls it)."""
        return self._ensure().cpu().numpy()


@dataclass
class FrontendResult:
    """Host-side SoA output of the frontend over a sequence (K = max_kp
    slots per frame, masked); ``desc`` stays on the device."""

    xy: np.ndarray            # (F, K, 2) left-image keypoints
    desc: DescriptorBank      # (F, K, D) float16 descriptors, on the device
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


def _detect_describe(imgs: torch.Tensor, cfg: SlamConfig) -> dict:
    """Detection + description of a batch of (F, H, W) images (uint8 or
    float32 in [0, 1]) under ``cfg.features``, binarized under the
    Hamming norm."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() * (1.0 / 255.0)
    imgs = imgs.contiguous()
    fc = cfg.features
    if fc.detector == "akaze":
        out = akaze.detect_and_describe_akaze_batch(
            imgs, max_kp=fc.max_kp, octaves=max(fc.num_levels, 2),
            threshold=fc.akaze_threshold)
    elif fc.detector == "sift":
        # num_levels counts the octaves from full resolution down; + 1 is
        # cv2's x2-upsampled '-1' octave
        out = sift.detect_and_describe_sift_batch(
            imgs, max_kp=fc.max_kp, octaves=max(fc.num_levels, 3) + 1,
            contrast=fc.sift_contrast)
    elif fc.detector == "orb":
        # already +-1/sqrt(D) bit signs: under the Hamming norm the
        # binarization below recovers the same bits (unless all are equal)
        out = orb.detect_and_describe_orb_batch(
            imgs, max_kp=fc.max_kp, threshold=fc.fast_threshold)
    elif fc.num_levels > 1:
        out = features.detect_and_describe_multiscale_batch(
            imgs, max_kp=fc.max_kp, num_levels=fc.num_levels)
    else:
        out = features.detect_and_describe_batch(imgs, max_kp=fc.max_kp)
    if cfg.matching.norm == "hamming":
        out = dict(out, desc=binary.binarize_descriptors(out["desc"]))
    return out


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
    F = chunk_left.shape[0]
    K = cfg.features.max_kp
    feats = _detect_describe(torch.cat([chunk_left, chunk_right], dim=0),
                             cfg)
    fl = {k: v[:F] for k, v in feats.items()}
    fr = {k: v[F:] for k, v in feats.items()}

    mc = cfg.matching
    D = feats["desc"].shape[-1]
    hamming = mc.norm == "hamming"
    # +-1 signs: the matcher's base distance is an increasing affine map
    # of the Hamming distance, so the gate is converted
    max_dist = (binary.base_gate_from_hamming(mc.max_hamming, D) if hamming
                else mc.max_desc_dist)
    stereo_win, temporal_win = search_windows(mc)
    sm = matching.match_stereo_pair_batched(fl, fr, window=stereo_win,
                                            max_dist=max_dist)
    links, link_valid = sm["links"], sm["matched"]

    desc, valid, xy = fl["desc"], fl["valid"], fl["xy"]
    c = carry or {}
    prev_desc = _shift_prev(desc, c.get("desc"), False)
    prev_valid = _shift_prev(valid, c.get("valid"), True)
    prev_links = _shift_prev(links, c.get("links"), False)
    prev_link_valid = _shift_prev(link_valid, c.get("link_valid"), True)
    prev_xy = _shift_prev(xy, c.get("xy"), False)

    tm = matching.mutual_match(prev_desc, desc, prev_valid, valid,
                               max_dist=max_dist, xy_a=prev_xy,
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
    match_dist = match_dist[:, :K]
    if hamming:  # report match distances in bits (BIG passes through)
        match_dist = binary.hamming_from_base(match_dist, D)

    num_corr = corr_valid.sum(dim=1)
    out = {
        "xy": xy,
        "desc": desc.half(),
        "valid": valid,
        "links": links,
        "link_valid": link_valid,
        "match_prev": match_prev[:, :K].int(),
        "match_dist": match_dist,
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


def recompute_descriptors(chunk_left: torch.Tensor,
                          chunk_right: torch.Tensor,
                          cfg: SlamConfig) -> torch.Tensor:
    """The left images' float16 descriptors of one chunk, equal bit for
    bit to what process_chunk produced for it: detection runs on the same
    (2F, H, W) left-and-right batch, since on the card cuDNN and cuBLAS
    choose their algorithms by shape, and a left-only batch can round
    differently in the last bits."""
    F = chunk_left.shape[0]
    feats = _detect_describe(torch.cat([chunk_left, chunk_right], dim=0), cfg)
    return feats["desc"][:F].half()


# ---------------------------------------------------------------------------
# incremental checkpoints, in the JAX package's format
# ---------------------------------------------------------------------------

# Descriptors are not checkpointed (~0.5 MB per frame at K = 2048, most of
# a checkpoint's bytes); a resumed run recomputes them on demand.
_CKPT_KEYS = (
    "xy", "valid", "links", "link_valid", "match_prev", "match_dist",
    "inlier_prev", "T_rel", "num_inliers", "inlier_frac", "pose_ok",
)


def _seg_path(path, k: int) -> Path:
    p = Path(path)
    return p.with_name(p.stem + f".seg{k:04d}" + p.suffix)


def _atomic_savez(path, **arrs) -> None:
    """np.savez with an atomic replace: a crash mid-write must not leave a
    truncated file at ``path``, the resume root."""
    # a .npz-suffixed temp name keeps numpy from appending its own suffix
    tmp = Path(path).with_name(Path(path).name + ".tmp.npz")
    np.savez(str(tmp), **arrs)
    os.replace(str(tmp), str(path))


def _frontend_fingerprint(cfg: SlamConfig) -> str:
    """Hash of every config field that determines frontend results: all
    of ``features``, ``matching`` and ``ransac``, the seed and the chunk
    size (chunk boundaries and the position-based RANSAC streams).

    Deliberately unlike the JAX package's, which hashes only the fields
    that differ from their defaults: there, a field left at a default
    that a later release changed keeps the old fingerprint, and frames
    computed under two settings would be stitched. So a checkpoint the
    JAX package wrote loads here, but its resume is refused."""
    sub = {k: dataclasses.asdict(getattr(cfg, k))
           for k in ("features", "matching", "ransac")}
    sub["seed"] = cfg.seed
    sub["chunk_frames"] = cfg.runtime.chunk_frames
    blob = json.dumps(sub, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _meta(T_carry, next_start, num_segments, fingerprint, carry) -> dict:
    meta = {"T_carry": T_carry, "next_start": np.int64(next_start),
            "num_segments": np.int64(num_segments)}
    if fingerprint:
        meta["cfg_fingerprint"] = np.str_(fingerprint)
    for k, v in (carry or {}).items():
        meta[f"carry_{k}"] = np.asarray(v)
    return meta


def _save_checkpoint(path, seg_outs, seg_T_w2c, carry, T_carry, next_start,
                     seg_idx: int, fingerprint: str = "") -> None:
    """Incremental checkpoint: the frames since the last one as
    ``<path>.segNNNN.npz``, then the meta file at ``path`` (the carry as
    host arrays, the segment count), written last and atomically so that a
    crash mid-segment leaves the previous checkpoint whole. The files are
    not compressed (the JAX package's are; np.load reads both): zlib costs
    the host many times the write (``chip_smoke.py`` prints both)."""
    blob = {k: np.concatenate([o[k] for o in seg_outs], axis=0)
            for k in _CKPT_KEYS + ("T_chain",)}
    blob["T_w2c"] = np.concatenate(seg_T_w2c, axis=0)
    np.savez(str(_seg_path(path, seg_idx)), **blob)
    _atomic_savez(path, **_meta(T_carry, next_start, seg_idx + 1,
                                fingerprint, carry))


def load_frontend_checkpoint(path):
    """(outs list, T_w2c list, carry dict of host arrays or None, T_carry,
    next start) of a checkpoint written by either package, per-segment or
    legacy monolithic."""
    z = np.load(str(path))
    carry = {k[len("carry_"):]: z[k] for k in z.files
             if k.startswith("carry_")} or None
    if "num_segments" in z.files:  # per-segment layout
        outs, T_list = [], []
        for k in range(int(z["num_segments"])):
            s = np.load(str(_seg_path(path, k)))
            out = {key: s[key] for key in _CKPT_KEYS + ("T_chain",)}
            if "desc" in s.files:  # older checkpoints stored descriptors
                out["desc"] = s["desc"]
            outs.append(out)
            T_list.append(s["T_w2c"])
        return outs, T_list, carry, z["T_carry"], int(z["next_start"])
    missing = [k for k in _CKPT_KEYS + ("T_chain", "T_w2c")
               if k not in z.files]
    if missing:
        raise RuntimeError(f"frontend checkpoint {path} predates the "
                           f"current format (missing arrays: {missing}); "
                           f"delete it to recompute")
    out = {k: z[k] for k in _CKPT_KEYS + ("T_chain",)}
    if "desc" in z.files:
        out["desc"] = z["desc"]
    return [out], [z["T_w2c"]], carry, z["T_carry"], int(z["next_start"])


def _resume_from_checkpoint(checkpoint_path, fingerprint: str):
    """Validate and load a checkpoint for resume: (outs, T_w2c_all, carry,
    T_carry, next start, segment count, descriptor chunks, legacy).
    Raises RuntimeError when it was written under another
    result-determining config (or by the JAX package, whose fingerprint
    differs on purpose; see _frontend_fingerprint)."""
    with np.load(str(checkpoint_path)) as z:
        legacy = "num_segments" not in z.files
        saved = (str(z["cfg_fingerprint"]) if "cfg_fingerprint" in z.files
                 else None)
    if saved is not None and saved != fingerprint:
        raise RuntimeError(
            f"frontend checkpoint {checkpoint_path} was written under a "
            f"different feature/matching/ransac/chunking config "
            f"(fingerprint {saved} != {fingerprint}); delete it (and its "
            f".segNNNN files) to recompute, or rerun with the original "
            f"config")
    outs, T_w2c_all, carry, T_carry, first_start = load_frontend_checkpoint(
        checkpoint_path)
    desc_chunks, pos = [], 0
    for o in outs:
        n_o = o["xy"].shape[0]
        desc_chunks.append((pos, n_o, o.pop("desc", None)))
        pos += n_o
    return (outs, T_w2c_all, carry, T_carry, first_start, len(outs),
            desc_chunks, legacy)


def _convert_legacy_checkpoint(path, outs, T_w2c_all, carry, T_carry,
                               next_start, fingerprint: str = "") -> None:
    """Rewrite a legacy monolithic checkpoint as segment 0 + meta, before
    any incremental save: _save_checkpoint replaces ``path`` with the
    meta alone, which would destroy the only copy of the loaded frames."""
    blob = {k: np.concatenate([o[k] for o in outs], axis=0)
            for k in _CKPT_KEYS + ("T_chain",)}
    blob["T_w2c"] = np.concatenate(T_w2c_all, axis=0)
    np.savez(str(_seg_path(path, 0)), **blob)
    _atomic_savez(path, **_meta(T_carry, next_start, 1, fingerprint, carry))


# ---------------------------------------------------------------------------
# the frontend over a sequence
# ---------------------------------------------------------------------------

class ArrayFrames:
    """In-memory (F, H, W) stereo images (uint8, or anything else as
    float32 in [0, 1]) as the frontend's frame source: ``fill`` copies
    frames [start, start + n) into (chunk, H, W) host buffers and zeroes
    the rest."""

    def __init__(self, left, right):
        self.left, self.right = left, right
        self.num = int(left.shape[0])
        self.hw = tuple(left.shape[1:])
        self.dtype = torch.uint8 if left.dtype == np.uint8 else torch.float32

    def begin(self, first_start: int, chunk: int) -> None:
        pass

    def end(self) -> None:
        pass

    def fill(self, start: int, n: int, dst_left, dst_right) -> None:
        np_dtype = np.uint8 if self.dtype == torch.uint8 else np.float32
        for src, dst in ((self.left, dst_left), (self.right, dst_right)):
            dst[:n].copy_(torch.from_numpy(np.ascontiguousarray(
                src[start:start + n], np_dtype)))
            dst[n:].zero_()


def _recompute_chunks(frames, cfg: SlamConfig, device, start: int,
                      n: int) -> torch.Tensor:
    """Descriptors of frames [start, start + n) (a resumed checkpoint
    segment, chunk-aligned), recomputed chunk by chunk at the chunk
    shape process_chunk ran, tail zero-padded as it was."""
    chunk = cfg.runtime.chunk_frames
    bl, br = (torch.empty((chunk,) + frames.hw, dtype=frames.dtype)
              for _ in range(2))
    parts = []
    for s in range(start, start + n, chunk):
        m = min(chunk, start + n - s)
        frames.fill(s, m, bl, br)
        parts.append(recompute_descriptors(bl.to(device), br.to(device),
                                           cfg)[:m])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def run_frames(frames, calib, cfg: SlamConfig, device,
               checkpoint_path: str | None = None,
               checkpoint_every: int = 500,
               resume: bool = False, on_chunk=None) -> FrontendResult:
    """The frontend over a frame source (``ArrayFrames``, or the PNG
    source of ``parallel.pipeline``), chunk by chunk on ``device``.
    ``on_chunk(start, n, outputs, T_w2c)`` is called with each chunk's
    host outputs as they are taken in, one chunk behind the device
    (parallel/stage_overlap.py builds BA windows there).

    On the card the host and the device overlap: the next chunk is filled
    into one of two pinned staging buffer pairs (a pair is refilled only
    after its last upload finished) and uploaded on a copy stream, which
    the compute stream waits for; each chunk's per-frame outputs are read
    back into pinned memory behind an event and taken in one chunk later.
    The outputs equal a sequential loop's bit for bit: the same inputs,
    the same ops, and RANSAC seeded by the chunk's position."""
    device = cuda_kernels.resolve_device(device)
    cuda = device.type == "cuda"
    nF, chunk = frames.num, cfg.runtime.chunk_frames
    calib_t = torch.from_numpy(np.asarray(calib, np.float32)).to(device)
    fingerprint = _frontend_fingerprint(cfg)
    recompute = functools.partial(_recompute_chunks, frames, cfg, device)

    outs, T_w2c_all, desc_chunks = [], [], []
    carry, T_carry = None, np.eye(4, dtype=np.float32)
    first_start, seg_idx = 0, 0
    if resume and checkpoint_path and Path(checkpoint_path).exists():
        (outs, T_w2c_all, carry, T_carry, first_start, seg_idx, desc_chunks,
         legacy) = _resume_from_checkpoint(checkpoint_path, fingerprint)
        if legacy and first_start < nF:
            # frames will be appended: migrate the monolithic file first
            _convert_legacy_checkpoint(checkpoint_path, outs, T_w2c_all,
                                       carry, T_carry, first_start,
                                       fingerprint)
        if carry is not None:
            carry = {k: torch.from_numpy(v).to(device)
                     for k, v in carry.items()}
        desc_chunks = [(s, n, None if d is None else torch.from_numpy(
            np.asarray(d, np.float16)).to(device)) for s, n, d in desc_chunks]
    starts = list(range(first_start, nF, chunk))
    if not starts:  # the checkpoint covers the whole sequence
        return _assemble_result(outs, T_w2c_all, desc_chunks, recompute,
                                device)

    shape = (chunk,) + frames.hw
    staging = [tuple(torch.empty(shape, dtype=frames.dtype, pin_memory=cuda)
                     for _ in range(2)) for _ in range(2)]
    uploaded = [None, None]  # per staging pair: its last upload's event
    copy_stream = torch.cuda.Stream(device) if cuda else None
    compute = torch.cuda.current_stream(device) if cuda else None

    def upload(i: int, start: int):
        pair = i % 2
        if uploaded[pair] is not None:
            uploaded[pair].synchronize()
        n = min(chunk, nF - start)
        frames.fill(start, n, *staging[pair])
        if not cuda:  # the CPU computes on the staging buffers themselves
            return staging[pair], n
        with torch.cuda.stream(copy_stream):
            dev = tuple(b.to(device, non_blocking=True)
                        for b in staging[pair])
            uploaded[pair] = torch.cuda.Event()
            uploaded[pair].record(copy_stream)
        return dev, n

    last_ckpt, seg_outs, seg_T = first_start, [], []

    def materialize(pend) -> None:
        nonlocal T_carry, last_ckpt, seg_idx, seg_outs, seg_T
        start_p, n_p, host, ready, carry_p, is_last = pend
        if ready is not None:
            ready.synchronize()
        # copied off the pinned blocks, which return to the allocator
        o = {k: v.numpy().copy() for k, v in host.items()}
        T_w2c = o["T_chain"] @ T_carry[None]
        T_carry = T_w2c[-1]
        T_w2c_all.append(T_w2c)
        outs.append(o)
        seg_outs.append(o)
        seg_T.append(T_w2c)
        if on_chunk is not None:
            on_chunk(start_p, n_p, o, T_w2c)
        done = start_p + n_p
        # carry_p is the carry as of this chunk, not the live one, which
        # has moved past the chunk dispatched since
        if checkpoint_path and (done - last_ckpt >= checkpoint_every
                                or (is_last and seg_outs)):
            _save_checkpoint(checkpoint_path, seg_outs, seg_T,
                             {k: v.cpu().numpy() for k, v in carry_p.items()},
                             T_carry, done, seg_idx, fingerprint)
            last_ckpt = done
            seg_idx += 1
            seg_outs, seg_T = [], []

    frames.begin(first_start, chunk)
    try:
        nxt = upload(0, starts[0])
        pending = None
        for i, start in enumerate(starts):
            (bl, br), n = nxt
            if cuda:
                compute.wait_event(uploaded[i % 2])
                bl.record_stream(compute)
                br.record_stream(compute)
            out, carry = process_chunk(
                bl, br, carry, calib_t, cfg,
                generator=chunk_generator(cfg, start // chunk, device))
            desc_chunks.append((start, n, out.pop("desc")[:n]))
            host = {k: v[:n].to("cpu", non_blocking=True)
                    for k, v in out.items()}
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(compute)
            if i + 1 < len(starts):  # the host fills while the card works
                nxt = upload(i + 1, starts[i + 1])
            if pending is not None:
                materialize(pending)
            pending = (start, n, host, ready, carry, i + 1 == len(starts))
        materialize(pending)
    finally:
        frames.end()
    return _assemble_result(outs, T_w2c_all, desc_chunks, recompute, device)


def run_frontend(images_left: np.ndarray, images_right: np.ndarray, calib,
                 cfg: SlamConfig = SlamConfig(), device="cuda",
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 500,
                 resume: bool = False) -> FrontendResult:
    """The frontend over a sequence of in-memory (F, H, W) images (uint8
    or float32 in [0, 1]), chunk by chunk on ``device``. With
    ``checkpoint_path`` the state is checkpointed every
    ``checkpoint_every`` frames (at chunk ends), and ``resume=True``
    continues from the last checkpoint, equal bit for bit to an
    uninterrupted run."""
    return run_frames(ArrayFrames(images_left, images_right), calib, cfg,
                      device, checkpoint_path, checkpoint_every, resume)


def _assemble_result(outs, T_w2c_all, desc_chunks, recompute_fn,
                     device) -> FrontendResult:
    def cat(k):
        return np.concatenate([o[k] for o in outs], axis=0)

    T_rel = cat("T_rel")
    T_rel[0] = np.eye(4, dtype=T_rel.dtype)  # frame 0 has no previous
    return FrontendResult(
        xy=cat("xy"), desc=DescriptorBank(desc_chunks, recompute_fn, device),
        valid=cat("valid"), links=cat("links"), link_valid=cat("link_valid"),
        match_prev=cat("match_prev"), match_dist=cat("match_dist"),
        inlier_prev=cat("inlier_prev"), T_rel=T_rel,
        T_w2c=np.concatenate(T_w2c_all, axis=0),
        num_inliers=cat("num_inliers"), inlier_frac=cat("inlier_frac"),
        pose_ok=cat("pose_ok"),
    )
