"""The benchmark's scenes: blob worlds with exact ground truth.

A frozen copy of the port's scene model (``slam_tpu_torch/utils/
synthetic.py``: ``make_scene`` with blob texture, the ``loop`` and
``clover`` trajectories, ``render_frame_np``'s splat and ``to_u8``), so
that later changes to the program cannot change the benchmark's inputs.
``render_u8`` renders a whole sequence on the card in a few large calls
(float64 accumulation, as the numpy renderer's ``bincount``);
``render_frame_np`` is kept beside it as the model it is tested against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

KITTI_CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372],
                       np.float32)
KITTI_HW = (376, 1241)
STAMP_RADIUS = 2


@dataclass
class Scene:
    landmarks: np.ndarray      # (M, 3) world points (the GT geometry)
    T_w2c: np.ndarray          # (F, 4, 4) ground-truth extrinsics
    calib: np.ndarray          # [fx, fy, cx, cy, baseline]
    hw: tuple[int, int]
    render_points: np.ndarray  # (M*S, 3) landmark constellations
    render_intens: np.ndarray  # (M*S,)


def _extrinsics(yaw: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """T_w2c (F, 4, 4) of cameras at ``centers`` rotated by ``yaw`` about
    +y (float64 math, float32 result)."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.zeros((len(yaw), 4, 4), np.float64)
    T[:, 0, 0], T[:, 0, 2] = c, -s
    T[:, 1, 1] = 1.0
    T[:, 2, 0], T[:, 2, 2] = s, c
    T[:, 3, 3] = 1.0
    T[:, :3, 3] = -np.einsum("fij,fj->fi", T[:, :3, :3], centers)
    return T.astype(np.float32)


def loop_trajectory(num_frames: int, radius: float, turns: float = 1.0):
    """A closed circle from the origin, heading +z, centred at
    (radius, 0); yaw follows the path angle."""
    ang = np.linspace(0.0, turns * 2.0 * np.pi, num_frames)
    centers = np.stack([radius * (1.0 - np.cos(ang)), np.zeros_like(ang),
                        radius * np.sin(ang)], -1)
    return _extrinsics(ang, centers)


def clover_trajectory(num_frames: int, radii) -> np.ndarray:
    """Consecutive full circles of the given radii, all tangent at the
    origin with heading +z, at constant speed: a revisit at each lap's
    end (KITTI 00's loop structure)."""
    radii_np = np.asarray(radii, np.float64)
    cum = np.concatenate([[0.0], np.cumsum(2.0 * np.pi * radii_np)])
    s = np.linspace(0.0, cum[-1], num_frames, endpoint=False)
    ci = np.clip(np.searchsorted(cum, s, side="right") - 1, 0,
                 len(radii_np) - 1)
    R = radii_np[ci]
    ang = (s - cum[ci]) / R
    centers = np.stack([R * (1.0 - np.cos(ang)), np.zeros_like(ang),
                        R * np.sin(ang)], -1)
    return _extrinsics(ang, centers)


def _split_by_radius(radii, n: int) -> np.ndarray:
    radii_np = np.asarray(radii, np.float64)
    counts = np.maximum((radii_np / radii_np.sum() * n).astype(np.int64), 1)
    counts[-1] = n - counts[:-1].sum()
    return counts


def _annulus(rng, n, center_radius, half):
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    rad = center_radius + rng.uniform(-half, half, n)
    return np.stack([center_radius - rad * np.cos(ang),
                     rng.uniform(-4.0, 4.0, n), rad * np.sin(ang)], -1)


def make_scene(seed: int, num_frames: int, num_landmarks: int,
               trajectory: str, hw=KITTI_HW, calib=None,
               loop_radius: float = 25.0, loop_turns: float = 1.0,
               clover_radii=(100.0, 130.0, 160.0, 145.0),
               corridor_halfwidth: float = 25.0) -> Scene:
    """A world of landmarks (each a constellation of 4 Gaussian blobs)
    around a ground-truth trajectory, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if calib is None:  # KITTI 00's intrinsics scaled to the resolution
        sy, sx = hw[0] / KITTI_HW[0], hw[1] / KITTI_HW[1]
        calib = np.array([718.856 * sx, 718.856 * sy, 607.1928 * sx,
                          185.2157 * sy, 0.5372], np.float32)
    M = num_landmarks
    if trajectory == "loop":
        T_w2c = loop_trajectory(num_frames, loop_radius, loop_turns)
        landmarks = _annulus(rng, M, loop_radius, 0.6 * loop_radius)
    elif trajectory == "clover":
        T_w2c = clover_trajectory(num_frames, clover_radii)
        landmarks = np.concatenate([
            _annulus(rng, int(n), R_, corridor_halfwidth)
            for R_, n in zip(np.asarray(clover_radii, np.float64),
                             _split_by_radius(clover_radii, M))])
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")
    intens = 0.4 + 0.6 * rng.uniform(0.0, 1.0, M)
    S = 4  # the primary point plus S-1 satellites per landmark
    offsets = rng.uniform(-0.2, 0.2, (M, S - 1, 3))
    render_points = np.concatenate(
        [landmarks[:, None], landmarks[:, None] + offsets], 1).reshape(-1, 3)
    sat_int = intens[:, None] * (0.5 + 0.5 * rng.uniform(0.0, 1.0,
                                                         (M, S - 1)))
    render_intens = np.concatenate([intens[:, None], sat_int], 1).reshape(-1)
    return Scene(landmarks.astype(np.float32), T_w2c,
                 np.asarray(calib, np.float32), tuple(hw),
                 render_points.astype(np.float32),
                 render_intens.astype(np.float32))


def to_u8(img):
    """[0, 1] float images -> uint8 by truncation (the CLI's conversion)."""
    return np.clip(img * 255, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the numpy renderer (the model)
# ---------------------------------------------------------------------------

def _project_np(scene, pts: np.ndarray, frame: int):
    T = np.asarray(scene.T_w2c[frame])
    fx, fy, cx, cy, base = np.asarray(scene.calib)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    H, W = scene.hw
    zc = np.where(z > 1e-6, z, 1.0)
    uL = fx * pc[:, 0] / zc + cx
    uR = fx * (pc[:, 0] - base) / zc + cx
    v = fy * pc[:, 1] / zc + cy
    vis = ((z > 1.0) & (z < 200.0) & (uL >= 0) & (uL < W) & (uR >= 0)
           & (uR < W) & (v >= 0) & (v < H))
    return uL, uR, v, z, vis


def _splat_np(hw, us, vs, weights, radius: int = STAMP_RADIUS,
              sigma: float = 1.0):
    H, W = hw
    us = us.astype(np.float32)
    vs = vs.astype(np.float32)
    ui = np.floor(us).astype(np.int64)
    vi = np.floor(vs).astype(np.int64)
    fu, fv = us - ui, vs - vi
    img = np.zeros(H * W, np.float64)
    inv2s2 = 1.0 / (2.0 * np.asarray(sigma, np.float32) ** 2)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w = weights * np.exp(-((dx - fu) ** 2 + (dy - fv) ** 2) * inv2s2)
            x, y = ui + dx, vi + dy
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            if inb.any():
                img += np.bincount(y[inb] * W + x[inb],
                                   weights=w[inb].astype(np.float64),
                                   minlength=H * W)
    return img.reshape(H, W).astype(np.float32)


def render_frame_np(scene, frame: int):
    """The (left, right) grayscale pair of one frame, in [0, 1]."""
    pts = np.asarray(scene.render_points)
    intens = np.asarray(scene.render_intens)
    H, W = scene.hw
    uL, uR, v, z, vis = _project_np(scene, pts, frame)
    w = intens * np.clip(20.0 / np.maximum(z, 1.0), 0.5, 2.0)
    uL, uR, v, w = uL[vis], uR[vis], v[vis], w[vis]
    left = _splat_np(scene.hw, uL, v, w)
    right = _splat_np(scene.hw, uR, v, w)
    yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
    bg = 0.02 * np.sin(yy + frame * 0.1) * np.ones((1, W), np.float32)
    left = np.clip(left + bg + 0.05, 0.0, 1.0).astype(np.float32)
    right = np.clip(right + bg + 0.05, 0.0, 1.0).astype(np.float32)
    return left, right


# ---------------------------------------------------------------------------
# the renderer on the device
# ---------------------------------------------------------------------------

def render_float(scene, device, frames_per_call: int = 16):
    """Every frame's (left, right) pair in [0, 1], (F, H, W) float32 on
    ``device``: ``render_frame_np``'s splat for ``frames_per_call`` frames
    at a time, accumulated in float64."""
    F = scene.T_w2c.shape[0]
    H, W = scene.hw
    fx, fy, cx, cy, base = (float(v) for v in np.asarray(scene.calib))
    pts = torch.from_numpy(np.asarray(scene.render_points)).to(device)
    intens = torch.from_numpy(np.asarray(scene.render_intens)).to(device)
    T_all = torch.from_numpy(np.asarray(scene.T_w2c)).to(device)
    yy = torch.linspace(0, 4 * np.pi, H, dtype=torch.float32, device=device)
    offs = torch.arange(-STAMP_RADIUS, STAMP_RADIUS + 1, device=device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)        # the stamp's taps
    out_l = torch.empty((F, H, W), dtype=torch.float32, device=device)
    out_r = torch.empty_like(out_l)
    for f0 in range(0, F, frames_per_call):
        T = T_all[f0:f0 + frames_per_call]
        n = T.shape[0]
        pc = torch.einsum("pj,fij->fpi", pts, T[:, :3, :3]) + T[:, None, :3, 3]
        z = pc[..., 2]
        zc = torch.where(z > 1e-6, z, torch.ones_like(z))
        uL = fx * pc[..., 0] / zc + cx
        uR = fx * (pc[..., 0] - base) / zc + cx
        v = fy * pc[..., 1] / zc + cy
        vis = ((z > 1.0) & (z < 200.0) & (uL >= 0) & (uL < W) & (uR >= 0)
               & (uR < W) & (v >= 0) & (v < H))
        w = intens * torch.clamp(20.0 / torch.clamp(z, min=1.0), 0.5, 2.0)
        fidx = torch.arange(n, device=device)[:, None].expand_as(z)
        for us, out in ((uL, out_l), (uR, out_r)):
            f_, u_, v_, w_ = fidx[vis], us[vis], v[vis], w[vis]
            ui, vi = torch.floor(u_), torch.floor(v_)
            fu, fv = u_ - ui, v_ - vi
            x = ui.long()[:, None] + dx
            y = vi.long()[:, None] + dy
            tap = w_[:, None] * torch.exp(-((dx - fu[:, None]) ** 2
                                            + (dy - fv[:, None]) ** 2) * 0.5)
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            flat = (f_[:, None] * H + y) * W + x
            img = torch.zeros(n * H * W, dtype=torch.float64, device=device)
            img.index_add_(0, flat[inb], tap[inb].double())
            img = img.view(n, H, W).float()
            frame = torch.arange(f0, f0 + n, device=device,
                                 dtype=torch.float32)
            bg = 0.02 * torch.sin(yy[None, :] + frame[:, None] * 0.1)
            out[f0:f0 + n] = torch.clamp(img + bg[:, :, None] + 0.05,
                                         0.0, 1.0)
    return out_l, out_r


def render_u8(scene, device):
    """Every frame as host uint8 (F, H, W) pairs (``to_u8`` on the
    device, one copy each)."""
    out = []
    for img in render_float(scene, device):
        out.append(torch.clamp(img * 255, 0, 255).to(torch.uint8).cpu()
                   .numpy())
    return out[0], out[1]
