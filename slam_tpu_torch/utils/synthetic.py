"""Synthetic stereo sequences with exact ground truth, in numpy.

Counterpart of the blob-scene part of ``slam_tpu/utils/synthetic.py``: a
camera trajectory ("straight" or "loop") through a field of landmarks,
each rendered as a small 3D cluster of Gaussian blobs (a unique
constellation per landmark, so descriptors can tell landmarks apart),
over a weak vertical background gradient, with the KITTI seq 00 camera
profile scaled to the requested resolution.

The landmarks are drawn with a numpy ``Generator``, so the same seed
gives a different scene than the JAX package's ``jax.random`` draws; the
trajectories and the renderer are the same model. Parity tests render
their scenes with the JAX package and hand the same images to both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KITTI_CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372],
                       np.float32)
KITTI_HW = (376, 1241)


@dataclass
class Scene:
    landmarks: np.ndarray      # (M, 3) world points (the GT geometry)
    intensities: np.ndarray    # (M,) blob brightness
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
    # rows of R^T for R_c2w = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:, 0, 0], T[:, 0, 2] = c, -s
    T[:, 1, 1] = 1.0
    T[:, 2, 0], T[:, 2, 2] = s, c
    T[:, 3, 3] = 1.0
    T[:, :3, 3] = -np.einsum("fij,fj->fi", T[:, :3, :3], centers)
    return T.astype(np.float32)


def straight_trajectory(num_frames: int, step_m: float = 1.0) -> np.ndarray:
    """Forward motion along +z with mild lateral sway."""
    t = np.arange(num_frames, dtype=np.float64)
    centers = np.stack([0.5 * np.sin(t * 0.05), np.zeros_like(t),
                        t * step_m], -1)
    return _extrinsics(0.02 * np.sin(t * 0.03), centers)


def loop_trajectory(num_frames: int, radius: float = 60.0,
                    turns: float = 1.0) -> np.ndarray:
    """Closed circular loop starting at the origin looking along +z, the
    circle's center at (radius, 0); yaw follows the path angle."""
    ang = np.linspace(0.0, turns * 2.0 * np.pi, num_frames)
    centers = np.stack([radius * (1.0 - np.cos(ang)), np.zeros_like(ang),
                        radius * np.sin(ang)], -1)
    return _extrinsics(ang, centers)


def make_scene(seed: int = 0, num_frames: int = 50,
               num_landmarks: int = 4000, trajectory: str = "straight",
               hw: tuple[int, int] = (192, 320),
               calib: np.ndarray | None = None, step_m: float = 1.0,
               corridor_halfwidth: float = 25.0, loop_radius: float = 25.0,
               loop_turns: float = 1.0) -> Scene:
    """A synthetic world: landmarks + ground-truth trajectory."""
    rng = np.random.default_rng(seed)
    if calib is None:  # KITTI intrinsics scaled to the resolution
        sy, sx = hw[0] / KITTI_HW[0], hw[1] / KITTI_HW[1]
        calib = np.array([718.856 * sx, 718.856 * sy, 607.1928 * sx,
                          185.2157 * sy, 0.5372], np.float32)
    M = num_landmarks
    if trajectory == "straight":
        T_w2c = straight_trajectory(num_frames, step_m)
        landmarks = np.stack([
            rng.uniform(-corridor_halfwidth, corridor_halfwidth, M),
            rng.uniform(-4.0, 4.0, M),
            rng.uniform(-10.0, num_frames * step_m + 60.0, M)], -1)
    elif trajectory == "loop":
        T_w2c = loop_trajectory(num_frames, loop_radius, loop_turns)
        ang = rng.uniform(0.0, 2.0 * np.pi, M)
        half = 0.6 * loop_radius
        rad = loop_radius + rng.uniform(-half, half, M)
        landmarks = np.stack([loop_radius - rad * np.cos(ang),
                              rng.uniform(-4.0, 4.0, M),
                              rad * np.sin(ang)], -1)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r} "
                         "(the port has 'straight' and 'loop')")
    intens = 0.4 + 0.6 * rng.uniform(0.0, 1.0, M)
    S = 4  # the primary point plus S-1 satellites per landmark
    offsets = rng.uniform(-0.2, 0.2, (M, S - 1, 3))
    render_points = np.concatenate(
        [landmarks[:, None], landmarks[:, None] + offsets], 1).reshape(-1, 3)
    sat_int = intens[:, None] * (0.5 + 0.5 * rng.uniform(0.0, 1.0,
                                                         (M, S - 1)))
    render_intens = np.concatenate([intens[:, None], sat_int], 1).reshape(-1)
    return Scene(landmarks.astype(np.float32), intens.astype(np.float32),
                 T_w2c, np.asarray(calib, np.float32), tuple(hw),
                 render_points.astype(np.float32),
                 render_intens.astype(np.float32))


def _splat_np(hw, us, vs, weights, radius: int = 2, sigma: float = 1.0):
    """Stamped (2r+1)^2 Gaussian splatting by bincount accumulation."""
    H, W = hw
    us = us.astype(np.float32)
    vs = vs.astype(np.float32)
    ui = np.floor(us).astype(np.int64)
    vi = np.floor(vs).astype(np.int64)
    fu, fv = us - ui, vs - vi
    img = np.zeros(H * W, np.float64)
    inv2s2 = 1.0 / (2.0 * np.float32(sigma) ** 2)
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


def render_frame_np(scene: Scene, frame: int):
    """The (left, right) grayscale pair of one frame, in [0, 1]."""
    T = scene.T_w2c[frame]
    fx, fy, cx, cy, base = scene.calib
    H, W = scene.hw
    pc = scene.render_points @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    zc = np.where(z > 1e-6, z, 1.0)
    uL = fx * pc[:, 0] / zc + cx
    uR = fx * (pc[:, 0] - base) / zc + cx
    v = fy * pc[:, 1] / zc + cy
    vis = ((z > 1.0) & (z < 200.0) & (uL >= 0) & (uL < W) & (uR >= 0)
           & (uR < W) & (v >= 0) & (v < H))
    w = scene.render_intens * np.clip(20.0 / np.maximum(z, 1.0), 0.5, 2.0)
    left = _splat_np(scene.hw, uL[vis], v[vis], w[vis])
    right = _splat_np(scene.hw, uR[vis], v[vis], w[vis])
    yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
    bg = 0.02 * np.sin(yy + frame * 0.1) * np.ones((1, W), np.float32)
    left = np.clip(left + bg + 0.05, 0.0, 1.0).astype(np.float32)
    right = np.clip(right + bg + 0.05, 0.0, 1.0).astype(np.float32)
    return left, right


def render_sequence(scene: Scene):
    """All frames as host numpy (F, H, W) float32 pairs."""
    F = scene.T_w2c.shape[0]
    H, W = scene.hw
    L = np.empty((F, H, W), np.float32)
    R = np.empty((F, H, W), np.float32)
    for f in range(F):
        L[f], R[f] = render_frame_np(scene, f)
    return L, R
