"""Synthetic stereo sequences with exact ground truth, in numpy.

Counterpart of ``slam_tpu/utils/synthetic.py``: a camera trajectory
("straight", "loop", or the multi-revisit "clover") through a field of
landmarks, each rendered as a small 3D cluster of Gaussian blobs (a
unique constellation per landmark, so descriptors can tell landmarks
apart), with the KITTI seq 00 camera profile scaled to the requested
resolution. ``texture="fractal"`` adds a dense surface texture field with
natural-image statistics (multi-octave value-noise albedo, heavy-tailed
amplitudes, power-law splat sizes), rendered by mip-octave splatting
under auto-exposure, exposure drift and sensor noise.

The landmarks and the texture field are drawn with a numpy
``Generator`` from ``seed``, so the same seed gives a different scene
than the JAX package's ``jax.random`` draws; the trajectories, the
fractal albedo and the renderer are the same model, and given the same
scene arrays the renderer gives the same images. The renderer is the JAX
package's host one (``render_frame_np``): its device renderer
``render_frame`` and ``host_scene``, which pulls a scene's device arrays
to the host once before a render loop, have no counterpart, since every
array here is host numpy already.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, as_completed
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
    texture: str = "blobs"                 # "blobs" | "fractal"
    tex_points: np.ndarray | None = None   # (T, 3) fractal texture field
    tex_intens: np.ndarray | None = None   # (T,) signed albedo contrast
    tex_sigma: np.ndarray | None = None    # (T,) splat sigma at 20 m [px]
    photometric: bool = False              # exposure drift + sensor noise


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


def clover_trajectory(num_frames: int,
                      radii=(100.0, 130.0, 160.0, 145.0)) -> np.ndarray:
    """KITTI seq 00's loop structure: consecutive full circles of
    different radii, all tangent at the origin with heading +z, at
    constant speed (arc length spread uniformly over the frames). Every
    lap passes back through the tangent region, so the sequence has a
    revisit at each lap's end, separated by long unfamiliar stretches.
    Ground truth, so float64 math (float32 result)."""
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


def lap_end_frames(num_frames: int, radii) -> np.ndarray:
    """The frame at which each lap of :func:`clover_trajectory` returns to
    the origin (the last one is ``num_frames``, one past the sequence):
    the clover's revisit events."""
    lengths = 2.0 * np.pi * np.asarray(radii, np.float64)
    return np.rint(np.cumsum(lengths) / lengths.sum() * num_frames).astype(
        np.int64)


# ---------------------------------------------------------------------------
# fractal (natural-image-statistics) texture field
# ---------------------------------------------------------------------------

def _hash3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
           seed: int) -> np.ndarray:
    """Integer-mix hash of 3D lattice coords -> uniform [0, 1) float64."""
    h = (ix.astype(np.int64) * 374761393
         + iy.astype(np.int64) * 668265263
         + iz.astype(np.int64) * 1013904223
         + np.int64(seed) * 974711) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).astype(np.float64) / float(0x1000000)


def _value_noise3(pts: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """Trilinear value noise at world points (smoothstep-blended lattice)."""
    p = pts / scale
    i = np.floor(p).astype(np.int64)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)
    out = np.zeros(len(pts), np.float64)
    for dx in (0, 1):
        wx = u[:, 0] if dx else 1.0 - u[:, 0]
        for dy in (0, 1):
            wy = u[:, 1] if dy else 1.0 - u[:, 1]
            for dz in (0, 1):
                wz = u[:, 2] if dz else 1.0 - u[:, 2]
                c = _hash3(i[:, 0] + dx, i[:, 1] + dy, i[:, 2] + dz, seed)
                out += c * (wx * wy * wz)
    return out


def fractal_albedo(pts: np.ndarray, octaves: int = 5, base_scale: float = 8.0,
                   persistence: float = 0.55, seed: int = 0) -> np.ndarray:
    """Multi-octave fractal value noise in [0, 1] at 3D world points, the
    textured scene's albedo (1/f statistics)."""
    amp, tot = 1.0, 0.0
    out = np.zeros(len(pts), np.float64)
    for o in range(octaves):
        out += amp * _value_noise3(pts, base_scale / (2.0 ** o), seed + o)
        tot += amp
        amp *= persistence
    return (out / tot).astype(np.float32)


def _split_by_radius(radii, n: int) -> np.ndarray:
    """Counts per clover lobe proportional to its circumference (uniform
    density along the path), summing to ``n``."""
    radii_np = np.asarray(radii, np.float64)
    counts = np.maximum((radii_np / radii_np.sum() * n).astype(np.int64), 1)
    counts[-1] = n - counts[:-1].sum()
    return counts


def _texture_field(rng, T_w2c, trajectory, nt, num_frames, step_m,
                   corridor_halfwidth, loop_radius, clover_radii, seed):
    """The fractal texture: (points, signed intensities, splat sigmas).

    Texture lies on surfaces (a ground plane 1.75 m below the camera and
    two corridor walls), not in a volume: a volumetric splat cloud is
    semi-transparent, so a descriptor patch would mix depths whose
    parallax differs between the eyes. A 2 m strip around the camera path
    (the road) is kept clear. Amplitudes are heavy-tailed (Pareto), splat
    sizes follow p(s) ~ s^-2.5 on [0.7, 6] px."""
    def surface(nn, hw_):
        s = rng.uniform(0, 1, nn)
        ground = s < 0.5
        wall_r = s >= 0.75
        lat = np.where(ground, rng.uniform(-hw_, hw_, nn),
                       np.where(wall_r, hw_, -hw_) + rng.normal(0, 0.4, nn))
        y = np.where(ground, 1.75 + rng.normal(0, 0.12, nn),
                     rng.uniform(-4.0, 1.8, nn))
        return lat, y

    if trajectory == "straight":
        lat, y = surface(nt, corridor_halfwidth)
        pts = np.stack([lat, y, rng.uniform(-10.0, num_frames * step_m + 60.0,
                                            nt)], axis=-1)
    elif trajectory == "loop":
        ang = rng.uniform(0, 2 * np.pi, nt)
        lat, y = surface(nt, 0.6 * loop_radius)
        rad = loop_radius + lat
        pts = np.stack([loop_radius - rad * np.cos(ang), y,
                        rad * np.sin(ang)], axis=-1)
    else:
        parts = []
        for R_, n_ in zip(np.asarray(clover_radii, np.float64),
                          _split_by_radius(clover_radii, nt)):
            ang = rng.uniform(0, 2 * np.pi, int(n_))
            lat, y = surface(int(n_), corridor_halfwidth)
            rad = R_ + lat
            parts.append(np.stack([R_ - rad * np.cos(ang), y,
                                   rad * np.sin(ang)], axis=-1))
        pts = np.concatenate(parts, axis=0)
    T = np.asarray(T_w2c)
    centers = -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])
    sub = centers[:: max(1, len(centers) // 300)][:, [0, 2]]
    pxz = pts[:, [0, 2]]
    d2 = np.full(len(pts), np.inf)
    for c0 in np.array_split(sub, max(1, len(sub) // 64)):
        d2 = np.minimum(d2, ((pxz[:, None, :] - c0[None]) ** 2).sum(-1)
                        .min(1))
    pts = pts[d2 > 2.0 ** 2]
    nt = len(pts)
    a = fractal_albedo(pts, octaves=5, base_scale=9.0, seed=seed & 0xFFFF)
    pareto = (1.0 + rng.pareto(1.2, nt)).clip(max=25.0).astype(np.float32)
    pareto /= float(pareto.mean())
    intens = (1.15 * (a - float(a.mean())) * pareto).astype(np.float32)
    s_min, s_max, alpha = 0.7, 6.0, 2.5
    u = rng.uniform(0, 1, nt)
    one_a = 1.0 - alpha
    sigma = ((s_min ** one_a + u * (s_max ** one_a - s_min ** one_a))
             ** (1.0 / one_a)).astype(np.float32)
    return pts.astype(np.float32), intens, sigma


def _annulus(rng, n, center_radius, half):
    """n landmarks in an annulus of half width ``half`` around the circle
    of radius ``center_radius`` centered at (center_radius, 0) in x-z."""
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    rad = center_radius + rng.uniform(-half, half, n)
    return np.stack([center_radius - rad * np.cos(ang),
                     rng.uniform(-4.0, 4.0, n), rad * np.sin(ang)], -1)


def make_scene(seed: int = 0, num_frames: int = 50,
               num_landmarks: int = 4000, trajectory: str = "straight",
               hw: tuple[int, int] = (192, 320),
               calib: np.ndarray | None = None, step_m: float = 1.0,
               corridor_halfwidth: float = 25.0, loop_radius: float = 25.0,
               loop_turns: float = 1.0,
               clover_radii=(100.0, 130.0, 160.0, 145.0),
               texture: str = "blobs",
               num_texture_points: int | None = None) -> Scene:
    """A synthetic world: landmarks + ground-truth trajectory."""
    rng = np.random.default_rng(seed)
    if calib is None:  # KITTI intrinsics scaled to the resolution
        sy, sx = hw[0] / KITTI_HW[0], hw[1] / KITTI_HW[1]
        calib = np.array([718.856 * sx, 718.856 * sy, 607.1928 * sx,
                          185.2157 * sy, 0.5372], np.float32)
    if texture not in ("blobs", "fractal"):
        raise ValueError(f"unknown texture {texture!r}")
    M = num_landmarks
    if trajectory == "straight":
        T_w2c = straight_trajectory(num_frames, step_m)
        landmarks = np.stack([
            rng.uniform(-corridor_halfwidth, corridor_halfwidth, M),
            rng.uniform(-4.0, 4.0, M),
            rng.uniform(-10.0, num_frames * step_m + 60.0, M)], -1)
    elif trajectory == "loop":
        T_w2c = loop_trajectory(num_frames, loop_radius, loop_turns)
        landmarks = _annulus(rng, M, loop_radius, 0.6 * loop_radius)
    elif trajectory == "clover":
        # a corridor around each lobe, landmarks in proportion to its
        # circumference
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
    tex = (None, None, None)
    if texture == "fractal":
        # default density: 40 field points per landmark, capped so that
        # reference-scale scenes stay renderable in minutes
        nt = (num_texture_points if num_texture_points is not None
              else min(40 * num_landmarks, 1_500_000))
        tex = _texture_field(np.random.default_rng(seed ^ 0x5EED7E), T_w2c,
                             trajectory, nt, num_frames, step_m,
                             corridor_halfwidth, loop_radius, clover_radii,
                             seed)
    return Scene(landmarks.astype(np.float32), intens.astype(np.float32),
                 T_w2c, np.asarray(calib, np.float32), tuple(hw),
                 render_points.astype(np.float32),
                 render_intens.astype(np.float32), texture=texture,
                 tex_points=tex[0], tex_intens=tex[1], tex_sigma=tex[2],
                 photometric=texture == "fractal")


# ---------------------------------------------------------------------------
# exact geometry observations (no images)
# ---------------------------------------------------------------------------

def _project_np(scene, pts: np.ndarray, frame: int):
    """(uL, uR, v, z, vis) of world points in the given frame."""
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


def observe_frame(scene: Scene, frame: int, noise_px: float = 0.0,
                  rng: np.random.Generator | None = None):
    """Exact stereo measurements of every landmark in one frame: (meas
    (M, 3) = (uL, uR, v), visible (M,) bool, camera-frame points (M, 3)),
    with Gaussian pixel noise from ``rng`` when ``noise_px`` > 0."""
    T = np.asarray(scene.T_w2c[frame])
    pc = scene.landmarks @ T[:3, :3].T + T[:3, 3]
    fx, fy, cx, cy, base = np.asarray(scene.calib)
    z = np.where(np.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    meas = np.stack([fx * pc[:, 0] / z + cx, fx * (pc[:, 0] - base) / z + cx,
                     fy * pc[:, 1] / z + cy], -1).astype(np.float32)
    H, W = scene.hw
    vis = ((pc[:, 2] > 1.0) & (pc[:, 2] < 200.0)
           & (meas[:, 0] >= 0) & (meas[:, 0] < W)
           & (meas[:, 1] >= 0) & (meas[:, 1] < W)
           & (meas[:, 2] >= 0) & (meas[:, 2] < H))
    if noise_px > 0.0 and rng is not None:
        meas = meas + noise_px * rng.standard_normal(meas.shape).astype(
            np.float32)
    return meas, vis, pc.astype(np.float32)


# ---------------------------------------------------------------------------
# image rendering
# ---------------------------------------------------------------------------

def _splat_np(hw, us, vs, weights, radius: int = 2, sigma=1.0):
    """Stamped (2r+1)^2 Gaussian splatting by bincount accumulation;
    ``sigma`` is a scalar or one per point."""
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


def _upsample_bilinear_np(img: np.ndarray, s: int, out_hw) -> np.ndarray:
    """Bilinear x``s`` upsample with the pixel-center convention
    dst(x) <- src((x + 0.5) / s - 0.5)."""
    if s == 1:
        return img[: out_hw[0], : out_hw[1]]
    Hs, Ws = img.shape
    H, W = out_hw
    ys = (np.arange(H, dtype=np.float32) + 0.5) / s - 0.5
    xs = (np.arange(W, dtype=np.float32) + 0.5) / s - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, Hs - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, Ws - 1)
    y1 = np.minimum(y0 + 1, Hs - 1)
    x1 = np.minimum(x0 + 1, Ws - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return ((a * (1 - fx) + b * fx) * (1 - fy)
            + (c * (1 - fx) + d * fx) * fy).astype(np.float32)


def _splat_np_multiscale(hw, us, vs, weights, sigmas) -> np.ndarray:
    """Variable-size Gaussian splatting by mip octaves: octave o renders
    sigmas in ~[0.75 * 2^o, 1.5 * 2^o) at 1/2^o resolution with a 7x7
    stamp, then upsamples bilinearly. The upsampling's constant sub-pixel
    offset is shared by both eyes and all frames, so disparity and motion
    stay exact."""
    H, W = hw
    sigmas = np.asarray(sigmas, np.float32)
    oct_idx = np.clip(np.floor(np.log2(np.maximum(sigmas, 1e-3) / 0.75))
                      .astype(np.int64), 0, 3)
    img = np.zeros((H, W), np.float32)
    for o in range(4):
        m = oct_idx == o
        if not m.any():
            continue
        s = 1 << o
        Ho, Wo = (H + s - 1) // s, (W + s - 1) // s
        sub = _splat_np((Ho, Wo), (us[m] + 0.5) / s - 0.5,
                        (vs[m] + 0.5) / s - 0.5, weights[m], radius=3,
                        sigma=np.clip(sigmas[m] / s, 0.5, 1.6))
        img += _upsample_bilinear_np(sub, s, (H, W))
    return img


def _photometric_np(img: np.ndarray, frame: int, eye: int) -> np.ndarray:
    """Exposure drift (gain and bias shared by the stereo pair) and
    per-eye Gaussian read noise, deterministic in the frame index."""
    rs = np.random.default_rng(910_001 + 7 * frame)
    gain = (1.0 + 0.10 * np.sin(2 * np.pi * frame / 700.0)
            + 0.03 * rs.standard_normal())
    bias = (0.02 * np.sin(2 * np.pi * frame / 430.0)
            + 0.01 * rs.standard_normal())
    nrng = np.random.default_rng(7717 * (frame + 1) + eye)
    out = gain * img + bias + 0.012 * nrng.standard_normal(
        img.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def render_frame_np(scene, frame: int):
    """The (left, right) grayscale pair of one frame, in [0, 1]. Reads the
    scene's arrays by name, so any scene object with host arrays of these
    names renders (the JAX package's ``host_scene`` too)."""
    pts = np.asarray(scene.render_points)
    intens = np.asarray(scene.render_intens)
    H, W = scene.hw
    uL, uR, v, z, vis = _project_np(scene, pts, frame)
    w = intens * np.clip(20.0 / np.maximum(z, 1.0), 0.5, 2.0)
    uL, uR, v, w = uL[vis], uR[vis], v[vis], w[vis]

    if scene.texture == "fractal":
        # mid-gray base + the texture field (signed contrast, projected
        # splat size ~ 1/z) + the landmark constellations at half weight
        tuL, tuR, tv, tz, tvis = _project_np(
            scene, np.asarray(scene.tex_points), frame)
        ti = np.asarray(scene.tex_intens)[tvis]
        ts = np.asarray(scene.tex_sigma)[tvis] * np.clip(
            20.0 / np.maximum(tz[tvis], 1.0), 0.12, 2.5)
        tw = ti * np.clip(20.0 / np.maximum(tz[tvis], 1.0), 0.4, 1.6)
        left = _splat_np_multiscale(scene.hw, tuL[tvis], tv[tvis], tw, ts)
        right = _splat_np_multiscale(scene.hw, tuR[tvis], tv[tvis], tw, ts)
        left += _splat_np(scene.hw, uL, v, 0.5 * w)
        right += _splat_np(scene.hw, uR, v, 0.5 * w)
        yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
        bg = 0.38 + 0.03 * np.sin(yy) * np.ones((1, W), np.float32)
        left = left + bg
        right = right + bg
        # auto-exposure shared by the pair: splat weights accumulate, so
        # percentile mapping bounds the clipping to the 5% tails for any
        # texture density
        p5, p95 = np.percentile(left, [5.0, 95.0])
        gain = 0.8 / max(float(p95 - p5), 0.05)
        bias = 0.45 - gain * 0.5 * float(p5 + p95)
        left = np.clip(gain * left + bias, 0.0, 1.0).astype(np.float32)
        right = np.clip(gain * right + bias, 0.0, 1.0).astype(np.float32)
        if scene.photometric:
            left = _photometric_np(left, frame, eye=0)
            right = _photometric_np(right, frame, eye=1)
        return left, right

    left = _splat_np(scene.hw, uL, v, w)
    right = _splat_np(scene.hw, uR, v, w)
    yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
    bg = 0.02 * np.sin(yy + frame * 0.1) * np.ones((1, W), np.float32)
    left = np.clip(left + bg + 0.05, 0.0, 1.0).astype(np.float32)
    right = np.clip(right + bg + 0.05, 0.0, 1.0).astype(np.float32)
    return left, right


def render_sequence(scene):
    """All frames as host numpy (F, H, W) float32 pairs."""
    F = scene.T_w2c.shape[0]
    H, W = scene.hw
    L = np.empty((F, H, W), np.float32)
    R = np.empty((F, H, W), np.float32)
    for f in range(F):
        L[f], R[f] = render_frame_np(scene, f)
    return L, R


def to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float images -> uint8 by truncation (the CLI's and the scale
    run's conversion)."""
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def _render_block(scene, path_left, path_right, lo: int, hi: int) -> int:
    """Render frames [lo, hi) as uint8 into the two .npy files."""
    L = np.load(path_left, mmap_mode="r+")
    R = np.load(path_right, mmap_mode="r+")
    for f in range(lo, hi):
        lf, rf = render_frame_np(scene, f)
        L[f], R[f] = to_u8(lf), to_u8(rf)
    L.flush()
    R.flush()
    return hi - lo


_WORKER_SCENE = None  # a pool worker's scene, set once by its initializer


def _init_worker(scene) -> None:
    global _WORKER_SCENE
    _WORKER_SCENE = scene


def _render_range(args) -> int:
    return _render_block(_WORKER_SCENE, *args)


def render_to_npy(scene: Scene, path_left, path_right, processes: int = 1,
                  progress=None) -> None:
    """Render every frame as uint8 (:func:`to_u8`) into two (F, H, W) .npy
    files, on ``processes`` worker processes (each given the scene once)
    when more than one: the frames are independent, so the files equal a
    serial render's. ``progress(done, total)`` is called as blocks of
    frames finish. The workers are forked from a server process that
    imports this module once: importing the package imports torch, which
    takes seconds, and workers spawned together, each importing it, cost
    more than a few hundred frames' render."""
    F = int(scene.T_w2c.shape[0])
    H, W = scene.hw
    for p in (path_left, path_right):
        np.lib.format.open_memmap(str(p), mode="w+", dtype=np.uint8,
                                  shape=(F, H, W)).flush()
    block = 16
    tasks = [(str(path_left), str(path_right), lo, min(lo + block, F))
             for lo in range(0, F, block)]
    done = 0
    if processes <= 1:
        for t in tasks:
            done += _render_block(scene, *t)
            if progress is not None:
                progress(done, F)
        return
    # an executor, not a Pool: a worker that dies raises BrokenProcessPool
    # here instead of leaving the caller waiting. Workers fork from a
    # server that is itself a fresh process and only imports this module.
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    with ProcessPoolExecutor(processes, mp_context=ctx,
                             initializer=_init_worker,
                             initargs=(scene,)) as pool:
        for fut in as_completed([pool.submit(_render_range, t)
                                 for t in tasks]):
            done += fut.result()
            if progress is not None:
                progress(done, F)


# ---------------------------------------------------------------------------
# one bundle-adjustment problem (no images)
# ---------------------------------------------------------------------------

def megaproblem(calib, P: int, L: int, obs_per_lm: int, seed: int,
                noise_px: float = 0.3):
    """One bundle as the JAX package's ``tests/test_tp_megabundle.py``
    builds it, in numpy from ``seed``: P poses along that test's 6.3 m
    path (its 8 poses 0.9 m apart, slightly turning; a larger P samples
    the same path more densely, where poses 0.9 m apart would leave the
    landmarks behind the later cameras and the reduced system too
    ill-conditioned for float32), L landmarks 8-48 m ahead, each seen by
    ``obs_per_lm`` random cameras with ``noise_px`` of stereo noise
    (weight 0 where the landmark lies within 0.5 m of the camera plane or
    behind it), the initial poses perturbed by ~0.015 per twist entry
    (pose 0 exact) and the landmarks by 0.15 m. Returns float32 / int32
    arrays (poses_gt, points_gt, poses0, points0, cam_idx, lm_idx, meas,
    w)."""
    import torch

    from ..ops import se3, stereo

    rng = np.random.default_rng(seed)
    t = np.arange(P, dtype=np.float32) * (7.0 / (P - 1))
    xi = np.stack([np.zeros_like(t), 0.02 * t, np.zeros_like(t),
                   0.1 * t, np.zeros_like(t), -0.9 * t], -1)
    poses_gt = se3.se3_exp(torch.as_tensor(xi))
    u = rng.uniform(size=(L, 3)).astype(np.float32)
    points_gt = np.stack([(u[:, 0] - 0.5) * 24.0, (u[:, 1] - 0.5) * 6.0,
                          8.0 + u[:, 2] * 40.0], -1)
    lm_idx = np.repeat(np.arange(L), obs_per_lm).astype(np.int32)
    cam_idx = rng.integers(0, P, size=L * obs_per_lm).astype(np.int32)
    T = poses_gt[torch.as_tensor(cam_idx).long()]
    Xc = se3.mv3(T[:, :3, :3], torch.as_tensor(points_gt[lm_idx])) \
        + T[:, :3, 3]
    meas = (stereo.project(torch.as_tensor(calib, dtype=torch.float32),
                           Xc).numpy()
            + noise_px * rng.standard_normal((len(lm_idx), 3))
            ).astype(np.float32)
    w = (Xc[:, 2] > 0.5).numpy().astype(np.float32)
    dpose = 0.015 * rng.standard_normal((P, 6)).astype(np.float32)
    dpose[0] = 0.0
    poses0 = se3.retract(poses_gt, torch.as_tensor(dpose)).numpy()
    points0 = (points_gt + 0.15 * rng.standard_normal((L, 3))).astype(
        np.float32)
    return (poses_gt.numpy(), points_gt, poses0, points0, cam_idx, lm_idx,
            meas, w)


def twist_err(A, B) -> float:
    """Largest norm of log(A_p^-1 B_p) over two pose stacks (float64)."""
    import torch

    from ..ops import se3

    d = se3.local(torch.as_tensor(np.array(A), dtype=torch.float64),
                  torch.as_tensor(np.array(B), dtype=torch.float64))
    return float(torch.linalg.vector_norm(d, dim=-1).max())
