"""The port's scene generator and renderer against the JAX package's.

The port draws its scenes with a numpy Generator (the JAX package with
jax.random), so scenes are compared where they are the same model: the
clover trajectory, the fractal albedo, the exact observations and, given
the same scene arrays (a scene made by the JAX package), the rendered
images."""

import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)


@pytest.mark.parametrize("frames,radii", [
    (3360, (100.0, 130.0, 160.0, 145.0)), (336, (10.0, 13.0, 16.0, 14.5)),
    (40, (4.0, 5.0))])
def test_clover_trajectory_equals_jax(frames, radii):
    """The same float32 extrinsics to 1e-6 (both are float64 numpy math;
    the JAX package returns them as float32 jnp); each lap ends at the
    origin."""
    T = synthetic.clover_trajectory(frames, radii)
    Tj = np.asarray(jsynth.clover_trajectory(frames, radii))
    assert T.dtype == np.float32 and T.shape == (frames, 4, 4)
    np.testing.assert_allclose(T, Tj, atol=1e-6)
    ends = synthetic.lap_end_frames(frames, radii)
    assert ends[-1] == frames
    centers = -np.einsum("fji,fj->fi", T[:, :3, :3].astype(np.float64),
                         T[:, :3, 3])
    step = 2 * np.pi * sum(radii) / frames
    for e in ends[:-1]:
        assert np.linalg.norm(centers[e]) < 1.01 * step


def test_fractal_albedo_equals_jax():
    """The multi-octave value noise at 5000 world points, bit for bit (the
    same integer hash and float64 arithmetic), in [0, 1]."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-200, 200, (5000, 3))
    for kw in ({}, {"octaves": 5, "base_scale": 9.0, "seed": 1234}):
        a = synthetic.fractal_albedo(pts, **kw)
        np.testing.assert_array_equal(a, jsynth.fractal_albedo(pts, **kw))
        assert a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(
        synthetic._hash3(*pts.astype(np.int64).T, 7),
        jsynth._hash3(*pts.astype(np.int64).T, 7))


@pytest.mark.parametrize("trajectory,texture", [
    ("loop", "blobs"), ("clover", "blobs"), ("straight", "fractal"),
    ("clover", "fractal")])
def test_render_of_a_jax_scene_equals_jax(trajectory, texture):
    """A scene made by the JAX package, rendered by both host renderers:
    the same images to 1e-6 (the fractal path too: multiscale splat,
    bilinear upsample, auto-exposure and the photometric model)."""
    scene = jsynth.host_scene(jsynth.make_scene(
        jax.random.PRNGKey(5), num_frames=12, num_landmarks=600,
        trajectory=trajectory, hw=(72, 160), loop_radius=10.0,
        clover_radii=(3.0, 4.0), corridor_halfwidth=4.0, texture=texture,
        num_texture_points=6000))
    for f in (0, 5, 11):
        l, r = synthetic.render_frame_np(scene, f)
        lj, rj = jsynth.render_frame_np(scene, f)
        np.testing.assert_allclose(l, lj, atol=1e-6)
        np.testing.assert_allclose(r, rj, atol=1e-6)


def test_port_clover_and_fractal_scenes():
    """The port's own clover scene: its trajectory is the JAX package's;
    landmarks lie in the corridors around the lobes, in proportion to
    their circumference; the fractal texture field keeps the 2 m road
    clear; frames render in [0, 1]; a seed gives the same scene."""
    radii = (6.0, 8.0)
    kw = dict(seed=4, num_frames=30, num_landmarks=1000,
              trajectory="clover", hw=(64, 128), clover_radii=radii,
              corridor_halfwidth=2.0, texture="fractal",
              num_texture_points=4000)
    sc = synthetic.make_scene(**kw)
    np.testing.assert_allclose(
        sc.T_w2c, np.asarray(jsynth.clover_trajectory(30, radii)), atol=1e-6)
    xz = sc.landmarks[:, [0, 2]].astype(np.float64)
    d = np.minimum(np.abs(np.hypot(xz[:, 0] - 6.0, xz[:, 1]) - 6.0),
                   np.abs(np.hypot(xz[:, 0] - 8.0, xz[:, 1]) - 8.0))
    assert d.max() <= 2.0 + 1e-4
    assert abs((np.hypot(xz[:, 0] - 6.0, xz[:, 1]) < 7.0).mean()
               - 6 / 14) < 0.1
    assert sc.tex_points is not None and sc.photometric
    centers = -np.einsum("fji,fj->fi", sc.T_w2c[:, :3, :3], sc.T_w2c[:, :3, 3])
    gap = np.hypot(sc.tex_points[:, None, 0] - centers[None, :, 0],
                   sc.tex_points[:, None, 2] - centers[None, :, 2]).min(1)
    assert gap.min() > 1.9
    l, r = synthetic.render_frame_np(sc, 3)
    assert l.shape == (64, 128) and 0.0 <= l.min() and l.max() <= 1.0
    again = synthetic.make_scene(**kw)
    np.testing.assert_array_equal(again.tex_intens, sc.tex_intens)
    np.testing.assert_array_equal(again.landmarks, sc.landmarks)


def test_observe_frame_equals_jax():
    """Exact stereo measurements, visibility and camera-frame points of a
    JAX-made scene: equal to 1e-3 px / 1e-5 m relative; with noise, the
    visible set is unchanged."""
    scene = jsynth.make_scene(jax.random.PRNGKey(2), num_frames=10,
                              num_landmarks=800, trajectory="straight",
                              hw=(96, 160))
    host = jsynth.host_scene(scene)
    for f in (0, 9):
        meas, vis, pc = synthetic.observe_frame(host, f)
        mj, vj, pj = jsynth.observe_frame(scene, f)
        np.testing.assert_array_equal(vis, np.asarray(vj))
        np.testing.assert_allclose(meas[vis], np.asarray(mj)[vis], atol=1e-3)
        np.testing.assert_allclose(pc, np.asarray(pj), rtol=1e-5, atol=1e-5)
    noisy, vis2, _ = synthetic.observe_frame(host, 0, noise_px=0.5,
                                             rng=np.random.default_rng(0))
    assert (vis2 == synthetic.observe_frame(host, 0)[1]).all()
    assert 0.3 < np.std(noisy - synthetic.observe_frame(host, 0)[0]) < 0.7


def test_render_to_npy_on_a_pool_equals_serial():
    """Frames rendered by 2 worker processes into .npy files equal the
    serial render (uint8 by truncation), on the fractal clover."""
    sc = synthetic.make_scene(seed=0, num_frames=20, num_landmarks=1500,
                              trajectory="clover", hw=(48, 160),
                              clover_radii=(4.0, 5.0), corridor_halfwidth=3.0,
                              texture="fractal", num_texture_points=8000)
    L, R = synthetic.render_sequence(sc)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic.render_to_npy(sc, tmp / "l.npy", tmp / "r.npy",
                                processes=2)
        np.testing.assert_array_equal(np.load(tmp / "l.npy"),
                                      synthetic.to_u8(L))
        np.testing.assert_array_equal(np.load(tmp / "r.npy"),
                                      synthetic.to_u8(R))
