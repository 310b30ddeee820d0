"""The port's main path as a whole: run_pipeline of both packages on one
rendered loop scene, and the port's guards.

The JAX package renders the scene and both packages get the same numpy
images. The packages draw different RANSAC hypotheses (jax.random vs a
torch.Generator), so frame poses differ at the inlier-set margin; those
differences chain along the trajectory. The bounds below state that.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slam_tpu import pipeline as jpipe
from slam_tpu.config import (BundleConfig, FeatureConfig, KeyframeConfig,
                             LoopConfig, RansacConfig, RuntimeConfig,
                             SlamConfig)
from slam_tpu.utils import metrics
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import pipeline
from slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = SlamConfig(
    features=FeatureConfig(max_kp=512, border=8),
    ransac=RansacConfig(num_hypotheses=192),
    runtime=RuntimeConfig(chunk_frames=8),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=6.0,
                             max_angle_deg=25.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=256, max_obs=1024,
                        lm_iters=10),
    loop=LoopConfig(mahalanobis_thresh=300.0, min_inliers=40,
                    keyframe_gap=5, max_candidates=8),
)


@pytest.fixture(scope="module")
def runs():
    scene = jsynth.make_scene(jax.random.PRNGKey(3), num_frames=80,
                              num_landmarks=6000, trajectory="loop",
                              hw=(160, 320))
    L, R = jsynth.render_sequence(scene)
    calib = np.asarray(scene.calib)
    res_j = jpipe.run_pipeline(L, R, calib, CFG, verbose=False)
    res_t = pipeline.run_pipeline(L, R, calib, CFG, verbose=False,
                                  device="cpu")
    return np.asarray(scene.T_w2c), res_j, res_t


def rot_deg(A, B):
    d = np.asarray(A[..., :3, :3], np.float64) - B[..., :3, :3]
    return np.degrees(np.sqrt((d * d).sum((-1, -2)) / 2.0))


def test_slice_closes_the_same_loops(runs):
    """Closure frame pairs equal; inlier counts within 10%."""
    _, res_j, res_t = runs
    assert len(res_j.closures) >= 1
    assert [(c.frame_i, c.frame_j) for c in res_t.closures] == [
        (c.frame_i, c.frame_j) for c in res_j.closures]
    for ct, cj in zip(res_t.closures, res_j.closures):
        assert abs(ct.num_inliers - cj.num_inliers) <= 0.1 * cj.num_inliers


def test_slice_trajectories_agree(runs):
    """Frame-to-frame poses equal within 1 cm / 0.05 deg for >= 90% of the
    frames and within 20 cm / 1 deg for all: where a frame has few
    inliers (~45 here), the other hypothesis draws can pick another
    minimal set, and a 0.6 deg tilt at such a frame offsets every later
    frontend pose by up to ~0.4 m. The same keyframes; the loop-closed
    keyframe graphs within 5 cm / 0.1 deg; each stage's ATE within 5 cm
    of the JAX package's and under 0.5 m."""
    T_gt, res_j, res_t = runs
    rj, rt = res_j.frontend.T_rel, res_t.frontend.T_rel
    dt = np.abs(rt[:, :3, 3] - rj[:, :3, 3]).max(-1)
    dr = rot_deg(rt, rj)
    close = (dt < 0.01) & (dr < 0.05)
    assert close.mean() >= 0.9, (dt, dr)
    assert dt.max() < 0.2 and dr.max() < 1.0
    assert res_t.pose_graph.keyframes == res_j.pose_graph.keyframes
    nj, nt = res_j.pose_graph.nodes, res_t.pose_graph.nodes
    d = np.linalg.norm(metrics.camera_centers(nt)
                       - metrics.camera_centers(nj), axis=-1)
    assert d.max() < 0.05 and rot_deg(nt, nj).max() < 0.1
    ev_j = jpipe.evaluate(res_j, T_gt)
    ev_t = pipeline.evaluate(res_t, T_gt)
    for k in ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf"):
        assert abs(ev_t[k]["ate_rmse_m"] - ev_j[k]["ate_rmse_m"]) < 0.05, k
        assert ev_t[k]["ate_rmse_m"] < 0.5, k
    assert ev_t["num_pose_failures"] == ev_j["num_pose_failures"]


def test_slice_report_round_trips(runs, tmp_path):
    """save_report writes the evaluation as JSON with the JAX package's
    keys."""
    import json

    T_gt, res_j, res_t = runs
    ev_t = pipeline.evaluate(res_t, T_gt)
    pipeline.save_report(tmp_path / "report.json", ev_t)
    back = json.loads((tmp_path / "report.json").read_text())
    assert set(back) == set(jpipe.evaluate(res_j, T_gt))
    assert back["num_closures"] == len(res_t.closures)
    assert back["frontend"]["ate_rmse_m"] == ev_t["frontend"]["ate_rmse_m"]


def test_slice_frontend_bookkeeping_agrees(runs):
    """Keypoints, stereo links and temporal matches of the first frames,
    before pose differences can feed back: >= 95% of the JAX package's
    stereo links and RANSAC-inlier matches are found by the port too."""
    _, res_j, res_t = runs
    fj, ft = res_j.frontend, res_t.frontend
    for f in range(1, 8):
        lj = {tuple(np.round(x, 3)) for x in fj.links[f][fj.link_valid[f]]}
        lt = {tuple(np.round(x, 3)) for x in ft.links[f][ft.link_valid[f]]}
        assert len(lj & lt) >= 0.95 * len(lj)
        pj = {(int(fj.match_prev[f, j]), j) for j in
              np.nonzero(fj.inlier_prev[f])[0]}
        pt = {(int(ft.match_prev[f, j]), j) for j in
              np.nonzero(ft.inlier_prev[f])[0]}
        if len(pj) >= 50:
            assert len(pj & pt) >= 0.9 * len(pj)


def test_port_scene_generator():
    """The port's numpy scene follows the JAX package's trajectory model
    (its landmarks come from another generator, as documented)."""
    scene = synthetic.make_scene(seed=1, num_frames=20, num_landmarks=500,
                                 trajectory="loop", hw=(96, 160))
    ref = np.asarray(jsynth.loop_trajectory(20, radius=25.0))
    np.testing.assert_allclose(scene.T_w2c, ref, atol=1e-4)
    np.testing.assert_allclose(
        synthetic.straight_trajectory(30),
        np.asarray(jsynth.straight_trajectory(30)), atol=1e-4)
    L, R = synthetic.render_sequence(scene)
    assert L.shape == R.shape == (20, 96, 160)
    assert L.dtype == np.float32 and 0.0 <= L.min() and L.max() <= 1.0


@pytest.mark.parametrize("kwargs", [
    {"cache_dir": "x"}, {"mesh": object()}, {"overlap": True},
    {"image_hw": (96, 160)}])
def test_unported_options_raise(kwargs):
    imgs = np.zeros((2, 96, 160), np.float32)
    with pytest.raises(NotImplementedError):
        pipeline.run_pipeline(imgs, imgs, synthetic.KITTI_CALIB, CFG,
                              verbose=False, device="cpu", **kwargs)


def test_unported_detectors_raise():
    import dataclasses

    imgs = np.zeros((2, 96, 160), np.float32)
    cfg = dataclasses.replace(
        CFG, features=dataclasses.replace(CFG.features, detector="orb"))
    with pytest.raises(NotImplementedError):
        pipeline.run_pipeline(imgs, imgs, synthetic.KITTI_CALIB, cfg,
                              verbose=False, device="cpu")


@pytest.mark.parametrize("entry", ["run_pipeline", "run_frontend"])
def test_default_device_is_the_card(entry, monkeypatch):
    """Called without a device, the stage entry points run on the card;
    with no card they raise instead of quietly taking the plain versions
    on the CPU."""
    from slam_tpu_torch.models import frontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"run_pipeline": pipeline.run_pipeline,
          "run_frontend": frontend.run_frontend}[entry]
    imgs = np.zeros((2, 96, 160), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(imgs, imgs, synthetic.KITTI_CALIB, CFG)


_NO_JAX_SCRIPT = """
import sys
import numpy as np
from slam_tpu.config import BundleConfig, FeatureConfig, KeyframeConfig, \\
    LoopConfig, RuntimeConfig, SlamConfig
from slam_tpu_torch import pipeline
from slam_tpu_torch.utils import synthetic

scene = synthetic.make_scene(seed=0, num_frames=24, num_landmarks=2500,
                             trajectory="loop", hw=(96, 160))
L, R = synthetic.render_sequence(scene)
cfg = SlamConfig(features=FeatureConfig(max_kp=256),
                 runtime=RuntimeConfig(chunk_frames=8),
                 keyframes=KeyframeConfig(min_gap=2, max_gap=6),
                 bundle=BundleConfig(max_poses=8, max_landmarks=128,
                                     max_obs=512, lm_iters=3),
                 loop=LoopConfig(keyframe_gap=3))
res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                            device="cpu")
pipeline.evaluate(res, scene.T_w2c)
assert np.isfinite(res.T_frontend).all()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib")
             or m.startswith(("slam_tpu.ops", "slam_tpu.pipeline"))))
"""


def test_port_never_imports_jax():
    """The port's whole slice, on a tiny scene, in a fresh interpreter:
    afterwards no module of JAX (nor the JAX package's ops or pipeline,
    which import it) is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
