"""The AKAZE + Hamming configuration as a whole: run_pipeline of both
packages on one rendered loop scene.

The JAX package renders the scene (80 frames, 240x640) and both packages
get the same numpy images, under ``test_torch_slice.CFG`` with
``detector="akaze"``, ``norm="hamming"`` and K=1024. Detection and
matching are deterministic, so the frontend's stereo links and temporal
matches agree slot by slot. The RANSAC hypotheses are not (jax.random
vs a torch.Generator), and on this scene every frame pair has only ~50
inliers at ~0.5 inlier fraction: another draw keeps another inlier set
at the 2 px margin. Measured on this scene, the port against the JAX
package: frame-to-frame poses differ by a median 5.5 cm / 0.10 deg
(1 cm / 0.05 deg on 11% of the frames); the port against itself with
RANSAC seeds 1 and 2: a median 3.6 cm / 0.086 deg, on the same 11%.
Those differences chain into the frontend and bundle trajectories
(frontend ATE 0.49-1.20 m and bundles 0.28-1.56 m over three seeds of
the port; JAX 0.68 / 0.86 m), while loop closure pins them down
(0.149-0.162 m for the port, 0.169 m for JAX). The bounds below are
set from those measurements.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu import pipeline as jpipe
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import pipeline
from slam_tpu_torch.config import MatchConfig

from tests.test_torch_slice import CFG, jax_config, rot_deg

torch.set_num_threads(2)

AKAZE_CFG = dataclasses.replace(
    CFG, features=dataclasses.replace(CFG.features, max_kp=1024,
                                      detector="akaze"),
    matching=MatchConfig(norm="hamming"))


@pytest.fixture(scope="module")
def runs():
    scene = jsynth.make_scene(jax.random.PRNGKey(3), num_frames=80,
                              num_landmarks=6000, trajectory="loop",
                              hw=(240, 640))
    L, R = jsynth.render_sequence(scene)
    calib = np.asarray(scene.calib)
    res_j = jpipe.run_pipeline(L, R, calib, jax_config(AKAZE_CFG),
                               verbose=False)
    res_t = pipeline.run_pipeline(L, R, calib, AKAZE_CFG, verbose=False,
                                  device="cpu")
    return np.asarray(scene.T_w2c), res_j, res_t


def test_akaze_slice_frontend_matches_agree(runs):
    """Before RANSAC the two frontends agree on every frame: keypoints
    within 1e-3 px, stereo links and temporal matches equal on >= 99.9%
    of the slots, and the matches' Hamming distances in whole bits, equal
    where both matched."""
    _, res_j, res_t = runs
    fj, ft = res_j.frontend, res_t.frontend
    both = fj.valid & ft.valid
    assert (fj.valid == ft.valid).mean() >= 0.999
    np.testing.assert_allclose(ft.xy[both], fj.xy[both], atol=1e-3)
    assert (fj.link_valid == ft.link_valid).mean() >= 0.999
    linked = fj.link_valid & ft.link_valid
    np.testing.assert_allclose(ft.links[linked], fj.links[linked], atol=1e-3)
    assert (fj.match_prev == ft.match_prev).mean() >= 0.999
    same = (fj.match_prev == ft.match_prev) & (ft.match_prev >= 0)
    assert same.sum() > 100 * 79
    np.testing.assert_array_equal(ft.match_dist[same], fj.match_dist[same])
    d = ft.match_dist[ft.match_prev >= 0]
    assert (d == np.round(d)).all() and d.max() <= 40


def test_akaze_slice_closes_the_loop(runs):
    """Every closure of the JAX package is found by the port, with its
    inlier count within 10%. A closure the port finds beyond those is a
    weak one at the gate's margin (< 1.5x loop.min_inliers): the port
    finds (0, 78) with 49-50 inliers under three RANSAC seeds."""
    _, res_j, res_t = runs
    cj = {(c.frame_i, c.frame_j): c.num_inliers for c in res_j.closures}
    ct = {(c.frame_i, c.frame_j): c.num_inliers for c in res_t.closures}
    assert (0, 79) in cj
    for pair, n in cj.items():
        assert pair in ct and abs(ct[pair] - n) <= 0.1 * n
    for pair in ct.keys() - cj.keys():
        assert ct[pair] < 1.5 * AKAZE_CFG.loop.min_inliers


def test_akaze_slice_trajectories_agree(runs):
    """Frame-to-frame poses within a median 10 cm / 0.2 deg of the JAX
    package's; the loop-closed keyframe trajectory's ATE within 5 cm of
    the JAX package's and under 0.5 m; every other stage's ATE under 2 m;
    pose-failure counts within 1 (module docstring: RANSAC draws)."""
    T_gt, res_j, res_t = runs
    rj, rt = res_j.frontend.T_rel[1:], res_t.frontend.T_rel[1:]
    dt = np.abs(rt[:, :3, 3] - rj[:, :3, 3]).max(-1)
    assert np.median(dt) < 0.1 and np.median(rot_deg(rt, rj)) < 0.2
    ev_j = jpipe.evaluate(res_j, T_gt)
    ev_t = pipeline.evaluate(res_t, T_gt)
    lc_t = ev_t["pose_graph_lc_kf"]["ate_rmse_m"]
    assert abs(lc_t - ev_j["pose_graph_lc_kf"]["ate_rmse_m"]) < 0.05
    assert lc_t < 0.5
    for k in ("frontend", "bundles_kf", "pose_graph_kf"):
        assert ev_t[k]["ate_rmse_m"] < 2.0, k
    assert abs(ev_t["num_pose_failures"] - ev_j["num_pose_failures"]) <= 1
