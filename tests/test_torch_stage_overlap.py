"""The overlap mode (parallel/stage_overlap.py): frontend and BA of the
port overlapped against the same stages run one after the other, and
run_pipeline(mesh=..., overlap=True) of both packages on one scene.

The scene is rendered by the JAX package: 32 frames of 128x256. An
8-shard mesh splits into a 4-shard frontend group (16-frame steps with
``chunk_frames=4``) and a 4-shard BA group, in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu import pipeline as jpipe
from slam_tpu.parallel import mesh as jmesh
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import pipeline
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.models import bundle
from slam_tpu_torch.models.trackstore import TrackStore
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.parallel.sharded_frontend import run_frontend_sharded
from slam_tpu_torch.parallel.stage_overlap import (run_pipeline_overlapped,
                                                   split_mesh)
from slam_tpu_torch.utils import metrics

torch.set_num_threads(2)

CFG = SlamConfig(
    features=FeatureConfig(max_kp=512, border=8),
    ransac=RansacConfig(num_hypotheses=192),
    runtime=RuntimeConfig(chunk_frames=4),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=5.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=128, max_obs=512,
                        lm_iters=8),
)
RESULT = ("poses", "points", "w", "cost", "cost0", "rel_T", "rel_cov",
          "T_w2c_keyframes")


@pytest.fixture(scope="module")
def scene():
    s = jsynth.make_scene(jax.random.PRNGKey(7), num_frames=32,
                          num_landmarks=2500, hw=(128, 256), step_m=0.8)
    L, R = jsynth.render_sequence(s)
    return (np.asarray(L), np.asarray(R), np.asarray(s.calib),
            np.asarray(s.T_w2c))


@pytest.fixture(scope="module")
def overlapped(scene):
    L, R, calib, _ = scene
    return run_pipeline_overlapped(L, R, calib, CFG,
                                   mesh=make_mesh(8, device="cpu"))


def test_overlapped_matches_sequential(scene, overlapped):
    """Against the sequential stages on the same groups: the frontend equal
    bit for bit to the frontend group's sharded frontend, the incremental
    track chaining equal to TrackStore.from_frontend, the same keyframes
    and windows (the prefix-edge cut deferred), and rel_T within 5e-4 of
    optimize_windows on the BA group (tests/test_stage_overlap.py's
    tolerance), keyframe positions within 5e-3 m."""
    L, R, calib, _ = scene
    fe, db, res = overlapped
    fe_mesh, ba_mesh = split_mesh(make_mesh(8, device="cpu"))
    fe_ref = run_frontend_sharded(L, R, calib, fe_mesh, CFG)
    for k in ("xy", "links", "match_prev", "inlier_prev", "T_rel", "T_w2c"):
        np.testing.assert_array_equal(getattr(fe, k), getattr(fe_ref, k),
                                      err_msg=k)
    db_ref = TrackStore.from_frontend(fe_ref)
    assert db.num_tracks == db_ref.num_tracks
    np.testing.assert_array_equal(db.track_ids, db_ref.track_ids)
    kfs = bundle.select_keyframes(db_ref, fe_ref.T_w2c, CFG.keyframes)
    assert res.keyframes == kfs and len(kfs) >= 5
    batch = bundle.build_windows(db_ref, fe_ref.T_w2c, kfs, CFG.bundle)
    bundle.init_landmarks(batch, calib)
    for k in ("frames", "n_poses", "track_of_lm", "meas", "cam_idx",
              "lm_idx"):
        np.testing.assert_array_equal(getattr(res, k), getattr(batch, k),
                                      err_msg=k)
    ref = bundle.optimize_windows(batch, calib, CFG.bundle, mesh=ba_mesh)
    np.testing.assert_allclose(res.rel_T, ref.rel_T, atol=5e-4)
    np.testing.assert_allclose(res.T_w2c_keyframes[:, :3, 3],
                               ref.T_w2c_keyframes[:, :3, 3], atol=5e-3)


def test_run_pipeline_overlap_agrees_with_jax(scene):
    """run_pipeline(mesh=..., overlap=True) of both packages (no loop
    closure): one timing bucket for the overlapped stages, the same
    keyframes, keyframe graphs within 5 cm, and each stage's ATE within
    5 cm of the JAX package's and under 0.5 m (test_torch_slice.py's
    bounds)."""
    L, R, calib, T_gt = scene
    res_j = jpipe.run_pipeline(
        L, R, calib, jconfig.SlamConfig.from_json(CFG.to_json()),
        mesh=jmesh.make_mesh(), overlap=True, run_loop_closure=False,
        verbose=False)
    res_t = pipeline.run_pipeline(L, R, calib, CFG,
                                  mesh=make_mesh(8, device="cpu"),
                                  overlap=True, run_loop_closure=False,
                                  verbose=False)
    assert "frontend+bundles_overlapped" in res_t.timings
    assert "frontend" not in res_t.timings
    assert res_t.pose_graph.keyframes == res_j.pose_graph.keyframes
    d = np.linalg.norm(metrics.camera_centers(res_t.pose_graph.nodes)
                       - metrics.camera_centers(res_j.pose_graph.nodes), -1)
    assert d.max() < 0.05
    ev_j = jpipe.evaluate(res_j, T_gt)
    ev_t = pipeline.evaluate(res_t, T_gt)
    for k in ("frontend", "bundles_kf", "pose_graph_kf"):
        assert abs(ev_t[k]["ate_rmse_m"] - ev_j[k]["ate_rmse_m"]) < 0.05, k
        assert ev_t[k]["ate_rmse_m"] < 0.5, k
