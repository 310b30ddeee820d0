"""Bundle adjustment, pose graph and loop closure of the port, fed state
converted from one JAX-package run on a rendered loop scene.

Both packages run the same host numpy for keyframes and windows, so the
windows are compared exactly. The device stages are compared within
float32 tolerances: LM, Cholesky and dense inverses round in another
order in torch, and loop-closure RANSAC draws other hypotheses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu import pipeline as jpipe
from slam_tpu.config import (BundleConfig, FeatureConfig, KeyframeConfig,
                             LoopConfig, RansacConfig, RuntimeConfig,
                             SlamConfig)
from slam_tpu.models import bundle as jbundle
from slam_tpu.models import loop_closure as jlc
from slam_tpu.models.pose_graph import PoseGraph as JPoseGraph
from slam_tpu.models.trackstore import TrackStore
from slam_tpu.ops import ba as jba
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import convert
from slam_tpu_torch.models import bundle, loop_closure
from slam_tpu_torch.models.pose_graph import PoseGraph
from slam_tpu_torch.ops import ba

torch.set_num_threads(2)

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
def jax_run():
    scene = jsynth.make_scene(jax.random.PRNGKey(3), num_frames=80,
                              num_landmarks=6000, trajectory="loop",
                              hw=(160, 320))
    L, R = jsynth.render_sequence(scene)
    calib = np.asarray(scene.calib)
    res = jpipe.run_pipeline(L, R, calib, CFG, verbose=False)
    assert res.closures, "the reference run must close the loop"
    return calib, res


def rot_deg(A, B):
    """Rotation difference in degrees as |R_A - R_B|_F / sqrt(2), which
    equals the angle for small angles and, unlike arccos of the trace,
    resolves them in float32 (arccos near 1 floors at ~0.02 deg)."""
    d = np.asarray(A[..., :3, :3], np.float64) - B[..., :3, :3]
    return np.degrees(np.sqrt((d * d).sum((-1, -2)) / 2.0))


def test_windows_identical_to_jax(jax_run):
    calib, res = jax_run
    db, T = res.db, res.frontend.T_w2c
    kfs = bundle.select_keyframes(db, T, CFG.keyframes)
    assert kfs == jbundle.select_keyframes(db, T, CFG.keyframes)
    bt = bundle.build_windows(db, T, kfs, CFG.bundle)
    bj = jbundle.build_windows(db, T, kfs, CFG.bundle)
    bundle.init_landmarks(bt, calib)
    jbundle.init_landmarks(bj, calib)
    for f in dataclasses.fields(bt):
        a, b = getattr(bt, f.name), getattr(bj, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bundles_match_jax(jax_run):
    """Same windows in: window poses within 1 mm / 0.01 deg, final costs
    within 1% (+1e-3), relative covariances within 2% of their norm."""
    calib, res = jax_run
    bt = bundle.run_bundles(res.db, res.frontend.T_w2c, calib, CFG,
                            device="cpu")
    bj = res.bundles
    assert bt.keyframes == bj.keyframes
    np.testing.assert_array_equal(bt.w > 0, bj.w > 0)
    np.testing.assert_allclose(bt.poses[..., :3, 3], bj.poses[..., :3, 3],
                               atol=1e-3)
    assert rot_deg(bt.poses, bj.poses).max() < 1e-2
    np.testing.assert_allclose(bt.cost, bj.cost, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(bt.cost0, bj.cost0, rtol=1e-5)
    for ct, cj in zip(bt.rel_cov, bj.rel_cov):
        assert np.abs(ct - cj).max() <= 2e-2 * np.abs(cj).max()
    np.testing.assert_allclose(bt.T_w2c_keyframes[:, :3, 3],
                               bj.T_w2c_keyframes[:, :3, 3], atol=5e-3)


def test_pose_covariances_match_jax(jax_run):
    """One window's marginal covariances from the same optimized state:
    within 1% of their norm (float32 inverse of the Schur complement)."""
    _, res = jax_run
    b = res.bundles
    i = 3
    args = (b.poses[i], b.points[i], b.cam_idx[i], b.lm_idx[i], b.meas[i],
            b.w[i], res.calib)
    cj = np.asarray(jba.pose_covariances(*(jax.numpy.asarray(a)
                                           for a in args)))
    ct = ba.pose_covariances(*(torch.as_tensor(np.array(a)[None])
                               for a in args[:-1]),
                             torch.as_tensor(np.array(res.calib)))[0].numpy()
    assert np.abs(ct - cj).max() <= 1e-2 * np.abs(cj).max()
    assert np.all(ct[0] == 0.0)


def test_failed_cholesky_gives_rejected_step():
    """A non-positive-definite reduced system yields a NaN step, which LM
    rejects; nothing raises."""
    S = -torch.eye(12)[None]
    x = ba._spd_solve(S, torch.ones((1, 12)))
    assert torch.isnan(x).all()
    P, L, M = 2, 3, 6
    poses = torch.eye(4).repeat(1, P, 1, 1)
    points = torch.tensor([[[0.0, 0.0, 5.0], [1.0, 0.0, 6.0],
                            [0.0, 1.0, 7.0]]])
    cam = torch.tensor([[0, 0, 0, 1, 1, 1]])
    lm = torch.tensor([[0, 1, 2, 0, 1, 2]])
    meas = torch.full((1, M, 3), float("nan"))
    w = torch.ones((1, M))
    calib = torch.tensor([700.0, 700.0, 300.0, 150.0, 0.5])
    p2, x2, cost, lam = ba.optimize_bundle(poses, points, cam, lm, meas, w,
                                           calib, iters=3)
    assert torch.equal(p2, poses) and torch.equal(x2, points)
    assert float(lam[0]) == pytest.approx(1e-4 * 4 ** 3)


def test_pose_graph_chain_and_npz_format(jax_run, tmp_path):
    """The odometry chain equals the JAX package's (host float64), and
    the port reads the JAX package's pose-graph and bundles npz files."""
    _, res = jax_run
    pg = PoseGraph.from_bundles(convert.bundle_result(res.bundles))
    pg.optimize()
    np.testing.assert_allclose(pg.nodes, res.pose_graph_pre_lc.nodes,
                               atol=1e-6)
    res.pose_graph.save(tmp_path / "pg.npz")
    loaded = PoseGraph.load(tmp_path / "pg.npz")
    for k in ("nodes", "e_i", "e_j", "Z", "sqrt_info", "is_loop"):
        np.testing.assert_array_equal(getattr(loaded, k),
                                      getattr(res.pose_graph, k))
    jbundle.save_bundles(res.bundles, tmp_path / "b.npz")
    b = bundle.load_bundles(tmp_path / "b.npz")
    for k in ("poses", "rel_T", "rel_cov", "T_w2c_keyframes", "meas"):
        np.testing.assert_array_equal(getattr(b, k), getattr(res.bundles, k))
    assert b.keyframes == res.bundles.keyframes


def _graph_pair(res):
    """(JAX graph, port graph) both holding the pre-closure graph plus the
    reference's first loop edge."""
    c = res.closures[0]
    pre = res.pose_graph_pre_lc
    gj = JPoseGraph(nodes=pre.nodes.copy(), keyframes=list(pre.keyframes),
                    e_i=pre.e_i.copy(), e_j=pre.e_j.copy(), Z=pre.Z.copy(),
                    sqrt_info=pre.sqrt_info.copy(),
                    is_loop=pre.is_loop.copy())
    gt = PoseGraph(nodes=pre.nodes.copy(), keyframes=list(pre.keyframes),
                   e_i=pre.e_i.copy(), e_j=pre.e_j.copy(), Z=pre.Z.copy(),
                   sqrt_info=pre.sqrt_info.copy(), is_loop=pre.is_loop.copy())
    for g in (gj, gt):
        g.add_edge(c.kf_i, c.kf_j, c.rel_T, c.rel_cov, loop=True)
    return gj, gt


def test_pose_graph_lm_with_loop_edge_matches_jax(jax_run):
    """Dense LM with a loop edge: nodes within 5 mm / 0.01 deg (float32
    solves of the preconditioned system round differently)."""
    _, res = jax_run
    gj, gt = _graph_pair(res)
    gj.optimize()
    gt.optimize()
    np.testing.assert_allclose(gt.nodes[:, :3, 3], gj.nodes[:, :3, 3],
                               atol=5e-3)
    assert rot_deg(gt.nodes, gj.nodes).max() < 1e-2


def test_gate_distances_match_jax(jax_run):
    """All-pairs Mahalanobis distances within 2% (float32 dense inverse),
    the same pairs failing closed (inf), the full posterior covariance
    within 2% of its largest entry, and the marginal log-determinants
    within 0.05."""
    _, res = jax_run
    gj, gt = _graph_pair(res)
    N = gt.num_nodes
    ii, jj = np.tril_indices(N, k=-1)
    dj = gj.gate_distances(jj, ii)
    dt = gt.gate_distances(jj, ii)
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    f = np.isfinite(dj)
    np.testing.assert_allclose(dt[f], dj[f], rtol=2e-2, atol=1e-2)
    Cj, Ct = gj.covariance_full(), gt.covariance_full()
    assert np.abs(Ct - Cj).max() <= 2e-2 * np.abs(Cj).max()
    lj, rj = gj.marginal_logdets()
    lt, rt = gt.marginal_logdets()
    np.testing.assert_allclose(lt[1:], lj[1:], atol=5e-2)
    np.testing.assert_allclose(rt[1:], rj[1:], atol=5e-2)


def test_find_loops_matches_jax(jax_run, tmp_path):
    """From the JAX run's pre-closure graph (read from its npz), track
    store and descriptors: the same closure frame pairs, inlier counts
    within 10% (other RANSAC hypotheses), and closure poses within
    2 cm / 0.1 deg."""
    calib, res = jax_run
    res.pose_graph_pre_lc.save(tmp_path / "pre.npz")
    pg = PoseGraph.load(tmp_path / "pre.npz")
    fe = convert.frontend_result(res.frontend)
    closures = loop_closure.find_loops(pg, res.db, fe.desc, fe.valid, calib,
                                       CFG)
    assert [(c.frame_i, c.frame_j) for c in closures] == [
        (c.frame_i, c.frame_j) for c in res.closures]
    for ct, cj in zip(closures, res.closures):
        assert abs(ct.num_inliers - cj.num_inliers) <= 0.1 * cj.num_inliers
        np.testing.assert_allclose(ct.rel_T[:3, 3], cj.rel_T[:3, 3],
                                   atol=2e-2)
        assert rot_deg(ct.rel_T, cj.rel_T) < 0.1
    np.testing.assert_allclose(pg.nodes[:, :3, 3],
                               res.pose_graph.nodes[:, :3, 3], atol=2e-2)
    jlc.save_closures(res.closures, tmp_path / "c.npz")
    back = loop_closure.load_closures(tmp_path / "c.npz")
    assert [(c.kf_i, c.kf_j, c.num_inliers) for c in back] == [
        (c.kf_i, c.kf_j, c.num_inliers) for c in res.closures]


def test_converted_frontend_builds_the_same_track_store(jax_run):
    _, res = jax_run
    fe = convert.frontend_result(res.frontend)
    assert fe.desc.dtype == torch.float16
    assert tuple(fe.desc.shape) == res.frontend.desc.shape
    db = TrackStore.from_frontend(fe)
    np.testing.assert_array_equal(db.track_ids, res.db.track_ids)
