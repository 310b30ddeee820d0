"""The mesh-sharded frontend and bundle adjustment of the port against the
JAX package's on its 8-device CPU mesh, and the overflow bookkeeping of
``build_windows`` that feeds the TP re-solve.

One scene rendered by the JAX package (16 frames of 128x256) feeds both.
With 8 shards and ``chunk_frames=2`` the sharded frontend is one 16-frame
step in both packages. The packages draw different RANSAC hypotheses
(jax.random vs a torch.Generator), so poses differ at the inlier-set
margin (tests/test_torch_slice.py's bounds).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu.models import bundle as jbundle
from slam_tpu.models.trackstore import TrackStore as JTrackStore
from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import sharded_ba as jsharded_ba
from slam_tpu.parallel import sharded_frontend as jsharded_fe
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import convert
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.models import bundle, frontend
from slam_tpu_torch.models.trackstore import TrackStore
from slam_tpu_torch.parallel import sharded_ba, sharded_frontend
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.utils import metrics

torch.set_num_threads(2)

CFG = SlamConfig(
    features=FeatureConfig(max_kp=384, border=8),
    ransac=RansacConfig(num_hypotheses=128),
    runtime=RuntimeConfig(chunk_frames=2),
    keyframes=KeyframeConfig(min_gap=2, max_gap=5, max_dist_m=5.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=192, max_obs=768,
                        lm_iters=8),
)
# window capacities that the scene's windows overflow
TIGHT = dataclasses.replace(CFG.bundle, max_landmarks=48, max_obs=160)
ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev", "match_dist",
          "inlier_prev", "T_rel", "T_w2c", "num_inliers", "inlier_frac",
          "pose_ok")


def jax_config(cfg):
    return jconfig.SlamConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def scene():
    s = jsynth.make_scene(jax.random.PRNGKey(13), num_frames=16,
                          num_landmarks=2000, hw=(128, 256), step_m=0.8)
    L, R = jsynth.render_sequence(s)
    return (np.asarray(L), np.asarray(R), np.asarray(s.calib),
            np.asarray(s.T_w2c))


@pytest.fixture(scope="module")
def fronts(scene):
    """The JAX package's and the port's 8-shard frontends."""
    L, R, calib, _ = scene
    fe_j = jsharded_fe.run_frontend_sharded(L, R, calib, jmesh.make_mesh(),
                                            jax_config(CFG))
    fe_t = sharded_frontend.run_frontend_sharded(
        L, R, calib, make_mesh(8, device="cpu"), CFG)
    return fe_j, fe_t


@pytest.fixture(scope="module")
def windows(scene, fronts):
    """The JAX package's windows on its own track store: at CFG's
    capacities, cut to an odd count, and at TIGHT's (overflowing)."""
    _, _, calib, _ = scene
    fe_j = fronts[0]
    db_j = JTrackStore.from_frontend(fe_j, use_native=False)
    kfs = jbundle.select_keyframes(db_j, fe_j.T_w2c, jax_config(CFG).keyframes)
    out = {}
    for name, bc in (("cfg", CFG.bundle), ("tight", TIGHT)):
        jb = jbundle.build_windows(db_j, np.asarray(fe_j.T_w2c), kfs,
                                   jconfig.BundleConfig(
                                       **dataclasses.asdict(bc)))
        jbundle.init_landmarks(jb, calib)
        out[name] = jb
    return db_j, kfs, out


def test_one_shard_frontend_equals_run_frontend(scene):
    """A 1-shard mesh's frontend equals run_frontend's bit for bit, every
    per-frame array and the descriptors (the same chunks, the same RANSAC
    streams)."""
    L, R, calib, _ = scene
    a = sharded_frontend.run_frontend_sharded(L, R, calib,
                                              make_mesh(device="cpu"), CFG)
    b = frontend.run_frontend(L, R, calib, CFG, device="cpu")
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert torch.equal(a.desc[:], b.desc[:])


def test_training_step_is_one_step(scene, fronts):
    """frontend_training_step on 8 shards is one 16-frame chunk: its
    outputs are the first step of run_frontend_sharded's, bit for bit."""
    L, R, calib, _ = scene
    mesh = make_mesh(8, device="cpu")
    step = sharded_frontend.frontend_training_step(mesh, CFG, calib)
    cfg16 = sharded_frontend.step_config(CFG, mesh)
    out, carry = step(torch.from_numpy(L), torch.from_numpy(R),
                      frontend.chunk_generator(cfg16, 0, "cpu"))
    fe_t = fronts[1]
    for k in ("xy", "links", "match_prev"):
        np.testing.assert_array_equal(out[k].numpy(), getattr(fe_t, k),
                                      err_msg=k)
    # frame 0's T_rel is set to the identity when the result is assembled
    np.testing.assert_array_equal(out["T_rel"].numpy()[1:], fe_t.T_rel[1:])
    assert set(carry) == {"desc", "valid", "links", "link_valid", "xy",
                          "last_T"}


def test_eight_shards_agree_with_jax(fronts):
    """8 shards against the JAX package's 8 devices: keypoints within 1e-4
    px on >= 98% of the slots (the packages' top-K selections tie
    differently on ~1%), stereo validity and temporal matches equal on >=
    95% (test_torch_slice.py's bound for links and matches), frame-to-frame
    poses within 1 cm / 0.05 deg for >= 75% of the 16 frames (3 sit at the
    inlier margin) and within 20 cm / 1 deg for all, camera centres within
    0.2 m (test_torch_slice.py's bounds for every frame)."""
    fe_j, fe_t = fronts
    same_xy = (np.abs(fe_t.xy - np.asarray(fe_j.xy)) <= 1e-4).all(-1)
    same_link = fe_t.link_valid == np.asarray(fe_j.link_valid)
    same_match = fe_t.match_prev == np.asarray(fe_j.match_prev)
    print(f"8 shards vs JAX: keypoints {same_xy.mean():.4f}, stereo validity "
          f"{same_link.mean():.4f}, temporal matches {same_match.mean():.4f} "
          f"of the slots equal")
    assert same_xy.mean() >= 0.98
    assert same_link.mean() >= 0.95 and same_match.mean() >= 0.95
    rj, rt = np.asarray(fe_j.T_rel), fe_t.T_rel
    dt = np.abs(rt[:, :3, 3] - rj[:, :3, 3]).max(-1)
    dr = np.degrees(np.sqrt(((rt[:, :3, :3] - rj[:, :3, :3]) ** 2
                             ).sum((-1, -2)) / 2.0))
    assert ((dt < 0.01) & (dr < 0.05)).mean() >= 0.75
    assert dt.max() < 0.2 and dr.max() < 1.0
    d = np.linalg.norm(metrics.camera_centers(fe_t.T_w2c)
                       - metrics.camera_centers(np.asarray(fe_j.T_w2c)), -1)
    assert d.max() < 0.2


def test_overflow_specs_equal_jax(scene, fronts, windows):
    """build_windows on the same track store under overflowing capacities:
    every array, the drop counters and the overflow specs (bi, tracks,
    trs, frs, slots of each window's full problem) equal the JAX package's;
    convert.bundle_batch carries the JAX batch over unchanged."""
    _, _, calib, _ = scene
    db_j, kfs, jb = windows
    jt = jb["tight"]
    db_t = convert.track_store(db_j)
    fe_j = fronts[0]
    with pytest.warns(UserWarning, match="dropped"):
        ours = bundle.build_windows(db_t, np.asarray(fe_j.T_w2c), kfs, TIGHT)
    bundle.init_landmarks(ours, calib)
    conv = convert.bundle_batch(jt)
    assert len(ours.overflow) >= 2 and len(ours.overflow) == len(jt.overflow)
    for b in (ours, conv):
        for k in ("poses0", "points0", "cam_idx", "lm_idx", "meas", "w",
                  "n_poses", "frames", "track_of_lm"):
            np.testing.assert_array_equal(getattr(b, k), getattr(jt, k),
                                          err_msg=k)
        assert (b.keyframes, b.obs_dropped, b.obs_total) == (
            jt.keyframes, jt.obs_dropped, jt.obs_total)
        for s, r in zip(b.overflow, jt.overflow):
            assert s.keys() == r.keys() and s["bi"] == r["bi"]
            for k in ("tracks", "trs", "frs", "slots"):
                np.testing.assert_array_equal(s[k], r[k], err_msg=k)


def test_sharded_ba_matches_jax(scene, windows):
    """Every window in one batch over 8 shards (an odd window count, so
    padded) against the JAX package's optimize_windows_sharded on 8
    devices, same batch: tests/test_parallel.py's tolerances (rel_T 5e-4,
    costs 1e-3, rel_cov 5% + 1e-7); the window axis comes back unpadded."""
    _, _, calib, _ = scene
    jb = windows[2]["cfg"]
    n = jb.num_windows - (1 - jb.num_windows % 2)
    jb = dataclasses.replace(
        jb, **{k: getattr(jb, k)[:n] for k in (
            "poses0", "points0", "cam_idx", "lm_idx", "meas", "w", "n_poses",
            "frames", "track_of_lm")}, keyframes=jb.keyframes[:n + 1])
    assert n % 2 == 1
    ref = jsharded_ba.optimize_windows_sharded(jb, calib, jmesh.make_mesh(),
                                               iters=CFG.bundle.lm_iters)
    mesh = make_mesh(8, device="cpu")
    ours = sharded_ba.optimize_windows_sharded(convert.bundle_batch(jb),
                                               calib, mesh,
                                               iters=CFG.bundle.lm_iters)
    assert ours[0].shape[0] == n
    poses, points, w2, cost, cost0, rel_T, rel_cov = ours
    r = [np.asarray(x) for x in ref]
    np.testing.assert_allclose(rel_T, r[5], atol=5e-4)
    np.testing.assert_allclose(cost, r[3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cost0, r[4], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rel_cov, r[6], rtol=0.05, atol=1e-7)
    # optimize_windows routes a mesh here
    res = bundle.optimize_windows(convert.bundle_batch(jb), calib,
                                  CFG.bundle, mesh=mesh)
    np.testing.assert_array_equal(res.rel_T, rel_T)
    with pytest.raises(ValueError, match="not the mesh's"):
        bundle.optimize_windows(convert.bundle_batch(jb), calib, CFG.bundle,
                                mesh=mesh, device="cuda:1")


@pytest.mark.parametrize("n_shards, device_batch", [(2, 2), (4, 1)])
def test_mesh_is_one_padded_slice(scene, windows, n_shards, device_batch):
    """Under a mesh optimize_windows runs every window as one slice padded
    to a multiple of the shards, through the step its device_batch slices
    use: against slices of ``device_batch`` (the tail padded), rel_T and
    poses within 1e-4, rel_cov within 2e-3 of its largest entry and costs
    within 1e-5 relative + 1e-4 (CPU matmuls block differently at another
    batch size: between slices of 1 and one of 4 the poses sit 1.9e-5
    apart, rel_cov 6.8e-4 of its largest entry); ba_training_step on the
    mesh's padded inputs, read back, equals the mesh route bit for bit."""
    _, _, calib, _ = scene
    batch = convert.bundle_batch(windows[2]["cfg"])
    B = batch.num_windows
    assert B > device_batch and B % n_shards
    mesh = make_mesh(n_shards, device="cpu")
    a = bundle.optimize_windows(batch, calib, CFG.bundle, mesh=mesh)
    b = bundle.optimize_windows(batch, calib, CFG.bundle,
                                device_batch=device_batch, device="cpu")
    print("mesh slice vs device_batch slices:", {
        k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
        for k in ("rel_T", "poses", "cost", "cost0", "rel_cov")})
    np.testing.assert_allclose(a.rel_T, b.rel_T, atol=1e-4)
    np.testing.assert_allclose(a.poses, b.poses, atol=1e-4)
    np.testing.assert_allclose(a.rel_cov, b.rel_cov,
                               atol=2e-3 * np.abs(b.rel_cov).max())
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(a.cost0, b.cost0)
    step = sharded_ba.ba_training_step(mesh, calib, iters=CFG.bundle.lm_iters)
    inputs = bundle.window_inputs(batch, 0, B, B + (-B) % n_shards)
    assert inputs[0].shape[0] % n_shards == 0
    assert not inputs[5][B:].any()  # padded windows carry no weight
    out = [t[:B].numpy() for t in step(*inputs)]
    for name, x in zip(("poses", "points", "w", "cost", "cost0", "rel_T",
                        "rel_cov"), out):
        np.testing.assert_array_equal(x, getattr(a, name), err_msg=name)


def test_run_bundles_reoptimizes_overflow(scene, fronts):
    """run_bundles with a mesh re-solves every overflowed window at full
    observation count on the TP path: such windows carry more than max_obs
    active observations, their rel_cov is positive definite, and the
    bundles' keyframe ATE is at most the truncated solve's x 1.1 + 0.02 m
    and under 0.3 m (tests/test_tp_overflow.py's bounds)."""
    _, _, calib, T_gt = scene
    fe_t = fronts[1]
    db = TrackStore.from_frontend(fe_t)
    cfg = dataclasses.replace(CFG, bundle=TIGHT)
    with pytest.warns(UserWarning, match="dropped"):
        tp_res = bundle.run_bundles(db, fe_t.T_w2c, calib, cfg,
                                    mesh=make_mesh(8, device="cpu"))
        cut = bundle.run_bundles(db, fe_t.T_w2c, calib, cfg, device="cpu")
    routed = np.nonzero(tp_res.num_obs > TIGHT.max_obs)[0]
    assert len(routed) >= 2
    for bi in routed:
        assert np.linalg.eigvalsh(tp_res.rel_cov[bi].astype(np.float64)
                                  ).min() > 0
    kfs = tp_res.keyframes
    ate_tp = metrics.ate_rmse(tp_res.T_w2c_keyframes, T_gt[kfs])
    ate_cut = metrics.ate_rmse(cut.T_w2c_keyframes, T_gt[kfs])
    assert ate_tp <= ate_cut * 1.1 + 0.02 and ate_tp < 0.3, (ate_tp, ate_cut)
