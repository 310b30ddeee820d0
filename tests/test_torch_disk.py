"""The disk slice as a whole: a loop scene written in KITTI's layout, run
by both packages' ``run_pipeline`` from the PNG path lists with a stage
cache, then the port's stage cache, bucket padding, the pipelined bundle
slices and the pose graph's covariance queries.

Both packages read the same PNG files. Their RANSAC streams differ
(jax.random vs torch.Generator), so the frontends are compared by the
bookkeeping bounds of tests/test_torch_slice.py."""

import os

import numpy as np
import pytest
import torch

from slam_tpu import pipeline as jpipe
from slam_tpu.models.pose_graph import PoseGraph as JPoseGraph
from slam_tpu_torch import pipeline, runtime
from slam_tpu_torch.models import bundle
from slam_tpu_torch.models import frontend as frontend_mod
from slam_tpu_torch.parallel import pipeline as ppipe
from slam_tpu_torch.utils import kitti, synthetic

from tests.test_torch_slice import CFG, jax_config

torch.set_num_threads(2)


def u8(x):
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def png_lists(paths):
    return (sorted(str(p) for p in paths.left_dir.glob("*.png")),
            sorted(str(p) for p in paths.right_dir.glob("*.png")))


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    root = tmp_path_factory.mktemp("disk")
    scene = synthetic.make_scene(seed=3, num_frames=24, num_landmarks=2500,
                                 trajectory="loop", hw=(128, 256),
                                 loop_radius=6.0)
    L, R = synthetic.render_sequence(scene)
    paths = kitti.write_kitti_sequence(root / "kitti", "00", u8(L), u8(R),
                                       scene.calib, scene.T_w2c)
    lp, rp = png_lists(paths)
    calib = kitti.calib_vector(paths)
    res_j = jpipe.run_pipeline(lp, rp, calib, jax_config(CFG),
                               cache_dir=root / "jax", verbose=False)
    res_t = pipeline.run_pipeline(lp, rp, calib, CFG, cache_dir=root / "port",
                                  verbose=False, device="cpu")
    return {"root": root, "lp": lp, "rp": rp, "calib": calib,
            "T_gt": kitti.read_ground_truth(paths), "jax": res_j,
            "port": res_t}


def test_disk_frontend_bookkeeping_agrees_with_jax(disk):
    """Keypoints, stereo links and RANSAC-inlier matches of the first
    frames: >= 95% of the JAX package's links and >= 90% of its inlier
    matches found by the port too; the same loops closed; every stage's
    ATE under 0.5 m in both. (At 15 degrees of turn per frame a few
    frames have few inliers, where the two RANSAC streams pick other
    poses, so the trajectories are not compared closer.)"""
    fj, ft = disk["jax"].frontend, disk["port"].frontend
    for f in range(1, 8):
        lj = {tuple(np.round(x, 3)) for x in fj.links[f][fj.link_valid[f]]}
        lt = {tuple(np.round(x, 3)) for x in ft.links[f][ft.link_valid[f]]}
        assert len(lj & lt) >= 0.95 * len(lj)
        pj = {(int(fj.match_prev[f, j]), j)
              for j in np.nonzero(fj.inlier_prev[f])[0]}
        pt = {(int(ft.match_prev[f, j]), j)
              for j in np.nonzero(ft.inlier_prev[f])[0]}
        if len(pj) >= 50:
            assert len(pj & pt) >= 0.9 * len(pj)
    assert disk["port"].closures
    assert [(c.frame_i, c.frame_j) for c in disk["port"].closures] == [
        (c.frame_i, c.frame_j) for c in disk["jax"].closures]
    ev_j = jpipe.evaluate(disk["jax"], disk["T_gt"])
    ev_t = pipeline.evaluate(disk["port"], disk["T_gt"])
    for k in ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf"):
        assert ev_t[k]["ate_rmse_m"] < 0.5 and ev_j[k]["ate_rmse_m"] < 0.5, k


def test_disk_cache_holds_the_jax_packages_artifacts(disk):
    """The same artifact files in both cache directories, each npz with
    the same keys, and the same config and input fingerprint (the same
    PNG files)."""
    dj, dt = disk["root"] / "jax", disk["root"] / "port"
    names = sorted(p.name for p in dt.iterdir())
    assert names == sorted(p.name for p in dj.iterdir())
    assert {"trackstore.npz", "bundles.npz", "pose_graph.npz",
            "pose_graph_lc.npz", "closures.npz", "frontend_ckpt.npz",
            "frontend_ckpt.seg0000.npz"} <= set(names)
    for name in names:
        if name.endswith(".npz"):
            with np.load(dj / name) as a, np.load(dt / name) as b:
                assert sorted(a.files) == sorted(b.files), name
        else:
            assert (dj / name).read_text() == (dt / name).read_text(), name


def test_second_call_loads_every_stage(disk, monkeypatch):
    """Rerun on a full cache: nothing is computed (every stage function
    is replaced by one that fails), and the results are equal."""
    def no(*a, **k):
        raise AssertionError("a stage ran on a full cache")

    monkeypatch.setattr(frontend_mod, "process_chunk", no)
    monkeypatch.setattr(bundle, "run_bundles", no)
    monkeypatch.setattr(pipeline.lc_mod, "find_loops", no)
    again = pipeline.run_pipeline(disk["lp"], disk["rp"], disk["calib"], CFG,
                                  cache_dir=disk["root"] / "port",
                                  verbose=False, device="cpu")
    first = disk["port"]
    for get in (lambda r: r.T_frontend, lambda r: r.db.track_ids,
                lambda r: r.bundles.poses, lambda r: r.pose_graph_pre_lc.nodes,
                lambda r: r.keyframe_trajectory()):
        np.testing.assert_array_equal(get(again), get(first))
    assert [(c.frame_i, c.frame_j) for c in again.closures] == [
        (c.frame_i, c.frame_j) for c in first.closures]


def _recomputed_stages(disk, cache, cfg, monkeypatch):
    """The stages a run recomputes (counted by wrapping them)."""
    ran = []
    for mod, name in ((frontend_mod, "process_chunk"),
                      (bundle, "run_bundles"),
                      (pipeline.lc_mod, "find_loops")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            ran.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    pipeline.run_pipeline(disk["lp"], disk["rp"], disk["calib"], cfg,
                          cache_dir=cache, run_loop_closure=True,
                          verbose=False, device="cpu")
    return set(ran)


def test_touched_image_or_changed_config_invalidates_the_cache(
        disk, tmp_path, monkeypatch):
    import shutil

    cache = tmp_path / "cache"
    shutil.copytree(disk["root"] / "port", cache)
    assert _recomputed_stages(disk, cache, CFG, monkeypatch) == set()
    st = os.stat(disk["lp"][-1])
    os.utime(disk["lp"][-1], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        assert _recomputed_stages(disk, cache, CFG, monkeypatch) == {
            "process_chunk", "run_bundles", "find_loops"}
    finally:
        os.utime(disk["lp"][-1], ns=(st.st_atime_ns, st.st_mtime_ns))
    import dataclasses

    cfg2 = dataclasses.replace(CFG, loop=dataclasses.replace(
        CFG.loop, min_inliers=41))
    assert _recomputed_stages(disk, cache, cfg2, monkeypatch) == {
        "process_chunk", "run_bundles", "find_loops"}


def test_pngs_equal_the_same_frames_in_memory(disk):
    """run_pipeline from the PNG paths equals run_pipeline on the same
    frames decoded to float32 in memory (runtime.load_png_gray: u8 *
    (1/255f), what the device computes from the uint8 frames the path
    mode uploads), bit for bit."""
    assert runtime.available()
    L = np.stack([runtime.load_png_gray(p) for p in disk["lp"]])
    R = np.stack([runtime.load_png_gray(p) for p in disk["rp"]])
    mem = pipeline.run_pipeline(L, R, disk["calib"], CFG, verbose=False,
                                device="cpu")
    disk_run = disk["port"]
    for k in ("xy", "links", "match_prev", "inlier_prev", "T_w2c"):
        np.testing.assert_array_equal(getattr(mem.frontend, k),
                                      getattr(disk_run.frontend, k), k)
    assert np.array_equal(mem.frontend.desc.numpy(),
                          disk_run.frontend.desc.numpy())
    np.testing.assert_array_equal(mem.pose_graph.nodes,
                                  disk_run.pose_graph.nodes)
    assert [(c.frame_i, c.frame_j, c.num_inliers) for c in mem.closures] == [
        (c.frame_i, c.frame_j, c.num_inliers) for c in disk_run.closures]


def test_frontend_without_the_native_runtime(disk, monkeypatch):
    """Where the runtime cannot be built, the frames are decoded on the
    calling thread (cv2 / PIL), to the same uint8 frames: the same
    frontend."""
    monkeypatch.setattr(runtime, "available", lambda: False)
    frames = ppipe.PngFrames(disk["lp"][:10], disk["rp"][:10], (128, 256))
    assert not frames.native and frames.decoder.startswith("eager")
    eager = frontend_mod.run_frames(frames, disk["calib"], CFG, "cpu")
    for k in ("xy", "links", "match_prev", "T_w2c"):
        np.testing.assert_array_equal(
            getattr(eager, k), getattr(disk["port"].frontend, k)[:10], k)


def test_multi_sequence_two_resolutions(tmp_path):
    """Two sequences at 120x240 and 128x256 run through one bucket
    (128, 256), the smaller edge-replicate-padded, in memory, and a
    path-mode run pads to ``image_hw`` the same way."""
    seqs = {}
    for name, hw in (("a", (120, 240)), ("b", (128, 256))):
        sc = synthetic.make_scene(seed=len(name) + hw[0], num_frames=10,
                                  num_landmarks=1500, trajectory="straight",
                                  hw=hw)
        L, R = synthetic.render_sequence(sc)
        seqs[name] = (u8(L), u8(R), sc.calib, sc.T_w2c)
    assert kitti.bucket_for([v[0].shape[1:] for v in seqs.values()]) == (
        128, 256)
    reports = ppipe.run_multi_sequence(seqs, CFG, run_loop_closure=False,
                                       cache_root=tmp_path / "multi",
                                       device="cpu")
    assert sorted(reports) == ["a", "b"]
    for rep in reports.values():
        assert rep["frontend"]["ate_rmse_m"] < 0.5
    assert (tmp_path / "multi" / "a" / "bundles.npz").exists()
    L, R, calib, _ = seqs["a"]
    paths = kitti.write_kitti_sequence(tmp_path / "kitti", "04", L, R, calib)
    lp, rp = png_lists(paths)
    fe = ppipe.run_frontend_pipelined(lp, rp, (128, 256), calib, CFG,
                                      device="cpu")
    ref = frontend_mod.run_frontend(kitti.pad_to_bucket(L, (128, 256)),
                                    kitti.pad_to_bucket(R, (128, 256)),
                                    calib, CFG, device="cpu")
    np.testing.assert_array_equal(fe.T_w2c, ref.T_w2c)
    np.testing.assert_array_equal(fe.xy, ref.xy)


def test_optimize_windows_in_pipelined_slices(disk):
    """C2: the windows in slices of 4 (pipelined, the tail padded) equal
    one slice of 16, window by window, within 1e-5 (CPU matmuls block
    differently at another batch size)."""
    res = disk["port"]
    kfs = bundle.select_keyframes(res.db, res.frontend.T_w2c, CFG.keyframes)
    batch = bundle.build_windows(res.db, res.frontend.T_w2c, kfs, CFG.bundle)
    bundle.init_landmarks(batch, disk["calib"])
    assert batch.num_windows > 8 and batch.num_windows % 4 == 0
    a = bundle.optimize_windows(batch, disk["calib"], CFG.bundle,
                                device_batch=4, device="cpu")
    b = bundle.optimize_windows(batch, disk["calib"], CFG.bundle,
                                device_batch=16, device="cpu")
    for k in ("poses", "points", "w", "cost0", "rel_T", "T_w2c_keyframes"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.rel_cov, b.rel_cov, atol=1e-5 * np.abs(
        b.rel_cov).max())


def test_pose_graph_covariance_queries_equal_jax(disk):
    """C4: marginal, relative_covariance and keyframe_trajectory. From
    the same covariance matrix both packages give equal blocks; each from
    its own covariance, within 2% of the largest entry (float32 dense
    inverses)."""
    g = disk["port"].pose_graph
    gj = JPoseGraph(nodes=g.nodes.copy(), keyframes=list(g.keyframes),
                    e_i=g.e_i.copy(), e_j=g.e_j.copy(), Z=g.Z.copy(),
                    sqrt_info=g.sqrt_info.copy(), is_loop=g.is_loop.copy())
    assert g.is_loop.any()
    C = g.covariance_full()
    N = g.num_nodes
    scale = np.abs(gj.covariance_full()).max()
    for i, j in ((0, N - 1), (1, 3), (N - 2, N - 1)):
        np.testing.assert_array_equal(g.marginal(j, C), gj.marginal(j, C))
        np.testing.assert_allclose(g.relative_covariance(i, j, C),
                                   gj.relative_covariance(i, j, C),
                                   rtol=1e-6, atol=1e-6 * scale)
        assert np.abs(g.marginal(j) - gj.marginal(j)).max() <= 2e-2 * scale
        assert np.abs(g.relative_covariance(i, j)
                      - gj.relative_covariance(i, j)).max() <= 2e-2 * scale
    res, res_j = disk["port"], disk["jax"]
    np.testing.assert_array_equal(res.keyframe_trajectory(), g.nodes)
    np.testing.assert_array_equal(
        res.keyframe_trajectory(res.pose_graph_pre_lc),
        res.pose_graph_pre_lc.nodes)
    np.testing.assert_array_equal(res_j.keyframe_trajectory(gj), g.nodes)
