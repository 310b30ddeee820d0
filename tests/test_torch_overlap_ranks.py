"""The stage overlap over the ranks of a torch.distributed process group
(parallel/stage_overlap.py): run_pipeline(mesh=make_mesh(), overlap=True)
on 4 gloo ranks of the CPU, 2 frontend ranks and 2 BA ranks, against the
port's one-process overlap on a 4-shard mesh (which splits 2 + 2 as well)
and against the JAX package's overlap on 4 of its virtual CPU devices.

The scene and configuration are tests/test_torch_stage_overlap.py's: 32
frames of 128x256 rendered by the JAX package, ``chunk_frames=4`` (steps
of 8 frames over the 2 frontend ranks). Ranks are spawned by
``parallel.ranks.spawn`` with a join time limit, one torch thread each;
they import this module to find their function, so it imports neither JAX
nor the JAX package at its top, and each rank checks that neither is
loaded.
"""

import sys
import time

import numpy as np
import pytest
import torch

from slam_tpu_torch import pipeline
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.parallel import ranks
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.parallel.stage_overlap import split_mesh
from slam_tpu_torch.utils import metrics

torch.set_num_threads(2)

JOIN_S = 300.0
RANKS = 4
CFG = SlamConfig(
    features=FeatureConfig(max_kp=512, border=8),
    ransac=RansacConfig(num_hypotheses=192),
    runtime=RuntimeConfig(chunk_frames=4),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=5.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=128, max_obs=512,
                        lm_iters=8),
)
FE_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev",
             "match_dist", "inlier_prev", "num_inliers", "pose_ok", "T_rel")
WINDOWS = ("frames", "n_poses", "track_of_lm", "meas", "cam_idx", "lm_idx")
STAGES = ("frontend", "bundles_kf", "pose_graph_kf")


def _summary(res, T_gt) -> dict:
    """What the tests compare of one run_pipeline result."""
    rep = pipeline.evaluate(res, T_gt)
    fe, b = res.frontend, res.bundles
    return {
        "fe": {k: getattr(fe, k) for k in FE_ARRAYS + ("T_w2c",)},
        "track_ids": res.db.track_ids, "keyframes": b.keyframes,
        "windows": {k: getattr(b, k) for k in WINDOWS},
        "rel_T": b.rel_T, "num_obs": b.num_obs,
        "nodes_pre_lc": res.pose_graph_pre_lc.nodes,
        "closures": [(c.frame_i, c.frame_j) for c in res.closures],
        "ates": {k: rep[k]["ate_rmse_m"] for k in STAGES},
        "timings": sorted(res.timings),
        # the keyframes' descriptors: the other ranks' recomputed
        "kf_desc": fe.desc[np.asarray(b.keyframes)].numpy()}


def _overlap_rank(L, R, calib, T_gt) -> dict:
    """One rank: the split of the default group (twice, and once with one
    frontend rank), then the overlapped pipeline."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "slam_tpu"))
    if loaded or torch.get_num_threads() != 1:
        raise RuntimeError(f"rank: threads {torch.get_num_threads()}, "
                           f"loaded {loaded[:5]}")
    mesh = make_mesh(device="cpu")
    fe, ba = split_mesh(mesh)
    fe2, ba2 = split_mesh(mesh)
    one = split_mesh(mesh, fe_devices=1)
    split = {"fe": (fe.world, fe.rank, fe.ranks),
             "ba": (ba.world, ba.rank, ba.ranks),
             "reused": fe2.group is fe.group and ba2.group is ba.group,
             "one": [(m.world, m.rank) for m in one]}
    res = pipeline.run_pipeline(L, R, calib, CFG, verbose=False, mesh=mesh,
                                overlap=True)
    return {"split": split, **_summary(res, T_gt)}


@pytest.fixture(scope="module")
def scene():
    import jax

    from slam_tpu.utils import synthetic as jsynth

    s = jsynth.make_scene(jax.random.PRNGKey(7), num_frames=32,
                          num_landmarks=2500, hw=(128, 256), step_m=0.8)
    L, R = jsynth.render_sequence(s)
    return (np.asarray(L), np.asarray(R), np.asarray(s.calib),
            np.asarray(s.T_w2c))


_RUNS, _IN_PROCESS = {}, {}


@pytest.fixture(scope="module")
def runs(scene):
    """n -> every rank's result of the overlap on n ranks, spawned once."""
    def get(n):
        if n not in _RUNS:
            t0 = time.perf_counter()
            _RUNS[n] = ranks.spawn(_overlap_rank, n, "gloo", "cpu",
                                   args=scene, timeout=JOIN_S, threads=1)
            print(f"{n}-rank overlap: {time.perf_counter() - t0:.1f} s")
        return _RUNS[n]
    return get


@pytest.fixture(scope="module")
def in_process(scene):
    """n -> the one-process overlap on an n-shard mesh (which splits as
    n ranks do)."""
    L, R, calib, T_gt = scene

    def get(n):
        if n not in _IN_PROCESS:
            res = pipeline.run_pipeline(L, R, calib, CFG, verbose=False,
                                        mesh=make_mesh(n, device="cpu"),
                                        overlap=True)
            _IN_PROCESS[n] = _summary(res, T_gt)
        return _IN_PROCESS[n]
    return get


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_split_over_ranks(runs):
    """4 ranks split 2 + 2 by default (ranks 0-1 the frontend group, 2-3
    the BA group; each rank a member of one, rank -1 in the other), the
    process groups made once and reused, and fe_devices=1 splits 1 + 3."""
    for r, out in enumerate(runs(RANKS)):
        s = out["split"]
        fe_rank, ba_rank = (r, -1) if r < 2 else (-1, r - 2)
        assert s["fe"] == (2, fe_rank, (0, 1)), r
        assert s["ba"] == (2, ba_rank, (2, 3)), r
        assert s["reused"], r
        assert s["one"] == ([(1, 0), (3, -1)] if r == 0
                            else [(1, -1), (3, r - 1)]), r


@pytest.mark.parametrize("n", [2, RANKS])
def test_every_rank_holds_the_same_result(n, runs):
    """On n ranks (1 + 1 and 2 + 2) every rank returns rank 0's result bit
    for bit: the frontend (the BA ranks received it), windows, rel_T, the
    pose graph, closures, ATEs and the keyframes' descriptors (recomputed
    on every rank but the one that made them)."""
    run = runs(n)
    first = {k: v for k, v in run[0].items() if k != "split"}
    for out in run[1:]:
        _assert_same(first, {k: v for k, v in out.items() if k != "split"},
                     "rank")


@pytest.mark.parametrize("n", [2, RANKS])
def test_overlap_ranks_match_in_process(n, runs, in_process):
    """On n ranks against the one-process n-shard overlap (1 + 1: steps of
    4 frames on one frontend rank, as one process runs them; 2 + 2: steps
    of 8 frames, 4 per frontend rank, and each BA rank solving half of
    every batch): keypoints, matches,
    inliers, relative poses, track ids, keyframes, windows and closures
    equal, the keyframes' descriptors equal bit for bit, rel_T within
    1e-4 and every stage's ATE within 0.01 m (the rank mesh's tolerances
    against one process); the stage timed as one."""
    r, ref = runs(n)[0], in_process(n)
    for k in FE_ARRAYS:
        np.testing.assert_array_equal(r["fe"][k], ref["fe"][k], err_msg=k)
    np.testing.assert_array_equal(r["track_ids"], ref["track_ids"])
    assert r["keyframes"] == ref["keyframes"] and len(r["keyframes"]) >= 5
    for k in WINDOWS:
        np.testing.assert_array_equal(r["windows"][k], ref["windows"][k],
                                      err_msg=k)
    np.testing.assert_array_equal(r["kf_desc"], ref["kf_desc"])
    assert r["closures"] == ref["closures"]
    d_rel = float(np.abs(r["rel_T"] - ref["rel_T"]).max())
    d_ate = {k: abs(v - ref["ates"][k]) for k, v in r["ates"].items()}
    print(f"overlap on {n} ranks vs one process: rel_T {d_rel:.3e}, "
          f"ATE differences {d_ate}")
    assert d_rel <= 1e-4 and max(d_ate.values()) <= 0.01
    assert "frontend+bundles_overlapped" in r["timings"]
    assert "frontend" not in r["timings"] and "bundles" not in r["timings"]


def test_overlap_ranks_agree_with_jax(scene, runs):
    """Against the JAX package's run_pipeline(mesh=make_mesh(4),
    overlap=True) on its CPU devices (no loop closure): the same
    keyframes, the keyframe graph before loop closure within 5 cm
    (tests/test_torch_stage_overlap.py's bounds), the BA and pose-graph
    ATEs within 5 cm of the JAX package's and every ATE under 0.5 m. The
    frontend's ATE is not held to the JAX package's: each package's
    RANSAC draws from its own random stream, and on this scene the two
    dead-reckoned chains part by ~8 cm over 32 frames (BA takes it out)."""
    from slam_tpu import config as jconfig
    from slam_tpu import pipeline as jpipe
    from slam_tpu.parallel import mesh as jmesh

    L, R, calib, T_gt = scene
    res_j = jpipe.run_pipeline(
        L, R, calib, jconfig.SlamConfig.from_json(CFG.to_json()),
        mesh=jmesh.make_mesh(RANKS), overlap=True, run_loop_closure=False,
        verbose=False)
    r = runs(RANKS)[0]
    assert r["keyframes"] == res_j.pose_graph.keyframes
    d = np.linalg.norm(metrics.camera_centers(r["nodes_pre_lc"])
                       - metrics.camera_centers(res_j.pose_graph.nodes), -1)
    ev_j = jpipe.evaluate(res_j, T_gt)
    print(f"overlap on {RANKS} ranks vs JAX on {RANKS} devices: keyframe "
          f"graph {d.max():.3e} m, ATE port {r['ates']}, JAX "
          f"{ {k: ev_j[k]['ate_rmse_m'] for k in STAGES} }")
    assert d.max() < 0.05
    for k in STAGES:
        assert r["ates"][k] < 0.5 and ev_j[k]["ate_rmse_m"] < 0.5, k
        if k != "frontend":
            assert abs(r["ates"][k] - ev_j[k]["ate_rmse_m"]) < 0.05, k
