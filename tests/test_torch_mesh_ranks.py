"""The mesh over the ranks of a torch.distributed process group
(parallel/mesh.py, parallel/ranks.py): the TP mega-bundle, the window BA,
the frame-sharded frontend, run_pipeline and the dry run, each on CPU
ranks joined by gloo, against the port's one-process mesh and against the
JAX package on its virtual CPU mesh.

Ranks are spawned (``parallel.ranks.spawn``) with a ``file://``
rendezvous in a temporary directory of their own, one torch thread each,
and a join time limit after which every rank is killed and the test
fails. The ranks import this module to find their functions, so it
imports neither JAX nor the JAX package at its top (the JAX references
are imported inside the fixtures), and each rank checks that neither is
loaded. One 2-rank run and one 4-rank run hold every case of their size.

The test marked ``cuda`` holds kernels B1, B2 and B6 against their plain
versions on a second card (``cuda:1``); it skips where there are fewer
than two.
"""

import dataclasses
import sys
import time

import numpy as np
import pytest
import torch

from slam_tpu_torch import pipeline
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.models import bundle, frontend
from slam_tpu_torch.models.trackstore import TrackStore
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.parallel import mesh as mesh_mod
from slam_tpu_torch.parallel import ranks
from slam_tpu_torch.parallel import sharded_frontend
from slam_tpu_torch.parallel import tp_megabundle as tp
from slam_tpu_torch.parallel.dryrun import dryrun_multichip
from slam_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(2)

# a spawned rank imports torch in a few seconds; every run of ranks here
# ends well inside this
JOIN_S = 300.0
CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)
NO_GATE = dict(prune_rounds=1, min_depth=-1e9, max_depth=1e9,
               huber_delta=0.0)
# tests/test_torch_sharded.py's configuration, its chunk doubled: on 2
# ranks a step is 8 frames, so the 16-frame scene takes 2 chained steps
CFG = SlamConfig(
    features=FeatureConfig(max_kp=384, border=8),
    ransac=RansacConfig(num_hypotheses=128),
    runtime=RuntimeConfig(chunk_frames=4),
    keyframes=KeyframeConfig(min_gap=2, max_gap=5, max_dist_m=5.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=192, max_obs=768,
                        lm_iters=8),
)
# window capacities that the scene's windows overflow (the TP re-solve)
TIGHT = dataclasses.replace(CFG, bundle=dataclasses.replace(
    CFG.bundle, max_landmarks=48, max_obs=160))
FE_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev",
             "match_dist", "inlier_prev", "num_inliers", "pose_ok", "T_rel")
RESULT_FIELDS = ("poses", "points", "w", "cost", "cost0", "rel_T",
                 "rel_cov", "num_obs")


# ---------------------------------------------------------------------------
# what the ranks run (module level, so that a spawned rank can import it)
# ---------------------------------------------------------------------------

def _check_rank() -> None:
    """A rank runs on one torch thread and has loaded neither JAX nor the
    JAX package."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "slam_tpu"))
    if loaded or torch.get_num_threads() != 1:
        raise RuntimeError(f"rank: threads {torch.get_num_threads()}, "
                           f"loaded {loaded[:5]}")


def _tp_case(problem, n: int) -> dict:
    """The TP solve on a mesh of one shard per rank: the pruned solve with
    no gate and its covariances, and the plain optimize_megabundle."""
    _, _, poses0, points0, ci, li, meas, w = problem
    mesh = mesh_mod.make_mesh(axis="tp", device="cpu")
    parts = tp.partition_megabundle(points0, ci, li, meas, w, n)
    poses, X_sh, w_sh, cost = tp.optimize_megabundle_pruned(
        mesh, poses0, *parts, CALIB, iters=20, **NO_GATE)
    cov = tp.megabundle_pose_covariances(mesh, poses, X_sh, parts[1],
                                         parts[2], parts[3], w_sh, CALIB)
    p2, X2, cost2, cost0 = tp.optimize_megabundle(mesh, poses0, *parts,
                                                  CALIB, iters=20)
    return {"poses": poses, "X_sh": X_sh, "w_sh": w_sh, "cost": cost,
            "cov": cov, "plain_poses": p2, "plain_X": X2,
            "plain_cost": cost2, "cost0": cost0}


def _ranks4(problem) -> dict:
    _check_rank()
    return {"tp": _tp_case(problem, 4)}


def _ranks2(problem, batch, L, R, calib, T_gt) -> dict:
    """Every 2-rank case in one run: the TP solve, the window BA on an odd
    window count, the frontend over 2 steps, run_pipeline with the TP
    re-solve, and the raise that needs a process group."""
    _check_rank()
    mesh = mesh_mod.make_mesh(device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world, "size": mesh.size,
           "tp": _tp_case(problem, 2)}
    res = bundle.optimize_windows(batch, calib, CFG.bundle, mesh=mesh)
    out["windows"] = {k: getattr(res, k) for k in RESULT_FIELDS}
    fe = sharded_frontend.run_frontend_sharded(L, R, calib, mesh, CFG)
    out["frontend"] = {k: getattr(fe, k) for k in FE_ARRAYS + ("T_w2c",)}
    out["frontend"]["desc"] = fe.desc.numpy()  # the other rank's recomputed
    ck.reset_counters()
    pr = pipeline.run_pipeline(L, R, calib, TIGHT, verbose=False, mesh=mesh)
    rep = pipeline.evaluate(pr, T_gt)
    out["pipeline"] = {
        "keyframes": pr.bundles.keyframes, "rel_T": pr.bundles.rel_T,
        "num_obs": pr.bundles.num_obs, "nodes": pr.pose_graph.nodes,
        "closures": [(c.frame_i, c.frame_j) for c in pr.closures],
        "ates": {k: rep[k]["ate_rmse_m"] for k in
                 ("frontend", "bundles_kf", "pose_graph_kf")},
        "xy": pr.frontend.xy, "match_prev": pr.frontend.match_prev}
    raised = {}
    try:
        mesh_mod.make_mesh(3, device="cpu")
    except ValueError as e:
        raised["n_devices"] = f"{type(e).__name__}: {e}"
    out["raised"] = raised
    return out


def _fail_on_rank_1() -> int:
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits for the rank that failed
    return 0


def _hang() -> None:
    time.sleep(3600)


# ---------------------------------------------------------------------------
# inputs and the ranks' runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """tests/test_torch_tp_megabundle.py's problem: P = 8, L = 520."""
    return synthetic.megaproblem(CALIB, 8, 520, 5, 1)


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_sharded.py's scene, rendered by the JAX package: 16
    frames of 128x256."""
    import jax

    from slam_tpu.utils import synthetic as jsynth

    s = jsynth.make_scene(jax.random.PRNGKey(13), num_frames=16,
                          num_landmarks=2000, hw=(128, 256), step_m=0.8)
    L, R = jsynth.render_sequence(s)
    return (np.asarray(L), np.asarray(R), np.asarray(s.calib),
            np.asarray(s.T_w2c))


@pytest.fixture(scope="module")
def batch(scene):
    """The scene's windows from the port's frontend, cut to an odd
    count."""
    L, R, calib, _ = scene
    fe = frontend.run_frontend(L, R, calib, CFG, device="cpu")
    db = TrackStore.from_frontend(fe)
    kfs = bundle.select_keyframes(db, fe.T_w2c, CFG.keyframes)
    b = bundle.build_windows(db, fe.T_w2c, kfs, CFG.bundle)
    bundle.init_landmarks(b, calib)
    n = b.num_windows - (1 - b.num_windows % 2)
    b = dataclasses.replace(
        b, **{k: getattr(b, k)[:n] for k in bundle.WINDOW_INPUTS + (
            "n_poses", "frames", "track_of_lm")},
        keyframes=b.keyframes[:n + 1])
    assert n % 2 == 1 and n >= 3
    return b


@pytest.fixture(scope="module")
def run2(problem, batch, scene):
    """Both ranks' results of the 2-rank run, and its wall seconds."""
    t0 = time.perf_counter()
    out = ranks.spawn(_ranks2, 2, "gloo", "cpu",
                      args=(problem, batch) + scene, timeout=JOIN_S,
                      threads=1)
    print(f"2-rank run: {time.perf_counter() - t0:.1f} s")
    return out


@pytest.fixture(scope="module")
def run4(problem):
    t0 = time.perf_counter()
    out = ranks.spawn(_ranks4, 4, "gloo", "cpu", args=(problem,),
                      timeout=JOIN_S, threads=1)
    print(f"4-rank run: {time.perf_counter() - t0:.1f} s")
    return out


@pytest.fixture(scope="module")
def in_process_tp(problem):
    """The port's TP solve on a one-process 4-shard mesh."""
    _, _, poses0, points0, ci, li, meas, w = problem
    mesh = mesh_mod.make_mesh(4, axis="tp", device="cpu")
    parts = tp.partition_megabundle(points0, ci, li, meas, w, 4)
    poses, X_sh, w_sh, cost = tp.optimize_megabundle_pruned(
        mesh, poses0, *parts, CALIB, iters=20, **NO_GATE)
    cov = tp.megabundle_pose_covariances(mesh, poses, X_sh, parts[1],
                                         parts[2], parts[3], w_sh, CALIB)
    return poses, cost, cov


@pytest.fixture(scope="module")
def jax_tp(problem):
    """The JAX package's optimize_megabundle on its 4-device CPU mesh."""
    import jax.numpy as jnp

    from slam_tpu.parallel import mesh as jmesh
    from slam_tpu.parallel import tp_megabundle as jtp

    _, _, poses0, points0, ci, li, meas, w = problem
    parts = jtp.partition_megabundle(points0, ci, li, meas, w, 4)
    poses, _, cost, cost0 = jtp.optimize_megabundle(
        jmesh.make_mesh(4, axis="tp"), poses0, *parts, jnp.asarray(CALIB),
        iters=20, engine="onehot")
    return np.asarray(poses), float(cost), float(cost0)


def rank_results(run, key):
    """Every rank's result under ``key``, held equal bit for bit across the
    ranks (they solve replicated systems in lockstep); rank 0's."""
    first = run[0][key]
    for other in run[1:]:
        _assert_same(first, other[key], key)
    return first


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def rel_frob(a, b) -> float:
    """Largest relative Frobenius distance per pose, the gauge pose left
    out."""
    return float((np.linalg.norm(a - b, axis=(1, 2))[1:]
                  / np.linalg.norm(b, axis=(1, 2))[1:]).max())


# ---------------------------------------------------------------------------
# the TP mega-bundle
# ---------------------------------------------------------------------------

def test_mesh_over_ranks(run2):
    """make_mesh() in a 2-rank group: one shard per rank, size 2, each rank
    its own index."""
    assert [(r["rank"], r["world"], r["size"]) for r in run2] == [
        (0, 2, 2), (1, 2, 2)]


@pytest.mark.parametrize("n", [2, 4])
def test_tp_ranks_match_in_process_mesh(n, run2, run4, in_process_tp):
    """The TP solve on n ranks (one all_sum per LM iteration) against the
    one-process 4-shard mesh: poses within 1e-6 (twist norm) and cost
    within 1e-9 relative (both sum in float64; only the order of the
    sums differs), covariances within 1e-6 relative per pose; every rank
    holds the same result."""
    r = rank_results(run2 if n == 2 else run4, "tp")
    poses, cost, cov = in_process_tp
    d_pose = synthetic.twist_err(r["poses"], poses)
    d_cost = abs(r["cost"] - cost) / cost
    d_cov = rel_frob(r["cov"], cov)
    print(f"TP on {n} ranks vs the one-process 4-shard mesh: poses "
          f"{d_pose:.3e}, cost {d_cost:.3e} relative, covariances "
          f"{d_cov:.3e}")
    assert d_pose <= 1e-6 and d_cost <= 1e-9 and d_cov <= 1e-6
    assert r["X_sh"].shape[0] == n and r["w_sh"].shape[0] == n
    assert np.all(r["cov"][0] == 0.0)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_ranks_match_jax(n, problem, run2, run4, jax_tp):
    """The plain optimize_megabundle on n ranks against the JAX package's on
    its 4-device mesh, 20 iterations: poses within 1e-3 (twist norm),
    cost within 1e-2 relative and the initial cost within 1e-4
    (tests/test_torch_tp_megabundle.py's tolerances); the JAX package's
    megabundle_pose_covariances at the ranks' solution, on 4 devices,
    within 1e-3 relative per pose of the ranks' (it sums in float32)."""
    import jax.numpy as jnp

    from slam_tpu.parallel import mesh as jmesh
    from slam_tpu.parallel import tp_megabundle as jtp

    r = rank_results(run2 if n == 2 else run4, "tp")
    j_poses, j_cost, j_cost0 = jax_tp
    d_pose = synthetic.twist_err(r["plain_poses"], j_poses)
    d_cost = abs(r["plain_cost"] - j_cost) / j_cost
    _, _, _, points0, ci, li, meas, w = problem
    X = r["X_sh"].reshape(-1, 3)[:points0.shape[0]]
    j_cov = np.asarray(jtp.megabundle_pose_covariances(
        jmesh.make_mesh(4, axis="tp"), r["poses"],
        *jtp.partition_megabundle(X, ci, li, meas, w, 4),
        jnp.asarray(CALIB)))
    d_cov = rel_frob(r["cov"], j_cov)
    print(f"TP on {n} ranks vs JAX on 4 devices: poses {d_pose:.3e}, cost "
          f"{d_cost:.3e} relative, covariances {d_cov:.3e}")
    assert d_pose < 1e-3 and d_cost < 1e-2
    assert abs(r["cost0"] - j_cost0) < 1e-4 * j_cost0
    assert d_cov < 1e-3


# ---------------------------------------------------------------------------
# the window BA, the frontend and run_pipeline on 2 ranks
# ---------------------------------------------------------------------------

def test_windows_ranks_match_in_process_mesh(batch, scene, run2):
    """optimize_windows(mesh) on 2 ranks, an odd window count (rank 1's
    share padded): every rank holds the whole result, within
    tests/test_torch_sharded.py's bounds of the one-process 2-shard mesh
    for another batch size (rel_T and poses 1e-4, rel_cov 2e-3 of its
    largest entry, cost 1e-5 relative + 1e-4, cost0 and num_obs equal)."""
    r = rank_results(run2, "windows")
    calib = scene[2]
    ref = bundle.optimize_windows(batch, calib, CFG.bundle,
                                  mesh=mesh_mod.make_mesh(2, device="cpu"))
    diffs = {k: float(np.abs(r[k] - getattr(ref, k)).max())
             for k in ("rel_T", "poses", "cost", "rel_cov")}
    print("windows on 2 ranks vs the one-process mesh:", diffs)
    assert r["poses"].shape[0] == batch.num_windows
    np.testing.assert_allclose(r["rel_T"], ref.rel_T, atol=1e-4)
    np.testing.assert_allclose(r["poses"], ref.poses, atol=1e-4)
    np.testing.assert_allclose(r["rel_cov"], ref.rel_cov,
                               atol=2e-3 * np.abs(ref.rel_cov).max())
    np.testing.assert_allclose(r["cost"], ref.cost, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(r["cost0"], ref.cost0)
    np.testing.assert_array_equal(r["num_obs"], ref.num_obs)


def test_windows_ranks_match_jax(batch, scene, run2):
    """The same windows against the JAX package's optimize_windows_sharded
    on its 8-device mesh: tests/test_torch_sharded.py's tolerances (rel_T
    5e-4, costs 1e-3, rel_cov 5% + 1e-7)."""
    from slam_tpu.models import bundle as jbundle
    from slam_tpu.parallel import mesh as jmesh
    from slam_tpu.parallel import sharded_ba as jsharded_ba

    r = rank_results(run2, "windows")
    jb = jbundle.BundleBatch(
        keyframes=batch.keyframes,
        **{k: getattr(batch, k) for k in bundle.WINDOW_INPUTS + (
            "n_poses", "frames", "track_of_lm")})
    ref = [np.asarray(x) for x in jsharded_ba.optimize_windows_sharded(
        jb, scene[2], jmesh.make_mesh(), iters=CFG.bundle.lm_iters)]
    print("windows on 2 ranks vs JAX:", {
        k: float(np.abs(r[k] - ref[i]).max())
        for i, k in ((5, "rel_T"), (3, "cost"), (6, "rel_cov"))})
    np.testing.assert_allclose(r["rel_T"], ref[5], atol=5e-4)
    np.testing.assert_allclose(r["cost"], ref[3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(r["cost0"], ref[4], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(r["rel_cov"], ref[6], rtol=0.05, atol=1e-7)


@pytest.fixture(scope="module")
def in_process_frontend(scene):
    L, R, calib, _ = scene
    return sharded_frontend.run_frontend_sharded(
        L, R, calib, mesh_mod.make_mesh(2, device="cpu"), CFG)


def test_frontend_ranks_match_in_process_mesh(run2, in_process_frontend):
    """run_frontend_sharded on 2 ranks, 2 steps of 8 frames: keypoints,
    stereo links, temporal matches, inliers, relative poses and every
    descriptor (those of the other rank's frames recomputed) equal the
    one-process 2-shard mesh's bit for bit, camera centres within
    1e-5 m."""
    r = rank_results(run2, "frontend")
    ref = in_process_frontend
    for k in FE_ARRAYS:
        np.testing.assert_array_equal(r[k], getattr(ref, k), err_msg=k)
    np.testing.assert_array_equal(r["desc"], ref.desc.numpy())
    d = float(np.linalg.norm(metrics.camera_centers(r["T_w2c"])
                             - metrics.camera_centers(ref.T_w2c), -1).max())
    print(f"frontend on 2 ranks vs the one-process mesh: camera centres "
          f"{d:.3e} m apart")
    assert d <= 1e-5


def test_frontend_ranks_agree_with_jax(scene, run2):
    """The 2-rank frontend against the JAX package's run_frontend_sharded
    on 2 devices (steps of 8 frames): tests/test_torch_sharded.py's
    bounds (keypoints within 1e-4 px on >= 98% of the slots, stereo
    validity and temporal matches equal on >= 95%, frame-to-frame poses
    within 1 cm / 0.05 deg for >= 75% of the frames and 20 cm / 1 deg for
    all, camera centres within 0.2 m)."""
    from slam_tpu import config as jconfig
    from slam_tpu.parallel import mesh as jmesh
    from slam_tpu.parallel import sharded_frontend as jsharded_fe

    L, R, calib, _ = scene
    r = rank_results(run2, "frontend")
    fe_j = jsharded_fe.run_frontend_sharded(
        L, R, calib, jmesh.make_mesh(2),
        jconfig.SlamConfig.from_json(CFG.to_json()))
    same_xy = (np.abs(r["xy"] - np.asarray(fe_j.xy)) <= 1e-4).all(-1)
    same_link = r["link_valid"] == np.asarray(fe_j.link_valid)
    same_match = r["match_prev"] == np.asarray(fe_j.match_prev)
    print(f"frontend on 2 ranks vs JAX: keypoints {same_xy.mean():.4f}, "
          f"stereo validity {same_link.mean():.4f}, temporal matches "
          f"{same_match.mean():.4f} of the slots equal")
    assert same_xy.mean() >= 0.98
    assert same_link.mean() >= 0.95 and same_match.mean() >= 0.95
    rt, rj = r["T_rel"], np.asarray(fe_j.T_rel)
    dt = np.abs(rt[:, :3, 3] - rj[:, :3, 3]).max(-1)
    dr = np.degrees(np.sqrt(((rt[:, :3, :3] - rj[:, :3, :3]) ** 2
                             ).sum((-1, -2)) / 2.0))
    assert ((dt < 0.01) & (dr < 0.05)).mean() >= 0.75
    assert dt.max() < 0.2 and dr.max() < 1.0
    d = np.linalg.norm(metrics.camera_centers(r["T_w2c"])
                       - metrics.camera_centers(np.asarray(fe_j.T_w2c)), -1)
    assert d.max() < 0.2


def test_pipeline_ranks_match_in_process_mesh(scene, run2):
    """run_pipeline(mesh=make_mesh()) on 2 ranks, under capacities that the
    scene's windows overflow (every such window re-solved on the TP path
    across the ranks), against the one-process 2-shard mesh: the same
    keypoints, matches, keyframes, active observations and closures,
    rel_T within 1e-4 and every stage's ATE within 0.01 m."""
    L, R, calib, T_gt = scene
    r = rank_results(run2, "pipeline")
    with pytest.warns(UserWarning, match="dropped"):
        ref = pipeline.run_pipeline(L, R, calib, TIGHT, verbose=False,
                                    mesh=mesh_mod.make_mesh(2, device="cpu"))
    rep = pipeline.evaluate(ref, T_gt)
    np.testing.assert_array_equal(r["xy"], ref.frontend.xy)
    np.testing.assert_array_equal(r["match_prev"], ref.frontend.match_prev)
    assert r["keyframes"] == ref.bundles.keyframes
    assert r["closures"] == [(c.frame_i, c.frame_j) for c in ref.closures]
    assert (r["num_obs"] > TIGHT.bundle.max_obs).sum() >= 2
    np.testing.assert_array_equal(r["num_obs"], ref.bundles.num_obs)
    d_rel = float(np.abs(r["rel_T"] - ref.bundles.rel_T).max())
    d_ate = {k: abs(v - rep[k]["ate_rmse_m"]) for k, v in r["ates"].items()}
    print(f"run_pipeline on 2 ranks vs the one-process mesh: rel_T {d_rel:.3e}"
          f", ATE differences {d_ate}")
    assert d_rel <= 1e-4 and max(d_ate.values()) <= 0.01


def test_raises_inside_ranks(run2):
    """Inside a 2-rank group make_mesh(3) raises ValueError (one shard per
    rank). The overlap runs there (tests/test_torch_overlap_ranks.py)."""
    for r in run2:
        raised = r["raised"]
        assert raised["n_devices"].startswith("ValueError")
        assert "None or 2" in raised["n_devices"]


# ---------------------------------------------------------------------------
# the dry run, the launcher's raises and failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capfd):
    """The port's dry run on n CPU ranks passes the JAX dry run's
    thresholds; rank 0 prints its line, and no other rank does."""
    line = dryrun_multichip(n, backend="gloo", device="cpu", timeout=JOIN_S)
    assert line.startswith(f"dryrun_multichip ok: {n} devices, ")
    assert capfd.readouterr().out.count(line) == 1


@pytest.mark.parametrize("backend, ranks_, device_type, cards", [
    ("nccl", 2, "cuda", 1), ("nccl", 4, "cuda", 2), ("nccl", 1, "cpu", 0),
    ("mpi", 2, "cuda", 2)])
def test_check_backend_raises(backend, ranks_, device_type, cards):
    """nccl with two ranks on one card, nccl on the CPU and an unknown
    backend raise; there is no other backend to fall back to."""
    with pytest.raises(ValueError):
        ranks.check_backend(backend, ranks_, device_type, cards)
    ranks.check_backend("gloo", ranks_, device_type, cards)


def test_nccl_on_one_device_raises_before_spawning():
    """Asking spawn (or the dry run) for nccl ranks on the CPU, or for more
    nccl ranks than the host has cards, raises before any rank starts."""
    with pytest.raises(ValueError, match="nccl"):
        ranks.spawn(_hang, 2, "nccl", "cpu", timeout=5)
    with pytest.raises(ValueError, match="nccl"):
        dryrun_multichip(2, backend="nccl", device="cpu")


def test_process_local_mesh_over_two_devices_raises():
    """A process-local mesh over two devices still raises, and its message
    names the route over ranks."""
    with pytest.raises(NotImplementedError, match="one rank per device"):
        mesh_mod.Mesh(["cpu", "cuda:1"])


def test_failed_rank_fails_the_run():
    """A rank that raises fails the run with its traceback, and the rank
    waiting for it in a collective is killed."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        ranks.spawn(_fail_on_rank_1, 2, "gloo", "cpu", timeout=JOIN_S,
                    threads=1)
    assert time.perf_counter() - t0 < 60


def test_hung_rank_is_killed():
    """Ranks that outlive the join time limit are killed and the run
    fails."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="still running after 8 s"):
        ranks.spawn(_hang, 2, "gloo", "cpu", timeout=8, threads=1)
    assert time.perf_counter() - t0 < 30


# ---------------------------------------------------------------------------
# on a second card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_on_second_card():
    """B1, B2 and B6 on cuda:1 (a rank's card that is not card 0) against
    their plain versions there, at tests/test_torch_kernels.py's
    tolerances; their outputs lie on cuda:1."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from test_torch_kernels import desc_sets, images, spd_systems

    dev = torch.device("cuda", 1)
    x = torch.as_tensor(images(5, 2, 100, 333), device=dev)
    ck.reset_counters()
    r_k, _, m_k = ck.detect_maps(x)
    r_p, _, m_p = ck.detect_maps_plain(x)
    a, b, va, vb, xa, xb = (torch.as_tensor(v, device=dev)
                            for v in desc_sets(6, 4, 2048, 2048, 128))
    rd, _, cd, _ = ck.mutual_nearest(a, b, va, vb, xa, xb, None)
    rd_p, _, cd_p, _ = ck.mutual_nearest_plain(a, b, va, vb, xa, xb, None)
    S, g = (torch.as_tensor(v, device=dev) for v in spd_systems(9, 64, 144))
    x_k = ck.cholesky_solve(S, g)
    x_p = ck.cholesky_solve_plain(S, g)
    x_64 = torch.linalg.solve(S.double(), g.double())
    torch.cuda.synchronize(dev)
    assert all(t.device == dev for t in (r_k, m_k, rd, x_k))
    assert all(ck.LAUNCHES[k] == 1 for k in ("detect_maps", "mutual_nearest",
                                               "cholesky_solve"))
    assert float((r_k - r_p).abs().max()) <= 1e-5 * float(r_p.abs().max())
    m_bad = ((m_k - m_p).abs() > 1e-5 * float(m_p.abs().max())).float()
    assert float(m_bad.mean()) <= 1e-3
    assert float((rd - rd_p).abs().max()) <= 1e-5
    assert float((cd - cd_p).abs().max()) <= 1e-5
    scale = x_64.abs().amax(-1)
    e_k = float(((x_k - x_64).abs().amax(-1) / scale).max())
    e_p = float(((x_p - x_64).abs().amax(-1) / scale).max())
    assert e_k <= 4.0 * e_p + 1e-6, (e_k, e_p)
