"""The mesh and overlap modes, the TP mega-bundle and the mesh over ranks
on the card, on the 80-frame 376x1241 loop scene (``card_checks.SCENE``):
run_pipeline on a 1-shard and a 4-shard mesh and with the stage overlap,
each against the main path; the TP overflow re-solve; a mega-bundle on 4
shards against 1; one BA batch of KITTI 00's window count; then the same
over the ranks of a process group, each rank a process of its own
(``parallel.ranks.spawn``, every group joined within RANKS_JOIN_S or
killed and the test failed): gloo ranks sharing the card, and nccl with
one rank per card where the host has two cards or more.

Every test needs a card and skips without one; the nccl test needs two.
The ranks import this module to find their functions, so it imports no
JAX, nor anything that does:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_modes.py
"""

import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from card_checks import (RANKS_JOIN_S, SEED, SLICE_TOL,  # noqa: E402
                         STAGE_ATES, ates_close, b6_against_plain, loop_scene,
                         main_path, run_path, same_frontend, solving_with)

from slam_tpu_torch import pipeline  # noqa: E402
from slam_tpu_torch.config import BundleConfig, RuntimeConfig  # noqa: E402
from slam_tpu_torch.config import SlamConfig  # noqa: E402
from slam_tpu_torch.models import bundle  # noqa: E402
from slam_tpu_torch.ops import ba  # noqa: E402
from slam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_tpu_torch.parallel import ranks  # noqa: E402
from slam_tpu_torch.parallel import tp_megabundle as tp  # noqa: E402
from slam_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from slam_tpu_torch.runtime import graphs  # noqa: E402
from slam_tpu_torch.utils import metrics, synthetic  # noqa: E402

NEED = ("detect_maps", "mutual_nearest", "cholesky_solve")
# window capacities that the scene's windows overflow (the TP re-solve)
TIGHT = {"max_landmarks": 128, "max_obs": 1024}
# a mega-bundle of tests/test_tp_megabundle.py's construction at P = 24;
# 40 LM iterations, the dense path's 2 x 20 (20 leave it short)
MEGA = {"P": 24, "L": 50_000, "obs_per_lm": 8, "iters": 40}
KITTI00_WINDOWS = 651
MESH_RANKS = 4
RANK_POSE_TOL, RANK_COST_TOL = 1e-6, 1e-9
# what the ranks' pipeline holds equal to the one-process mesh's:
# keypoints and matches
RANK_FE_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev")
# what the ranks' overlap holds equal to the one-process overlap's: the
# windows
OVERLAP_WINDOWS = ("frames", "n_poses", "track_of_lm", "meas", "cam_idx",
                   "lm_idx")
RANK_REL_T_TOL = 1e-4
RANK_ATE_SPREAD = 1e-5


# ---------------------------------------------------------------------------
# what the ranks run (module level, so that a spawned rank can import it)
# ---------------------------------------------------------------------------

def ranks_ab(mega, calib, iters: int, backend: str) -> dict:
    """One rank: the dry run's checks in this rank's process group, then
    the mega-bundle on one shard per rank (a warm-up of one iteration,
    then ``iters`` with the launch counters zeroed just before): its
    poses, cost and launches."""
    from slam_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(torch.distributed.get_world_size(), backend)
    _, _, p0, x0, ci, li, ms, w = mega
    m = make_mesh(axis="tp")
    parts = tp.partition_megabundle(x0, ci, li, ms, w, m.size)
    tp.optimize_megabundle(m, p0, *parts, calib, iters=1)
    torch.cuda.synchronize()
    ck.reset_counters()
    poses, _, cost, _ = tp.optimize_megabundle(m, p0, *parts, calib,
                                               iters=iters)
    torch.cuda.synchronize()
    return {"line": line, "poses": poses, "cost": cost,
            "launches": dict(ck.LAUNCHES), "plain": dict(ck.PLAIN_CALLS)}


def _rank_result(res, T_gt) -> dict:
    report = pipeline.evaluate(res, T_gt)
    return {"ates": {k: report[k]["ate_rmse_m"] for k in STAGE_ATES
                     if k in report},
            "closures": [(c.frame_i, c.frame_j) for c in res.closures],
            "keyframes": res.bundles.keyframes, "rel_T": res.bundles.rel_T,
            "launches": dict(ck.LAUNCHES), "plain": dict(ck.PLAIN_CALLS),
            **{k: getattr(res.bundles, k) for k in OVERLAP_WINDOWS},
            **{k: getattr(res.frontend, k) for k in RANK_FE_ARRAYS}}


def ranks_path(paths, calib, T_gt, cfg) -> dict:
    """One rank: run_pipeline(mesh=make_mesh()) on the scene (its images
    from ``paths``), once to warm up, then with the launch counters zeroed
    just before it and read just after."""
    L, R = (np.load(p) for p in paths)
    mesh = make_mesh()
    pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    ck.reset_counters()
    res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    return _rank_result(res, T_gt)


def ranks_overlap(paths, calib, T_gt, cfg) -> dict:
    """One rank: run_pipeline(mesh=make_mesh(), overlap=True) on the
    scene, once cold, then after a barrier with the launch counters
    zeroed just before it and read just after."""
    L, R = (np.load(p) for p in paths)
    mesh = make_mesh()
    pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh,
                          overlap=True)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    ck.reset_counters()
    res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh,
                                overlap=True)
    torch.cuda.synchronize()
    return _rank_result(res, T_gt)


# ---------------------------------------------------------------------------
# inputs and the one-process runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(card):
    return loop_scene()


@pytest.fixture(scope="module")
def main(card):
    return main_path()


@pytest.fixture(scope="module")
def scene_npy(scene, tmp_path_factory):
    """The scene's left and right images as .npy files, for the ranks."""
    _, L, R = scene
    d = tmp_path_factory.mktemp("scene")
    paths = (str(d / "left.npy"), str(d / "right.npy"))
    np.save(paths[0], L)
    np.save(paths[1], R)
    return paths


@pytest.fixture(scope="module")
def mega(scene):
    sc = scene[0]
    return synthetic.megaproblem(sc.calib, MEGA["P"], MEGA["L"],
                                 MEGA["obs_per_lm"], SEED)


@pytest.fixture(scope="module")
def one_shard(main):
    """run_pipeline(mesh=make_mesh()) through run_path."""
    return run_path(SlamConfig(), NEED, mesh=make_mesh())


@pytest.fixture(scope="module")
def four_shards(main):
    """run_pipeline on a 4-shard mesh with chunk_frames=16 (steps of 64
    and 16 frames) through run_path."""
    cfg16 = dataclasses.replace(SlamConfig(),
                                runtime=RuntimeConfig(chunk_frames=16))
    return run_path(cfg16, NEED, mesh=make_mesh(4))


def mega_in_process(mega, calib, n: int, iters: int):
    """The mega-bundle on a one-process n-shard mesh: (poses, cost)."""
    _, _, p0, x0, ci, li, ms, w = mega
    m = make_mesh(n, axis="tp")
    parts = tp.partition_megabundle(x0, ci, li, ms, w, n)
    poses, _, cost, _ = tp.optimize_megabundle(m, p0, *parts, calib,
                                               iters=iters)
    return poses, cost


# ---------------------------------------------------------------------------
# the mesh and overlap modes in one process
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_mesh_one_shard(scene, main, one_shard):
    """run_pipeline(mesh=make_mesh()): its frontend equal bit for bit to
    the main path's, the same keyframes and closures; every window of the
    scene overflows SlamConfig()'s capacities, so each is re-solved on
    the TP path (B6 at (1, 6n, 6n)); the window batch on the mesh
    (optimize_windows(mesh=), before the re-solve) within
    SLICE_TOL["poses"] of the main path's rel_T."""
    sc = scene[0]
    cfg = SlamConfig()
    ref, res = main["result"], one_shard["result"]
    same_frontend(res.frontend, ref.frontend)
    assert res.bundles.keyframes == ref.bundles.keyframes
    assert one_shard["closures"] == main["closures"]
    batch = bundle.build_windows(ref.db, ref.frontend.T_w2c,
                                 ref.bundles.keyframes, cfg.bundle)
    bundle.init_landmarks(batch, sc.calib)
    if batch.overflow:
        assert any(s[0] == 1 and s[1] > 12 for s in one_shard["solves"]), \
            one_shard["solves"]
    sharded = bundle.optimize_windows(batch, sc.calib, cfg.bundle,
                                      mesh=make_mesh())
    assert float(np.abs(np.asarray(sharded.rel_T)
                        - np.asarray(ref.bundles.rel_T)).max()
                 ) <= SLICE_TOL["poses"]


@pytest.mark.cuda
def test_cuda_mesh_four_shards_pad_the_batches(four_shards):
    """On a 4-shard mesh (run_path's gates) every BA batch that B6 solves
    is padded to a multiple of 4 windows."""
    batched = [s for s in four_shards["solves"] if s[0] > 1]
    assert batched and not any(s[0] % 4 for s in batched), batched


@pytest.mark.cuda
def test_cuda_mesh_overlap(scene, main, one_shard):
    """overlap=True on a 1-shard mesh (run_path's gates): the windows and
    keyframes of the sequential mesh run, its closures, rel_T within
    SLICE_TOL["poses"] of the main path's (the overlapped stages re-solve
    nothing on the TP path, as in the JAX package). Over warm runs of the
    sequential mesh path (with and without the TP re-solve) and the
    overlap in turns, the window BA's graphs neither warm up nor capture
    again: every batch shape stays cached."""
    sc, L, R = scene
    cfg = SlamConfig()
    mesh = make_mesh()
    c = run_path(cfg, NEED, mesh=mesh, overlap=True)
    res_a, res_c = one_shard["result"], c["result"]
    for k in OVERLAP_WINDOWS:
        assert np.array_equal(getattr(res_c.bundles, k),
                              getattr(res_a.bundles, k)), k
    assert res_c.bundles.keyframes == res_a.bundles.keyframes
    assert float(np.abs(np.asarray(res_c.bundles.rel_T) - np.asarray(
        main["result"].bundles.rel_T)).max()) <= SLICE_TOL["poses"]
    assert c["closures"] == one_shard["closures"]
    no_tp = dataclasses.replace(cfg, bundle=dataclasses.replace(
        cfg.bundle, tp_overflow=False))

    def warm_round():
        for c_ in (cfg, no_tp):
            pipeline.run_pipeline(L, R, sc.calib, c_, verbose=False,
                                  mesh=mesh)
        pipeline.run_pipeline(L, R, sc.calib, cfg, verbose=False, mesh=mesh,
                              overlap=True)

    for _ in range(2):  # each key's first call runs eagerly, its second
        warm_round()    # captures
    before = graphs.stats()["ops.ba.solve_windows"]
    warm_round()
    after = graphs.stats()["ops.ba.solve_windows"]
    assert all(after[k] == before[k] for k in ("warmups", "captures")), (
        before, after)
    assert after["keys"] <= graphs.MAX_KEYS


@pytest.mark.cuda
def test_cuda_tp_overflow_resolve(scene, main):
    """run_bundles on the main path's frontend under BundleConfig(
    max_landmarks=128, max_obs=1024) with 4 shards: windows with more
    observations than max_obs re-solved at full size, B6 at the TP shapes
    (1, 6n, 6n) and no plain version, every such window's rel_cov
    positive definite, the bundles' keyframe ATE at most the truncated
    solve's x 1.1 + 0.02 m; B6 against its plain version on the last
    system of its most launched TP shape."""
    sc = scene[0]
    cfg_t = dataclasses.replace(SlamConfig(), bundle=BundleConfig(**TIGHT))
    fe, db = main["result"].frontend, main["result"].db
    cut = bundle.run_bundles(db, fe.T_w2c, sc.calib, cfg_t)
    shapes, kept = collections.Counter(), {}
    solve = ba._spd_solve

    def counting(S, g):
        shapes[tuple(S.shape)] += 1
        if S.shape[0] == 1:
            kept[tuple(S.shape)] = (S.detach().clone(), g.detach().clone())
        return solve(S, g)

    torch.cuda.synchronize()
    ck.reset_counters()
    with solving_with(counting):
        res = bundle.run_bundles(db, fe.T_w2c, sc.calib, cfg_t,
                                 mesh=make_mesh(4))
    torch.cuda.synchronize()
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS
    tp_shapes = {s: n for s, n in shapes.items() if s[0] == 1}
    routed = np.nonzero(res.num_obs > TIGHT["max_obs"])[0]
    assert len(routed) and tp_shapes, (res.num_obs, shapes)
    for bi in routed:
        assert np.linalg.eigvalsh(res.rel_cov[bi].astype(np.float64)).min() \
            > 0, bi
    kfs = res.keyframes
    ate_tp = metrics.ate_rmse(res.T_w2c_keyframes, sc.T_w2c[kfs])
    ate_cut = metrics.ate_rmse(cut.T_w2c_keyframes, sc.T_w2c[kfs])
    assert ate_tp <= ate_cut * 1.1 + 0.02, (ate_tp, ate_cut)
    top = max(tp_shapes, key=lambda s: (tp_shapes[s], s[1]))
    b6_against_plain(*kept[top])


@pytest.mark.cuda
def test_cuda_megabundle_four_shards_against_one(scene, mega):
    """The mega-bundle (P = 24, 50,000 landmarks, 8 observations each;
    40 LM iterations, its sums in float64) on 4 shards and on 1: B6
    launched and no plain version, poses within 1e-4 (twist norm) and
    cost within 1e-4 relative, the cost below the initial one; B6 against
    its plain version on every reduced system of a 4-shard run, as one
    batch (on systems this ill-conditioned either solve's error alone
    varies by several times from one to the next)."""
    calib = scene[0].calib
    _, _, p0, x0, ci, li, ms, w = mega
    out = {}
    ck.reset_counters()
    for n in (4, 1):
        parts = tp.partition_megabundle(x0, ci, li, ms, w, n)
        out[n] = tp.optimize_megabundle(make_mesh(n, axis="tp"), p0, *parts,
                                        calib, iters=MEGA["iters"])
    assert ck.LAUNCHES["cholesky_solve"] and not any(
        ck.PLAIN_CALLS.values()), (ck.LAUNCHES, ck.PLAIN_CALLS)
    assert synthetic.twist_err(out[4][0], out[1][0]) <= 1e-4
    assert abs(out[4][2] - out[1][2]) / out[1][2] <= 1e-4
    assert out[4][2] < out[4][3]
    solved = []
    solve = ba._spd_solve

    def keep(S, g):
        solved.append((S.detach().clone(), g.detach().clone()))
        return solve(S, g)

    parts = tp.partition_megabundle(x0, ci, li, ms, w, 4)
    with solving_with(keep):
        tp.optimize_megabundle(make_mesh(4, axis="tp"), p0, *parts, calib,
                               iters=MEGA["iters"])
    b6_against_plain(torch.cat([S for S, _ in solved]),
                     torch.cat([g for _, g in solved]))


@pytest.mark.cuda
def test_cuda_kitti00_window_batch(scene):
    """One BA batch of KITTI 00's 651 windows at full capacity (seeded
    windows, P = 24, L = 512, M = 4096): the key's first call, eager, gives
    every window a finite cost below its initial one; the second captures
    the batch's graph (one capture) and replays it, rel_T within
    SLICE_TOL["poses"] of the first."""
    from test_torch_schur_reduce import windows

    from slam_tpu_torch.parallel import sharded_ba

    sc = scene[0]
    bc = SlamConfig().bundle
    win = windows(KITTI00_WINDOWS, bc.max_poses, bc.max_landmarks,
                  bc.max_obs, seed=SEED)[:6]
    host = [x.numpy() for x in win]
    step = sharded_ba.ba_training_step(make_mesh(), sc.calib,
                                       iters=bc.lm_iters)
    n_poses = np.full(KITTI00_WINDOWS, bc.max_poses)
    graphs.clear()  # this batch's graph alone in solve_windows' pool
    out = step(*host, n_poses)
    torch.cuda.synchronize()
    assert torch.isfinite(out[3]).all() and (out[3] < out[4]).all()
    out2 = step(*host, n_poses)
    torch.cuda.synchronize()
    assert graphs.stats()["ops.ba.solve_windows"]["captures"] == 1
    assert float((out2[5] - out[5]).abs().max()) <= SLICE_TOL["poses"]
    del out, out2
    graphs.clear()


# ---------------------------------------------------------------------------
# the mesh over ranks
# ---------------------------------------------------------------------------

def check_ranks_ab(runs, ref, n: int) -> None:
    """Every rank's mega-bundle against the one-process n-shard mesh's:
    poses within RANK_POSE_TOL (twist norm), cost within RANK_COST_TOL
    relative, B6 launched and no plain version; rank 0's dry-run line."""
    poses, cost = ref
    assert runs[0]["line"].startswith("dryrun_multichip ok"), runs[0]["line"]
    for r, out in enumerate(runs):
        assert synthetic.twist_err(out["poses"], poses) <= RANK_POSE_TOL, r
        assert abs(out["cost"] - cost) / cost <= RANK_COST_TOL, r
        assert out["launches"]["cholesky_solve"], (r, out["launches"])
        assert not any(out["plain"].values()), (r, out["plain"])


def check_overlap_ranks(runs, ref, rel_tol: float = RANK_REL_T_TOL) -> None:
    """Every rank's overlapped pipeline against the one-process overlap on
    a mesh of as many shards (``ref``, run_path's record): keypoints,
    matches, keyframes, windows and closures equal, rel_T within
    ``rel_tol``, every ATE within ATE_TOL; every rank's frontend, windows,
    rel_T, keyframes and closures equal to rank 0's, its ATEs within
    RANK_ATE_SPREAD of rank 0's (each rank optimizes the pose graph and
    the loop-closure pairs on its own, and the card's atomic sums vary in
    order); B1 launched on the frontend's first rank, B6 on the BA
    group's (rank (n + 1) // 2, as split_mesh cuts), no plain call on
    any."""
    res = ref["result"]
    for r, out in enumerate(runs):
        for k in RANK_FE_ARRAYS:
            assert np.array_equal(out[k], getattr(res.frontend, k)), (r, k)
        for k in OVERLAP_WINDOWS:
            assert np.array_equal(out[k], getattr(res.bundles, k)), (r, k)
        assert out["keyframes"] == res.bundles.keyframes, r
        assert out["closures"] == ref["closures"], r
        assert float(np.abs(out["rel_T"] - res.bundles.rel_T).max()
                     ) <= rel_tol, r
        ates_close(out["ates"], ref["ates"])
        for k in ("keyframes", "closures"):
            assert out[k] == runs[0][k], (r, k)
        for k in ("rel_T",) + RANK_FE_ARRAYS + OVERLAP_WINDOWS:
            assert np.array_equal(out[k], runs[0][k]), (r, k)
        ates_close(out["ates"], runs[0]["ates"], RANK_ATE_SPREAD)
        assert not any(out["plain"].values()), (r, out["plain"])
    assert runs[0]["launches"]["detect_maps"]
    assert runs[(len(runs) + 1) // 2]["launches"]["cholesky_solve"]


@pytest.mark.cuda
def test_cuda_gloo_ranks_dryrun_and_megabundle(scene, mega):
    """The port's dry run in MESH_RANKS gloo ranks sharing the card, then
    in the same ranks the mega-bundle, one shard per rank, against the
    one-process MESH_RANKS-shard mesh (check_ranks_ab)."""
    calib = scene[0].calib
    ref = mega_in_process(mega, calib, MESH_RANKS, MEGA["iters"])
    runs = ranks.spawn(ranks_ab, MESH_RANKS, "gloo", "cuda",
                       args=(mega, calib, MEGA["iters"], "gloo"),
                       timeout=RANKS_JOIN_S)
    check_ranks_ab(runs, ref, MESH_RANKS)


@pytest.mark.cuda
def test_cuda_gloo_ranks_pipeline(scene, scene_npy, four_shards):
    """run_pipeline(mesh=make_mesh()) in 2 gloo ranks sharing the card,
    chunk_frames=32 (steps of 64 frames, as the 4-shard mesh's), against
    the one-process 4-shard mesh: keypoints and matches equal, the same
    keyframes, rel_T within SLICE_TOL["poses"], every ATE within ATE_TOL;
    B1, B2 and B6 launched in each rank, no plain call."""
    sc = scene[0]
    cfg32 = dataclasses.replace(SlamConfig(),
                                runtime=RuntimeConfig(chunk_frames=32))
    runs = ranks.spawn(ranks_path, 2, "gloo", "cuda",
                       args=(scene_npy, sc.calib, sc.T_w2c, cfg32),
                       timeout=RANKS_JOIN_S)
    ref = four_shards["result"]
    for r, out in enumerate(runs):
        for k in RANK_FE_ARRAYS:
            assert np.array_equal(out[k], getattr(ref.frontend, k)), (r, k)
        assert out["keyframes"] == ref.bundles.keyframes, r
        assert float(np.abs(out["rel_T"] - ref.bundles.rel_T).max()
                     ) <= SLICE_TOL["poses"], r
        ates_close(out["ates"], four_shards["ates"])
        assert all(out["launches"][k] for k in NEED), (r, out["launches"])
        assert not any(out["plain"].values()), (r, out["plain"])


@pytest.mark.cuda
def test_cuda_gloo_ranks_overlap(scene, scene_npy):
    """The stage overlap over 2 gloo ranks sharing the card (rank 0 the
    frontend, rank 1 the BA, fed window batches point to point) against
    the one-process overlap on a 2-shard mesh (check_overlap_ranks, rel_T
    within RANK_REL_T_TOL: the window BA and the pose graph sum in a
    fixed order)."""
    sc = scene[0]
    ref = run_path(SlamConfig(), NEED, mesh=make_mesh(2), overlap=True)
    runs = ranks.spawn(ranks_overlap, 2, "gloo", "cuda",
                       args=(scene_npy, sc.calib, sc.T_w2c, SlamConfig()),
                       timeout=RANKS_JOIN_S)
    check_overlap_ranks(runs, ref)


@pytest.mark.cuda
def test_cuda_nccl_ranks(scene, scene_npy, mega):
    """On a host with two cards or more, nccl with one rank per card: the
    dry run and the mega-bundle on min(MESH_RANKS, cards) ranks against
    the one-process mesh of as many shards (check_ranks_ab); the stage
    overlap on 2 and on 4 cards where the host has them, against the
    one-process overlap on a mesh of as many shards (check_overlap_ranks;
    the BA rank solves on another card than the one-process reference,
    where the float32 window LM may take another accept path: 1.32e-4
    measured on 2 cards, NVIDIA H100 80GB HBM3, 700 W, so rel_T within
    SLICE_TOL["poses"])."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA cards (nccl takes one card per rank)")
    sc = scene[0]
    n = min(MESH_RANKS, n_cards)
    ref = mega_in_process(mega, sc.calib, n, MEGA["iters"])
    runs = ranks.spawn(ranks_ab, n, "nccl", "cuda",
                       args=(mega, sc.calib, MEGA["iters"], "nccl"),
                       timeout=RANKS_JOIN_S)
    check_ranks_ab(runs, ref, n)
    for n_ov in (2, 4):
        if n_cards < n_ov:
            continue
        ref_ov = run_path(SlamConfig(), NEED, mesh=make_mesh(n_ov),
                          overlap=True)
        ov = ranks.spawn(ranks_overlap, n_ov, "nccl", "cuda",
                         args=(scene_npy, sc.calib, sc.T_w2c, SlamConfig()),
                         timeout=RANKS_JOIN_S)
        check_overlap_ranks(ov, ref_ov, rel_tol=SLICE_TOL["poses"])
