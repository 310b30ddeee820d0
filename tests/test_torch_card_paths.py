"""The port's whole paths on the card, on the 80-frame 376x1241 loop scene
(``card_checks.SCENE``): each detector's path through run_pipeline, the
main path on the library solve and on the sparse pose graph, the BA
engine against the library, the disk path, the CLI and the scale run,
``entry()`` and the per-image forms, and the main path's CUDA graphs
against eager runs (those a main-path shape of test_torch_graphs.py's
graph tests does not hold). Each test holds a
path to what it must do: the kernels it must launch (counted, and by
name in a profiler trace), no plain version run, closures and ATEs, and
results equal to another route's within a stated tolerance. Times are
the benchmark's (``slambench/``), not these tests'.

Every test needs a card and skips without one. No JAX is imported:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_paths.py
"""

import collections
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import card_checks  # noqa: E402
from card_checks import (CHUNK, DETECTORS, FRONTEND_ARRAYS,  # noqa: E402
                         HW, SEED, SLICE_TOL, TRACE_NAMES, ates_close,
                         closures_of, cov_against_float64, loop_scene,
                         main_path, run_path, same_frontend, solving_with,
                         stage_ates, traced_launches, verify_args)

from slam_tpu_torch import pipeline  # noqa: E402
from slam_tpu_torch.config import RuntimeConfig, SlamConfig  # noqa: E402
from slam_tpu_torch.models import bundle, frontend, loop_closure  # noqa: E402
from slam_tpu_torch.ops import ba  # noqa: E402
from slam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_tpu_torch.runtime import graphs  # noqa: E402
from slam_tpu_torch.utils import metrics  # noqa: E402

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


def tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


# ---------------------------------------------------------------------------
# each detector's path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DETECTORS))
def test_cuda_detector_path(scene, name, monkeypatch):
    """run_pipeline under each detector's configuration, from CUDA graphs
    (``run_path``'s gates, traced): its kernels launched, counted as the
    trace counts them by device function, no plain version, >= 1
    closure, every ATE under 1 m; B6 once per LM iteration of BA and of
    loop closure, B7 once per LM iteration and per covariance system, B9's
    step once per LM iteration of the pose graph and its system once per
    iteration and per covariance, three clock stamps per replay of the
    frontend chunk's graph. Then
    its frontend eagerly: B2 twice a chunk (stereo and temporal), B1
    once a chunk at each pyramid level's shape where B1 is the detector,
    no plain version, ATE under 1 m, and chunk 0's descriptors
    recomputed as DescriptorBank does after a resume equal bit for
    bit."""
    cfg, required, b1_shapes = DETECTORS[name]
    path = main_path() if name == "harris" else run_path(cfg, required,
                                                         trace=True)
    n_lm = sum(path["solves"].values())
    assert path["launches"]["cholesky_solve"] == n_lm > 0, path["solves"]
    assert path["launches"]["schur_reduce"] == n_lm + path["cov_systems"]
    assert path["launches"]["pg_step"] == path["pg_iters"] > 0
    assert path["launches"]["pg_system"] == (path["pg_iters"]
                                             + path["pg_covs"])
    assert path["chunk_replays"] > 0
    assert path["launches"]["stamp"] == 3 * path["chunk_replays"]

    sc, L, R = scene
    shapes = []
    detect_maps = ck.detect_maps

    def recording(imgs, *a, **kw):
        shapes.append(tuple(imgs.shape))
        return detect_maps(imgs, *a, **kw)

    # eagerly: a graph's replay would not call the recording wrapper
    monkeypatch.setattr(ck, "detect_maps", recording)
    with graphs.eager():
        ck.reset_counters()
        fe = frontend.run_frontend(L, R, sc.calib, cfg, device="cuda")
        torch.cuda.synchronize()
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS
    chunks = len(range(0, len(L), cfg.runtime.chunk_frames))
    assert ck.LAUNCHES["mutual_nearest"] == 2 * chunks, ck.LAUNCHES
    if b1_shapes is not None:
        assert set(shapes) == b1_shapes
        assert ck.LAUNCHES["detect_maps"] == len(shapes) == (
            chunks * len(b1_shapes)), (ck.LAUNCHES, shapes)
    ate = metrics.trajectory_summary(fe.T_w2c, sc.T_w2c)["ate_rmse_m"]
    assert np.isfinite(fe.T_w2c).all() and ate < 1.0
    n = cfg.runtime.chunk_frames
    rec = frontend.recompute_descriptors(tensor(L[:n]), tensor(R[:n]), cfg)
    assert torch.equal(rec, fe.desc.gather(np.arange(n)))
    if name != "harris":
        graphs.clear()  # this detector's graphs: no other test's


@pytest.mark.cuda
def test_cuda_main_path_on_the_library_solve(main):
    """The main path with BA's and loop closure's reduced systems solved
    by B6's plain version (cholesky_ex + cholesky_solve, cuSOLVER) in
    place of B6, eagerly: no B6 launch, one library solve per B6 launch
    of the main path, its closures and every stage's ATE within
    ATE_TOL of its."""
    with solving_with(ck.cholesky_solve_plain):
        lib = run_path(SlamConfig(), ("detect_maps", "mutual_nearest"),
                       plain_ok=("cholesky_solve",))
    assert lib["launches"]["cholesky_solve"] == 0
    assert lib["plain"]["cholesky_solve"] == main["launches"][
        "cholesky_solve"]
    assert lib["closures"] == main["closures"]
    ates_close(lib["ates"], main["ates"])


@pytest.mark.cuda
def test_cuda_main_path_on_the_sparse_pose_graph(main, monkeypatch):
    """The main path with every pose-graph query on the sparse path
    (SPARSE_NODE_THRESHOLD cut to 8): the sparse gate and optimize
    called, the dense path's closures, every stage's ATE within ATE_TOL
    of its."""
    from slam_tpu_torch.models import pose_graph
    from slam_tpu_torch.ops import pg_sparse

    calls = collections.Counter()

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name in ("optimize_sparse", "gate_matrix_sparse",
                 "marginal_logdets_sparse"):
        monkeypatch.setattr(pg_sparse, name,
                            counted(name, getattr(pg_sparse, name)))
    monkeypatch.setattr(pose_graph, "SPARSE_NODE_THRESHOLD", 8)
    sp = run_path(SlamConfig(), ("detect_maps", "mutual_nearest",
                                 "cholesky_solve"), on_reset=calls.clear)
    assert calls["gate_matrix_sparse"] and calls["optimize_sparse"], calls
    assert sp["closures"] == main["closures"]
    ates_close(sp["ates"], main["ates"])


@pytest.mark.cuda
def test_cuda_ba_engine_b6_against_the_library(card):
    """optimize_bundle at BA's device batch and capacities (64 seeded
    windows, P = 24, L = 512, M = 4096, lm_iters) eagerly on B6 and on the
    library solve: each side's median final cost finite and below the
    initial one, the two within 1 %. One LM iteration's back-substitution
    on B6 (B7's landmark steps, the pose retraction) makes no call that
    waits for the card (sync debug mode "error"): a pageable host copy
    there once made the host wait every iteration."""
    from test_torch_schur_reduce import windows

    from slam_tpu_torch.ops import se3

    bc = SlamConfig().bundle
    *win, calib = windows(64, bc.max_poses, bc.max_landmarks, bc.max_obs,
                          seed=SEED, device="cuda")
    cost0 = float(ba._cost(*win, calib).median())
    costs = {}
    for side, solve in (("library", ck.cholesky_solve_plain),
                        ("B6", ba._spd_solve)):
        with solving_with(solve):
            out = ba.optimize_bundle(*win, calib, iters=bc.lm_iters)
            costs[side] = float(out[2].median())
    for c in costs.values():
        assert np.isfinite(c) and c < cost0, (costs, cost0)
    assert abs(costs["B6"] - costs["library"]) <= 0.01 * costs["library"]

    poses, points, cam, lm, meas, w = win
    P, n_lm = poses.shape[1], points.shape[1]
    slot = ba._slot_table(cam, lm, w, P, n_lm)
    lam = torch.full((poses.shape[0],), 1e-4, device=card)
    S, ghat, Hll_inv, g_l, cross = ck.schur_reduce(
        poses, points, cam, lm, meas, w, calib, slot, lam)
    dp = -ck.cholesky_solve(S, ghat)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dl = ck.schur_back(dp, slot, cross, Hll_inv, g_l)
        new_poses = se3.retract(poses, dp.reshape(-1, P, 6))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(dl).all() and torch.isfinite(new_poses).all()


# ---------------------------------------------------------------------------
# the disk path, the CLI, the scale run
# ---------------------------------------------------------------------------

def u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def kitti_paths(root, seq, left, right, calib, T_w2c):
    """A sequence written in KITTI's layout: (left paths, right paths,
    calibration and poses read back from the files)."""
    from slam_tpu_torch.utils import kitti

    paths = kitti.write_kitti_sequence(root, seq, u8(left), u8(right), calib,
                                       T_w2c)
    lp = sorted(str(p) for p in paths.left_dir.glob("*.png"))
    rp = sorted(str(p) for p in paths.right_dir.glob("*.png"))
    return lp, rp, kitti.calib_vector(paths), kitti.read_ground_truth(paths)


@pytest.fixture(scope="module")
def kitti00(scene, tmp_path_factory):
    """The scene written as uint8 PNGs in KITTI's layout, sequence 00:
    (root, left paths, right paths, calibration, ground truth)."""
    sc, L, R = scene
    root = tmp_path_factory.mktemp("kitti")
    return (root,) + kitti_paths(root, "00", L, R, sc.calib, sc.T_w2c)


@pytest.fixture(scope="module")
def disk_run(kitti00, tmp_path_factory):
    """run_pipeline from the path lists with a cold stage cache: its
    result, ATEs, launches and plain calls, and the cache."""
    _, lp, rp, calib, T_gt = kitti00
    cache = tmp_path_factory.mktemp("cache")
    ck.reset_counters()
    res = pipeline.run_pipeline(lp, rp, calib, SlamConfig(), cache_dir=cache,
                                verbose=False, device="cuda")
    torch.cuda.synchronize()
    report = pipeline.evaluate(res, T_gt)
    return {"result": res, "report": report, "cache": cache,
            "launches": dict(ck.LAUNCHES), "plain": dict(ck.PLAIN_CALLS)}


@pytest.mark.cuda
def test_cuda_disk_path_with_a_stage_cache(kitti00, disk_run):
    """run_pipeline from the PNGs' path lists with a stage cache: the
    native decoder built, B1, B2 and B6 launched, no plain version, >= 1
    closure, every ATE under 1 m; a second call loads every stage from
    the cache (no kernel launched) with the same closures and
    trajectories."""
    from slam_tpu_torch import runtime
    from slam_tpu_torch.parallel import pipeline as ppipe

    _, lp, rp, calib, _ = kitti00
    assert runtime.available(), runtime.build_error
    assert ppipe.PngFrames(lp, rp, HW).decoder.startswith("native")
    assert all(disk_run["launches"][k] > 0 for k in (
        "detect_maps", "mutual_nearest", "cholesky_solve"))
    assert not any(disk_run["plain"].values()), disk_run["plain"]
    assert disk_run["report"]["num_closures"] >= 1
    stage_ates(disk_run["report"])
    r1 = disk_run["result"]
    ck.reset_counters()
    r2 = pipeline.run_pipeline(lp, rp, calib, SlamConfig(),
                               cache_dir=disk_run["cache"], verbose=False,
                               device="cuda")
    assert not any(ck.LAUNCHES.values()), ck.LAUNCHES
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS
    assert closures_of(r2) == closures_of(r1)
    for get in (lambda r: r.T_frontend, lambda r: r.bundles.T_w2c_keyframes,
                lambda r: r.pose_graph_pre_lc.nodes,
                lambda r: r.keyframe_trajectory()):
        assert np.array_equal(get(r1), get(r2))


@pytest.mark.cuda
def test_cuda_frontend_resumes_bit_for_bit(kitti00, tmp_path):
    """The frontend from the PNGs in chunks of 16, stopped after 48 frames
    and resumed from its checkpoint, equal bit for bit to an
    uninterrupted run; the resumed frames' descriptors recomputed from the
    PNGs equal the originals."""
    from slam_tpu_torch.parallel import pipeline as ppipe

    _, lp, rp, calib, _ = kitti00
    cfg16 = dataclasses.replace(SlamConfig(),
                                runtime=RuntimeConfig(chunk_frames=16))
    n = len(lp)

    def from_pngs(m, **kw):
        return ppipe.run_frontend_pipelined(lp[:m], rp[:m], HW, calib, cfg16,
                                            device="cuda", **kw)

    full = from_pngs(n)
    ckpt = str(tmp_path / "fe_ckpt.npz")
    from_pngs(48, checkpoint_path=ckpt, checkpoint_every=16)
    resumed = from_pngs(n, checkpoint_path=ckpt, checkpoint_every=16,
                        resume=True)
    same_frontend(resumed, full, np.arange(48, n))
    assert torch.equal(resumed.desc.gather(np.arange(48)),
                       full.desc.gather(np.arange(48)))


@pytest.mark.cuda
def test_cuda_run_frontend_equals_a_sequential_loop(scene):
    """run_frontend (uploads and read-backs overlapped) equal bit for bit,
    every per-frame array and descriptor, to a plain sequential loop over
    process_chunk written here."""
    sc, L, R = scene
    cfg = SlamConfig()
    calib = torch.from_numpy(sc.calib).cuda()
    carry, T_carry, T_all, parts, descs = None, np.eye(4, dtype=np.float32), \
        [], [], []
    for ci, s in enumerate(range(0, len(L), CHUNK)):
        m = min(CHUNK, len(L) - s)
        blk = [np.zeros((CHUNK,) + HW, np.float32) for _ in range(2)]
        blk[0][:m], blk[1][:m] = L[s:s + m], R[s:s + m]
        out, carry = frontend.process_chunk(
            tensor(blk[0]), tensor(blk[1]), carry, calib, cfg,
            generator=frontend.chunk_generator(cfg, ci, "cuda"))
        descs.append(out.pop("desc")[:m])
        host = {k: v[:m].cpu().numpy() for k, v in out.items()}
        T_all.append(host["T_chain"] @ T_carry[None])
        T_carry = T_all[-1][-1]
        parts.append(host)
    fe = frontend.run_frontend(L, R, sc.calib, cfg, device="cuda")
    T_rel = np.concatenate([p["T_rel"] for p in parts])
    T_rel[0] = np.eye(4, dtype=np.float32)
    seq = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    seq.update(T_rel=T_rel, T_w2c=np.concatenate(T_all))
    for k in FRONTEND_ARRAYS:
        assert np.array_equal(seq[k], getattr(fe, k)), k
    assert torch.equal(torch.cat(descs), fe.desc[:])


@pytest.fixture(scope="module")
def main_windows(main):
    return card_checks.main_windows()


@pytest.mark.cuda
def test_cuda_optimize_windows_in_slices(scene, main_windows):
    """optimize_windows on the scene's windows in pipelined slices of 4
    against one slice of 16: each window's LM is independent of the others
    in its slice, so every pose entry within SLICE_TOL["poses"] and every
    relative cost within SLICE_TOL["cost"]."""
    sc = scene[0]
    bc = SlamConfig().bundle
    runs = {db: bundle.optimize_windows(main_windows, sc.calib, bc,
                                        device_batch=db, device="cuda")
            for db in (16, 4)}
    a, b = runs[4], runs[16]
    assert float(np.abs(a.poses - b.poses).max()) <= SLICE_TOL["poses"]
    assert float((np.abs(a.cost - b.cost)
                  / np.maximum(np.abs(b.cost), 1.0)).max()) <= SLICE_TOL[
        "cost"]


@pytest.mark.cuda
def test_cuda_disk_sequence_through_the_bucket(card, tmp_path):
    """A 16-frame 370x1226 sequence (KITTI 04-12's size) from PNGs through
    the (376, 1248) bucket it shares with 376x1241: B1 launched, frontend
    trajectory finite with ATE under 1 m, and a decoded frame equal to
    pad_to_bucket of the written one."""
    from slam_tpu_torch.parallel import pipeline as ppipe
    from slam_tpu_torch.utils import kitti, synthetic

    hw2 = (370, 1226)
    bucket = kitti.bucket_for([HW, hw2])
    sc2 = synthetic.make_scene(seed=SEED + 1, num_frames=16,
                               num_landmarks=4000, trajectory="straight",
                               hw=hw2)
    L2, R2 = synthetic.render_sequence(sc2)
    lp2, rp2, calib2, T_gt2 = kitti_paths(tmp_path, "04", L2, R2, sc2.calib,
                                          sc2.T_w2c)
    ck.reset_counters()
    r3 = pipeline.run_pipeline(lp2, rp2, calib2, SlamConfig(),
                               image_hw=bucket, run_loop_closure=False,
                               verbose=False, device="cuda")
    assert ck.LAUNCHES["detect_maps"] > 0
    ate = metrics.trajectory_summary(r3.T_frontend, T_gt2)["ate_rmse_m"]
    assert np.isfinite(r3.T_frontend).all() and ate < 1.0
    frame0 = torch.zeros(bucket, dtype=torch.uint8)
    ppipe.PngFrames(lp2, rp2, bucket).decode(lp2[0], frame0)
    assert np.array_equal(frame0.numpy(),
                          kitti.pad_to_bucket(u8(L2[:1]), bucket)[0])


def run_module(args, env=None, timeout: int = 600):
    """``python3 -m <args>`` from the repository's root, as a user runs
    it."""
    env = dict(os.environ if env is None else env, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def rc0(proc) -> str:
    return f"exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"


@pytest.mark.cuda
def test_cuda_cli_on_kitti(kitti00, disk_run, tmp_path):
    """``python -m slam_tpu_torch --kitti-root <the PNGs> --seq 00`` as a
    user starts it: rc 0; the disk run's closures (in the cache and in
    report.json); every stage's ATE under 1 m and within ATE_TOL of
    run_pipeline called in this process with the CLI's (376, 1248) image
    bucket; graphs/analysis.json with numbers for every artifact, and
    their PNGs where matplotlib is installed (else none, and the
    note)."""
    from slam_tpu_torch.utils import analysis, kitti

    root = kitti00[0]
    out = tmp_path / "cli"
    proc = run_module(["slam_tpu_torch", "--kitti-root", str(root), "--seq",
                       "00", "--out", str(out)])
    assert proc.returncode == 0, rc0(proc)
    seq = out / "00"
    report = json.loads((seq / "report.json").read_text())
    ates = stage_ates(report)
    closures = [(c.frame_i, c.frame_j) for c in
                loop_closure.load_closures(seq / "cache" / "closures.npz")]
    assert closures == closures_of(disk_run["result"])
    assert report["num_closures"] == len(closures)
    paths = kitti.KittiPaths(root=root, sequence="00")
    lp = sorted(str(p) for p in paths.left_dir.glob("*.png"))
    rp = sorted(str(p) for p in paths.right_dir.glob("*.png"))
    same = pipeline.evaluate(pipeline.run_pipeline(
        lp, rp, kitti.calib_vector(paths), SlamConfig(),
        image_hw=kitti.bucket_for([HW]), verbose=False, device="cuda"),
        kitti.read_ground_truth(paths))
    assert set(ates) == set(stage_ates(disk_run["report"]))
    ates_close(ates, {k: same[k]["ate_rmse_m"] for k in ates})
    an = json.loads((seq / "graphs" / "analysis.json").read_text())
    want = [a for a in analysis.ARTIFACTS
            if closures or "poseGraph_LC" not in a]
    assert not [a for a in want
                if not an["artifacts"].get(a, {}).get("series")]
    pngs = sorted(p.name for p in (seq / "graphs").glob("*.png"))
    if importlib.util.find_spec("matplotlib") is not None:
        assert all(f"{a}.png" in pngs for a in want), pngs
    else:
        assert not pngs and an["plots"] == analysis.NO_MATPLOTLIB


@pytest.mark.cuda
def test_cuda_cli_synthetic(card, tmp_path):
    """``python -m slam_tpu_torch --synthetic loop --frames 80``: rc 0,
    >= 1 closure, every stage's ATE under 1 m."""
    proc = run_module(["slam_tpu_torch", "--synthetic", "loop", "--frames",
                       "80", "--out", str(tmp_path)])
    assert proc.returncode == 0, rc0(proc)
    report = json.loads((tmp_path / "synthetic" / "report.json").read_text())
    stage_ates(report)
    assert report["num_closures"] >= 1


@pytest.mark.cuda
def test_cuda_analysis_launches_b2_per_closure(scene, main, tmp_path):
    """utils.analysis.run_analysis on the main path's result: B2 once per
    closure (the loop-match probe), no plain version."""
    from slam_tpu_torch.utils import analysis

    sc, L, _ = scene
    res = main["result"]
    ck.reset_counters()
    analysis.run_analysis(res, sc.T_w2c, tmp_path, images_left=L)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["mutual_nearest"] == len(res.closures)
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS


@pytest.mark.cuda
def test_cuda_cli_without_a_card_fails(card, tmp_path):
    """The CLI with no card visible (CUDA_VISIBLE_DEVICES="") exits
    non-zero naming the card: it does not fall back to the CPU."""
    proc = run_module(["slam_tpu_torch", "--synthetic", "loop", "--frames",
                       "8", "--out", str(tmp_path)],
                      env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr, rc0(proc)


# the clover at reduced depth and full width: 336 frames at ~1 m a frame
# drive four laps of radii 10-16 m, each back through the origin
SCALE_ARGS = ("--frames", "336", "--radii", "10", "13", "16", "14.5",
              "--landmarks", "12000", "--corridor", "6")


@pytest.mark.cuda
def test_cuda_scale_run_and_rerun(card, tmp_path):
    """``python -m slam_tpu_torch.scale_run`` on a 336-frame 376x1241
    clover: rc 0, >= 1 closure, every stage's ATE under 1 m; a second
    invocation loads every stage from its artifacts (no stage run, the
    same timings and ATEs)."""
    args = ["slam_tpu_torch.scale_run", *SCALE_ARGS, "--out", str(tmp_path)]
    proc = run_module(args)
    assert proc.returncode == 0, rc0(proc)
    report = json.loads((tmp_path / "report.json").read_text())
    ates = stage_ates(report)
    assert report["num_closures"] >= 1, report["revisits"]
    proc = run_module(args)
    assert proc.returncode == 0, rc0(proc)
    again = json.loads((tmp_path / "report.json").read_text())
    assert not again["stages_run"], again["stages_run"]
    assert again["timings_s"] == report["timings_s"]
    assert stage_ates(again) == ates


# ---------------------------------------------------------------------------
# entry() and the per-image forms
# ---------------------------------------------------------------------------

# the JAX step's outputs, as jax.eval_shape gives them
# (tests/test_torch_public_ops.py holds the port's step to them on the CPU)
ENTRY_OUTPUTS = {"T_rel": ((4, 4, 4), torch.float32),
                 "num_inliers": ((4,), torch.int32)}
# the per-image forms run on row PER_IMAGE_ROW of the scene's first
# PER_IMAGE_BATCH left images, the batched forms on all of them
PER_IMAGE_BATCH, PER_IMAGE_ROW = 32, 5


@pytest.mark.cuda
def test_cuda_entry_step(card):
    """entry()'s step (one frontend chunk of 4 x 256 x 832) twice on the
    card: outputs of the JAX step's shapes and dtypes, on the card and
    finite, B1 and B2 launched, no plain version."""
    from slam_tpu_torch.entry import entry

    step, args = entry()
    ck.reset_counters()
    for _ in range(2):
        outs = step(*args)
    torch.cuda.synchronize()
    for (name, (shape, dtype)), x in zip(ENTRY_OUTPUTS.items(), outs):
        assert tuple(x.shape) == shape and x.dtype == dtype, name
        assert x.device.type == "cuda" and torch.isfinite(x.float()).all()
    assert ck.LAUNCHES["detect_maps"] and ck.LAUNCHES["mutual_nearest"]
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS


@pytest.mark.cuda
def test_cuda_per_image_forms_equal_batched_rows(scene):
    """Each per-image form on one frame equal bit for bit to that row of
    its batched form; ``features.detect`` on B4 (one launch, no plain
    call) with xy and valid equal to detect_and_describe_batch's row on
    B1; match_stereo_pair equal to the batched matcher's row."""
    from slam_tpu_torch.ops import akaze, features, matching, orb, sift

    _, L, R = scene
    n, i = PER_IMAGE_BATCH, PER_IMAGE_ROW
    left, right = tensor(L[:n]), tensor(R[:n])
    forms = {
        "detect_and_describe": (features.detect_and_describe,
                                features.detect_and_describe_batch, {}),
        "detect_and_describe_multiscale": (
            features.detect_and_describe_multiscale,
            features.detect_and_describe_multiscale_batch, {}),
        "detect_and_describe_akaze": (akaze.detect_and_describe_akaze,
                                      akaze.detect_and_describe_akaze_batch,
                                      {}),
        "detect_and_describe_sift": (sift.detect_and_describe_sift,
                                     sift.detect_and_describe_sift_batch,
                                     {"octaves": 4}),
        "detect_and_describe_orb": (orb.detect_and_describe_orb,
                                    orb.detect_and_describe_orb_batch, {}),
    }
    batched = {}
    for name, (one, many, kw) in forms.items():
        a, batched[name] = one(left[i], **kw), many(left, **kw)
        differ = [k for k in a if not torch.equal(a[k], batched[name][k][i])]
        assert not differ, (name, differ)
    ck.reset_counters()
    det = features.detect(left[i])
    torch.cuda.synchronize()
    assert ck.LAUNCHES["harris_response"] == 1
    assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS
    full = batched["detect_and_describe"]
    assert torch.equal(det["xy"], full["xy"][i])
    assert torch.equal(det["valid"], full["valid"][i])
    mc = SlamConfig().matching
    win, _ = frontend.search_windows(mc)
    feats_r = features.detect_and_describe_batch(right)
    pair = matching.match_stereo_pair(
        {k: v[i] for k, v in full.items()},
        {k: v[i] for k, v in feats_r.items()}, win, mc.max_desc_dist)
    rows = matching.match_stereo_pair_batched(full, feats_r, win,
                                              mc.max_desc_dist)
    assert all(torch.equal(v, rows[k][i]) for k, v in pair.items())


# ---------------------------------------------------------------------------
# the main path's CUDA graphs against eager runs
# ---------------------------------------------------------------------------

# the main path's graphed functions, each of which must replay in a warm
# run of the main path
MAIN_GRAPHS = ("models.frontend._chunk", "ops.ba.solve_windows",
               "models.loop_closure._verify_candidates",
               "ops.pose_graph.optimize", "ops.pose_graph.gate_matrix")
# KITTI 00's keyframe count: the dense pose graph's 704-node bucket
KITTI00_KEYFRAMES = 652
# a graphed pose-graph op against eager: nodes in m, cost and gate
# distances relative, a distance under 0.01 taken as 0.01
PG_TOL = {"nodes": 1e-3, "cost": 1e-3, "gate": 1e-3}


def stats_delta(after: dict, before: dict) -> dict:
    keys = ("warmups", "captures", "replays")
    return {name: {k: st[k] - before.get(name, {}).get(k, 0) for k in keys}
            for name, st in after.items()
            if any(st[k] != before.get(name, {}).get(k, 0) for k in keys)}


@pytest.fixture(scope="module")
def graphed_main(scene):
    """The main path, every graph freed first: twice under graphs.eager()
    (the second kept), then three graphed runs (warm-ups, captures,
    replays) and one more under torch.profiler after a lead run. Per
    run: the result, ATEs, closures, launches, plain calls, the graphs'
    warm-ups, captures and replays, and the calls of torch.linalg.inv_ex
    from Python; the traced run's launches in the trace."""
    sc, L, R = scene
    cfg = SlamConfig()
    inv_ex = torch.linalg.inv_ex
    inv_calls = [0]

    def counted_inv_ex(*a, **kw):  # Python calls only: a replay calls none
        inv_calls[0] += 1
        return inv_ex(*a, **kw)

    def pipe():
        return pipeline.run_pipeline(L, R, sc.calib, cfg, verbose=False,
                                     device="cuda")

    def run(trace=False):
        torch.cuda.synchronize()
        ck.reset_counters()
        before = graphs.stats()
        inv_calls[0] = 0
        torch.linalg.inv_ex = counted_inv_ex
        try:
            res, traced, names = traced_launches(pipe, ck.reset_counters) \
                if trace else (pipe(), None, None)
            torch.cuda.synchronize()
        finally:
            torch.linalg.inv_ex = inv_ex
        rep = pipeline.evaluate(res, sc.T_w2c)
        return {"result": res, "launches": dict(ck.LAUNCHES),
                "plain": dict(ck.PLAIN_CALLS), "traced": traced,
                "names": names, "stats": stats_delta(graphs.stats(), before),
                "inv_ex": inv_calls[0], "ates": stage_ates(rep),
                "closures": closures_of(res)}

    graphs.clear()
    with graphs.eager():
        run()
        eager = run()
    graphed = [run() for _ in range(3)] + [run(trace=True)]
    return {"eager": eager, "graphed": graphed}


@pytest.mark.cuda
def test_cuda_graphed_main_path_equals_eager(graphed_main):
    """Every graphed run against the eager one: no plain version, the
    same launches (B1, B2, B6, B7, the stamps), the same closures (>= 1),
    every ATE under 1 m and within ATE_TOL of eager's. In the third run
    every graphed function of the main path replays (the window batch and
    each closure's pair, the initial gate and a refresh and a
    re-optimisation per closure), and no inverse runs outside a graph;
    the traced run warms up and captures nothing and its launches equal
    the trace's by device function."""
    eager = graphed_main["eager"]
    for r in graphed_main["graphed"]:
        assert not any(r["plain"].values()), r["plain"]
        assert r["launches"] == eager["launches"]
        assert r["closures"] == eager["closures"] and r["closures"]
        ates_close(r["ates"], eager["ates"])
    warm, traced = graphed_main["graphed"][2:]
    n_closures = len(warm["closures"])
    needs = {"ops.ba.solve_windows": 1 + n_closures,
             "ops.pose_graph.gate_matrix": 1 + n_closures,
             "ops.pose_graph.optimize": n_closures}
    for name in MAIN_GRAPHS:
        got = warm["stats"].get(name, {}).get("replays", 0)
        assert got >= needs.get(name, 1), (name, warm["stats"])
    assert not any(st["warmups"] or st["captures"]
                   for st in traced["stats"].values()), traced["stats"]
    assert warm["inv_ex"] == traced["inv_ex"] == 0
    assert all(traced["traced"][k] == traced["launches"][k]
               for k in TRACE_NAMES), (traced["launches"], traced["names"])


def graph_vs_eager(fn, fn_new, check) -> None:
    """fn under graphs.eager() and graphed (three calls: eager, capture,
    replay), each graphed result held to eager's by ``check``; fn_new,
    new inputs of the same shapes, the same."""
    with graphs.eager():
        want, want_new = fn(), fn_new()
    for got in [fn() for _ in range(3)]:
        check(got, want)
    check(fn_new(), want_new)


def pose_graph_vs_eager(g, nodes_new) -> None:
    """ops.pose_graph.optimize (15 LM iterations) and gate_matrix over
    every pair of ``g``'s nodes, at its buckets, from their graphs
    against eager on ``g`` and on it with ``nodes_new``: nodes within
    PG_TOL["nodes"] m, the cost within PG_TOL["cost"] relative, the same
    pairs failing closed, distances within PG_TOL["gate"] relative."""
    from slam_tpu_torch.ops import pose_graph as pg_ops

    args, n_valid = g._dense_args()
    N = g.num_nodes
    nodes_p = args[0].clone()
    nodes_p[:N] = torch.as_tensor(nodes_new, device="cuda")
    new = (nodes_p,) + tuple(args[1:])
    ii, jj = np.tril_indices(N, k=-1)
    P = len(ii)
    pairs = tuple(torch.as_tensor(x, device="cuda")
                  for x in g._padded_pairs(jj, ii))

    def nodes_close(a, b):
        assert float((a[0][:N] - b[0][:N]).abs().max()) <= PG_TOL["nodes"]
        assert float((a[1] - b[1]).abs() / b[1].abs().clamp(min=1e-12)
                     ) <= PG_TOL["cost"]

    def dist_close(a, b):
        fa, fb = torch.isfinite(a[:P]), torch.isfinite(b[:P])
        assert torch.equal(fa, fb)
        assert float(((a[:P][fa] - b[:P][fa]).abs()
                      / b[:P][fa].abs().clamp(min=1e-2)).max()
                     ) <= PG_TOL["gate"]

    graph_vs_eager(
        lambda: pg_ops.optimize(*args, iters=15, n_valid=n_valid),
        lambda: pg_ops.optimize(*new, iters=15, n_valid=n_valid),
        nodes_close)
    graph_vs_eager(
        lambda: pg_ops.gate_matrix(*args, *pairs, n_valid=n_valid),
        lambda: pg_ops.gate_matrix(*new, *pairs, n_valid=n_valid),
        dist_close)


@pytest.mark.cuda
def test_cuda_pose_graph_graphs_equal_eager_at_the_scene(main):
    """The pose graph's two graphed ops on the scene's graph with its
    closures, at its buckets (pose_graph_vs_eager)."""
    res = main["result"]
    g = res.pose_graph_pre_lc.copy()
    for c in res.closures:
        g.add_edge(c.kf_i, c.kf_j, c.rel_T, c.rel_cov, loop=True)
    pose_graph_vs_eager(g, res.pose_graph.nodes)


@pytest.mark.cuda
def test_cuda_pose_graph_graphs_equal_eager_at_kitti00(card):
    """The same on a stiff graph of KITTI 00's 652 keyframes (the 704-node
    bucket), its nodes moved by up to ~3 cm for the new inputs."""
    from stiff_graphs import stiff_loop_graph

    from slam_tpu_torch.ops import se3

    g = stiff_loop_graph(KITTI00_KEYFRAMES, "cuda",
                         loops=((100, 600), (300, 640)))
    xi = np.zeros((KITTI00_KEYFRAMES, 6), np.float32)
    xi[1:, 3:] = np.random.default_rng(SEED).normal(
        0, 0.01, (KITTI00_KEYFRAMES - 1, 3))
    pose_graph_vs_eager(g, se3.retract(torch.from_numpy(g.nodes),
                                       torch.from_numpy(xi)).numpy())


@pytest.mark.cuda
def test_cuda_pair_refinement_graph_equals_eager(scene, main):
    """The first closure's pair refinement (solve_windows at (1, 2, 512),
    on its own correspondences) from its graph against eager: rel_T
    within SLICE_TOL["poses"], from the verified pose and from one moved
    by 5 cm; its rel_cov within COV_TOL of a float64 inverse."""
    sc = scene[0]
    res = main["result"]
    bc = SlamConfig().bundle
    C, Q = SlamConfig().loop.max_candidates, loop_closure.SPEC_Q
    calib = torch.tensor(sc.calib, device="cuda")
    cl = res.closures[0]
    with graphs.eager():
        vr = loop_closure._verify_candidates(*verify_args(
            res, [cl.frame_j] * Q, [cl.frame_i] * C))
    inl = vr["inliers"][0].cpu().numpy()
    tgt = vr["match_tgt"][0].cpu().numpy()
    T0 = vr["T"][0].cpu().numpy()
    T0_new = T0.copy()
    T0_new[:3, 3] += 0.05

    def refine(T_init):
        return loop_closure._refine_pair(
            res.db.links[cl.frame_i], res.db.links[cl.frame_j], inl, tgt,
            T_init, sc.calib, calib, max_landmarks=bc.max_landmarks)

    def pair_close(a, b):
        assert float(np.abs(a[0] - b[0]).max()) <= SLICE_TOL["poses"]

    graph_vs_eager(lambda: refine(T0), lambda: refine(T0_new), pair_close)
    cov_against_float64(lambda: refine(T0))


@pytest.mark.cuda
def test_cuda_optimize_bundle_graph_equals_eager(card):
    """optimize_bundle at the device batch (64 seeded windows, P = 24,
    L = 512, M = 4096, lm_iters) from its graph against eager: poses
    within SLICE_TOL["poses"], the costs within SLICE_TOL["cost"]
    relative."""
    from test_torch_schur_reduce import windows

    bc = SlamConfig().bundle
    *win, calib = windows(64, bc.max_poses, bc.max_landmarks, bc.max_obs,
                          seed=SEED, device="cuda")

    def ob():
        return ba.optimize_bundle(*win, calib, iters=bc.lm_iters)

    with graphs.eager():
        want = ob()
    got = [ob() for _ in range(3)][-1]
    assert float(((got[2] - want[2]).abs() / want[2]).max()) <= SLICE_TOL[
        "cost"]
    assert float((got[0] - want[0]).abs().max()) <= SLICE_TOL["poses"]
