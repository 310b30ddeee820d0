"""The port's main path as a whole: run_pipeline of both packages on one
rendered loop scene, and the port's guards.

The JAX package renders the scene and both packages get the same numpy
images. The packages draw different RANSAC hypotheses (jax.random vs a
torch.Generator), so frame poses differ at the inlier-set margin; those
differences chain along the trajectory. The bounds below state that.

The port runs under its own config (``slam_tpu_torch.config``), the JAX
package under the same config read back through its own module.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu import pipeline as jpipe
from slam_tpu.utils import metrics as jmetrics
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import config, pipeline
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, LoopConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.utils import metrics, synthetic

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


def jax_config(cfg):
    """The JAX package's SlamConfig equal to the port's ``cfg``."""
    return jconfig.SlamConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def runs():
    scene = jsynth.make_scene(jax.random.PRNGKey(3), num_frames=80,
                              num_landmarks=6000, trajectory="loop",
                              hw=(160, 320))
    L, R = jsynth.render_sequence(scene)
    calib = np.asarray(scene.calib)
    res_j = jpipe.run_pipeline(L, R, calib, jax_config(CFG), verbose=False)
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


@pytest.fixture(scope="module")
def small_scene():
    """16 frames of 128x256 driving straight (the port's generator)."""
    scene = synthetic.make_scene(seed=2, num_frames=16, num_landmarks=2000,
                                 hw=(128, 256), step_m=0.8)
    return synthetic.render_sequence(scene) + (scene,)


@pytest.mark.parametrize("n_shards, overlap", [(1, False), (8, False),
                                               (8, True), (None, True)])
def test_mesh_and_overlap_run_on_the_cpu(small_scene, n_shards, overlap):
    """run_pipeline with a mesh on the CPU (1 or 8 shards), overlapped
    or not: it runs end to end on the mesh's device and tracks (frontend
    ATE under 0.5 m); overlap alone, without a mesh, is the sequential
    pipeline, as in the JAX package; the overlapped stages are timed as
    one."""
    from slam_tpu_torch.parallel.mesh import make_mesh

    L, R, scene = small_scene
    cfg = dataclasses.replace(CFG, runtime=RuntimeConfig(chunk_frames=2))
    mesh = None if n_shards is None else make_mesh(n_shards, device="cpu")
    res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                mesh=mesh, overlap=overlap,
                                device=None if mesh else "cpu")
    ev = pipeline.evaluate(res, scene.T_w2c)
    assert ev["frontend"]["ate_rmse_m"] < 0.5
    assert np.isfinite(res.bundles.rel_T).all()
    merged = overlap and mesh is not None
    assert ("frontend+bundles_overlapped" in res.timings) == merged
    assert ("frontend" in res.timings) == (not merged)


@pytest.mark.parametrize("kwargs", [{"mesh": "1 shard"}, {"overlap": True}])
def test_mesh_or_overlap_with_path_lists_raise(kwargs, tmp_path):
    """Path lists (a sequence on disk) with a mesh or overlap raise
    ValueError, as in the JAX package."""
    from slam_tpu_torch.parallel.mesh import make_mesh

    if "mesh" in kwargs:
        kwargs = {"mesh": make_mesh(device="cpu")}
    paths = [str(tmp_path / f"{i:06d}.png") for i in range(2)]
    with pytest.raises(ValueError, match="in-memory image arrays"):
        pipeline.run_pipeline(paths, paths, synthetic.KITTI_CALIB, CFG,
                              verbose=False, device="cpu", **kwargs)


@pytest.mark.parametrize("entry", ["run_pipeline", "run_frontend", "cli",
                                   "scale_run", "pnp_trajectory_from_db",
                                   "make_mesh", "entry"])
def test_default_device_is_the_card(entry, monkeypatch, tmp_path):
    """Called without a device (the CLI and the scale run without
    --cpu), the entry points run on the card; with no card they raise
    instead of quietly taking the plain versions on the CPU."""
    import types

    from slam_tpu_torch import entry as entry_mod
    from slam_tpu_torch import scale_run
    from slam_tpu_torch.__main__ import main as cli_main
    from slam_tpu_torch.models import db_odometry, frontend
    from slam_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs = np.zeros((2, 96, 160), np.float32)
    db = types.SimpleNamespace(track_ids=np.zeros((3, 4), np.int32),
                               links=np.ones((3, 4, 3), np.float32),
                               num_frames=3)
    out = ["--out", str(tmp_path / "out")]
    call = {
        "run_pipeline": lambda: pipeline.run_pipeline(
            imgs, imgs, synthetic.KITTI_CALIB, CFG),
        "run_frontend": lambda: frontend.run_frontend(
            imgs, imgs, synthetic.KITTI_CALIB, CFG),
        "cli": lambda: cli_main(["--synthetic", "loop", "--frames", "4"]
                                + out),
        "scale_run": lambda: scale_run.main(["--frames", "4"] + out),
        "pnp_trajectory_from_db": lambda: db_odometry.pnp_trajectory_from_db(
            db, synthetic.KITTI_CALIB),
        "make_mesh": lambda: make_mesh(4),
        "entry": entry_mod.entry,
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
    assert not (tmp_path / "out").exists()


_NO_JAX_SCRIPT = """
import sys
import numpy as np
from slam_tpu_torch.config import BundleConfig, FeatureConfig, \\
    KeyframeConfig, LoopConfig, RuntimeConfig, SlamConfig
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

# the disk path: KITTI layout, native runtime, prefetcher, stage cache
import tempfile
from pathlib import Path
from slam_tpu_torch import runtime
from slam_tpu_torch.utils import kitti
u8 = (np.clip(L, 0, 1) * 255).astype(np.uint8)
with tempfile.TemporaryDirectory() as tmp:
    paths = kitti.write_kitti_sequence(tmp, "00", u8, u8, scene.calib,
                                       scene.T_w2c)
    lp = sorted(paths.left_dir.glob("*.png"))
    for _ in range(2):
        res = pipeline.run_pipeline(lp, lp, scene.calib, cfg, verbose=False,
                                    cache_dir=Path(tmp) / "cache",
                                    device="cpu")
    assert runtime.available() and len(res.frontend.desc[[0, 5]]) == 2

    # the CLI on the CPU from the same PNGs, with the analysis suite, and
    # every other module of this slice
    from slam_tpu_torch.__main__ import main
    cfg.save(Path(tmp) / "cfg.json")
    assert main(["--kitti-root", tmp, "--seq", "00", "--cpu", "--config",
                 str(Path(tmp) / "cfg.json"), "--out",
                 str(Path(tmp) / "cli")]) == 0
    assert (Path(tmp) / "cli" / "00" / "graphs" / "analysis.json").exists()
# the mesh and overlap modes and the TP mega-bundle
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.parallel import tp_megabundle
for kw in ({"mesh": make_mesh(2, device="cpu")},
           {"mesh": make_mesh(2, device="cpu"), "overlap": True}):
    pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False, **kw)
tp_megabundle.optimize_megabundle_pruned(
    make_mesh(2, axis="tp", device="cpu"), np.tile(np.eye(4), (3, 1, 1)),
    *tp_megabundle.partition_megabundle(
        np.ones((8, 3)) * [0, 0, 10], np.arange(16) % 3, np.arange(16) // 2,
        np.ones((16, 3)), np.ones(16), 2), scene.calib, iters=2)
# the mesh over ranks: the dry run on two gloo ranks of the CPU
from slam_tpu_torch.parallel.dryrun import dryrun_multichip
assert dryrun_multichip(2, backend="gloo", device="cpu").startswith(
    "dryrun_multichip ok: 2 devices")
import slam_tpu_torch.scale_run, slam_tpu_torch.runtime.tsan
from slam_tpu_torch.entry import entry
step, args = entry("cpu")
assert tuple(step(*args)[0].shape) == (4, 4, 4)
import slam_tpu_torch.models.db_odometry, slam_tpu_torch.models.covgraph
import slam_tpu_torch.ops.triangulation, slam_tpu_torch.convert

# the SIFT and ORB detectors and the sparse pose graph, at tiny sizes
import torch
from slam_tpu_torch.ops import orb, pg_sparse, sift
from slam_tpu_torch.models import pose_graph
imgs = torch.rand(2, 64, 96)
sift.detect_and_describe_sift_batch(imgs, max_kp=128, octaves=3)
orb.detect_and_describe_orb_batch(imgs, max_kp=128)
pg = res.pose_graph_pre_lc.copy()
pose_graph.SPARSE_NODE_THRESHOLD = 2
pg.add_edge(0, pg.num_nodes - 1, pg.Z[0], np.eye(6) * 1e-2)
assert np.isfinite(pg.optimize(iters=2)) and pg._use_sparse()
pg.gate_distances(np.array([1]), np.array([pg.num_nodes - 1]))
pg.marginal_logdets()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "slam_tpu")))
"""


def test_port_never_imports_jax():
    """The port's whole slice, on a tiny scene, in a fresh interpreter, in
    memory and from PNG files on disk (KITTI IO, the native runtime, the
    prefetcher, the stage cache, a checkpoint resume), then the CLI on the
    CPU with its analysis, the mesh and overlap modes and the TP
    mega-bundle, the dry run over two CPU ranks (parallel/ranks.py,
    parallel/dryrun.py), the single-card step of slam_tpu_torch.entry,
    the SIFT and ORB detectors and the sparse pose graph, and every other
    module imported: afterwards no
    module of JAX nor any module of the JAX package (``slam_tpu`` or
    ``slam_tpu.*``) is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


FOREIGN = ("jax", "jaxlib", "slam_tpu")


def foreign_imports(path: Path) -> list:
    """Absolute imports of JAX or of the JAX package in one source file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] in FOREIGN]
    return found


def test_port_sources_import_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or any
    module of the JAX package (``slam_tpu_torch`` is the port's own)."""
    files = sorted((REPO / "slam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"slam_tpu_torch/utils/kitti.py", "slam_tpu_torch/runtime/"
            "__init__.py", "slam_tpu_torch/parallel/pipeline.py",
            "slam_tpu_torch/__main__.py", "slam_tpu_torch/scale_run.py",
            "slam_tpu_torch/utils/analysis.py",
            "slam_tpu_torch/utils/profiling.py",
            "slam_tpu_torch/runtime/tsan.py",
            "slam_tpu_torch/models/db_odometry.py",
            "slam_tpu_torch/models/covgraph.py",
            "slam_tpu_torch/ops/triangulation.py",
            "slam_tpu_torch/ops/sift.py", "slam_tpu_torch/ops/orb.py",
            "slam_tpu_torch/ops/pg_sparse.py",
            "slam_tpu_torch/parallel/mesh.py",
            "slam_tpu_torch/parallel/sharded_ba.py",
            "slam_tpu_torch/parallel/sharded_frontend.py",
            "slam_tpu_torch/parallel/tp_megabundle.py",
            "slam_tpu_torch/parallel/stage_overlap.py",
            "slam_tpu_torch/parallel/ranks.py",
            "slam_tpu_torch/parallel/dryrun.py"} <= names
    assert [f for p in files for f in foreign_imports(p)] == []


def test_config_json_is_shared_with_jax(tmp_path):
    """Both packages' default configs serialize to the same JSON, and a
    non-default config saved by either loads in the other as equal."""
    assert SlamConfig().to_json() == jconfig.SlamConfig().to_json()
    assert [f.name for f in dataclasses.fields(SlamConfig)] == [
        f.name for f in dataclasses.fields(jconfig.SlamConfig)]
    CFG.save(tmp_path / "port.json")
    back = jconfig.SlamConfig.load(tmp_path / "port.json")
    assert back.to_json() == CFG.to_json()
    assert back.bundle == jconfig.BundleConfig(**dataclasses.asdict(
        CFG.bundle))
    jcfg = jax_config(CFG)
    jcfg.save(tmp_path / "jax.json")
    assert config.SlamConfig.load(tmp_path / "jax.json") == CFG


def test_metrics_equal_jax():
    """The port's metrics functions return the JAX package's values on
    seeded trajectories (the same numpy code)."""
    rng = np.random.default_rng(7)
    F = 120
    T_gt = np.asarray(jsynth.loop_trajectory(F, radius=25.0), np.float64)
    noise = np.eye(4) + np.pad(0.01 * rng.standard_normal((F, 3, 4)),
                               ((0, 0), (0, 1), (0, 0)))
    T_est = noise @ T_gt
    for name in ("camera_centers", "abs_location_error",
                 "rotation_error_deg", "dist_traveled"):
        args = (T_est,) if name in ("camera_centers", "dist_traveled") \
            else (T_est, T_gt)
        np.testing.assert_array_equal(getattr(metrics, name)(*args),
                                      getattr(jmetrics, name)(*args))
    for align in (False, True):
        assert metrics.ate_rmse(T_est, T_gt, align) == jmetrics.ate_rmse(
            T_est, T_gt, align)
    a, b = T_est[:, :3, 3], T_gt[:, :3, 3]
    np.testing.assert_array_equal(metrics.rigid_align_points(a, b),
                                  jmetrics.rigid_align_points(a, b))
    lengths = (10, 40)
    assert metrics.relative_subsequence_error(T_est, T_gt, lengths) == \
        jmetrics.relative_subsequence_error(T_est, T_gt, lengths)
    curves = metrics.relative_subsequence_curves(T_est, T_gt, lengths)
    jcurves = jmetrics.relative_subsequence_curves(T_est, T_gt, lengths)
    for L in lengths:
        for k in ("x", "trans_m_per_m", "rot_deg_per_m"):
            np.testing.assert_array_equal(curves[L][k], jcurves[L][k])
    assert metrics.trajectory_summary(T_est, T_gt) == \
        jmetrics.trajectory_summary(T_est, T_gt)
