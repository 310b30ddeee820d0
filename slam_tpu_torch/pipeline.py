"""End-to-end SLAM pipeline: the stages in order, and their evaluation.

Counterpart of ``slam_tpu/pipeline.py``. Stages:

  1. frontend odometry  -> FrontendResult    (models/frontend.py)
  2. track store        -> TrackStore        (models/trackstore.py)
  3. windowed BA        -> BundleResult      (models/bundle.py)
  4. pose graph         -> PoseGraph         (models/pose_graph.py)
  5. loop closure       -> PoseGraph + closures (models/loop_closure.py)
  6. evaluation         -> metrics dict

Images are in-memory (F, H, W) arrays, or lists of PNG paths (a KITTI
sequence on disk: ``utils.kitti.KittiPaths``), which the frontend streams
through the native prefetcher (parallel/pipeline.py). Every device stage
runs on ``device``. With ``cache_dir`` every stage's artifact is saved
there in the JAX package's npz format and loaded instead of recomputed
while the config, the input fingerprint and every upstream stage are
unchanged; the frontend resumes from its incremental checkpoint there.

With ``mesh`` (``parallel.mesh.make_mesh``) the frontend runs in steps
of ``chunk_frames`` frames per shard, every BA window in one batch, and
capacity-overflowed windows are re-solved at full size on the TP
mega-bundle; with ``overlap`` as well, frontend and BA overlap on two
CUDA streams (parallel/stage_overlap.py), timed as one stage,
``frontend+bundles_overlapped``. Both need in-memory images, and neither
reuses cached artifacts of the stages it runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .config import SlamConfig
from .models import bundle as bundle_mod
from .models import frontend as frontend_mod
from .models import loop_closure as lc_mod
from .models.pose_graph import PoseGraph
from .models.trackstore import TrackStore
from .parallel.mesh import stage_device
from .utils import metrics


@dataclass
class PipelineResult:
    frontend: frontend_mod.FrontendResult
    db: TrackStore
    bundles: bundle_mod.BundleResult
    pose_graph: PoseGraph          # after loop closure
    pose_graph_pre_lc: PoseGraph   # before loop closure
    closures: list
    timings: dict = field(default_factory=dict)
    calib: np.ndarray | None = None

    @property
    def T_frontend(self) -> np.ndarray:
        return self.frontend.T_w2c

    @property
    def T_bundled_frames(self) -> np.ndarray:
        return bundle_mod.frame_poses_from_bundles(self.bundles,
                                                   self.db.num_frames)

    def keyframe_trajectory(self, graph: PoseGraph | None = None
                            ) -> np.ndarray:
        """Keyframe extrinsics (N, 4, 4) of ``graph`` (by default the
        loop-closed pose graph)."""
        return (self.pose_graph if graph is None else graph).nodes


def input_fingerprint(images_left, images_right) -> str:
    """The stage cache's input key: the frame count and a sha256 over the
    first and last images, or, for path lists, over the paths and the
    (size, mtime_ns) of the first and last files of each side (a dataset
    rewritten under the same names must not be served stale artifacts)."""
    h = hashlib.sha256()
    if isinstance(images_left, (list, tuple)):
        h.update("\n".join(map(str, images_left)).encode())
        h.update("\n".join(map(str, images_right)).encode())
        for p in (images_left[0], images_left[-1], images_right[0],
                  images_right[-1]):
            st = os.stat(p)
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    else:
        h.update(np.asarray(images_left[0]).tobytes())
        h.update(np.asarray(images_left[-1]).tobytes())
        h.update(np.asarray(images_right[0]).tobytes())
    return json.dumps({"frames": int(len(images_left)),
                       "sha": h.hexdigest()})


def run_pipeline(images_left, images_right, calib,
                 cfg: SlamConfig = SlamConfig(), cache_dir=None,
                 run_loop_closure: bool = True, verbose: bool = True,
                 mesh=None, overlap: bool = False, image_hw=None,
                 device=None) -> PipelineResult:
    """The full pipeline on ``device``: the card by default, where the
    kernels run (raises without one); ``"cpu"`` runs their plain versions.
    With ``mesh`` every stage runs on the mesh's device.

    ``images_left`` / ``images_right`` are in-memory (F, H, W) arrays
    (uint8, or float32 in [0, 1]) or lists of PNG paths; with paths the
    frames are decoded to uint8 and edge-replicate-padded to ``image_hw``
    (by default the first image's shape); in-memory images are padded to
    ``image_hw`` when it is given. ``cache_dir`` keeps the stage
    artifacts: a stage is loaded instead of recomputed while the cached
    config and input fingerprint match and every upstream stage was
    loaded too; the frontend reuses its own checkpoint there (a complete
    one makes it a pure load)."""
    from_disk = isinstance(images_left, (list, tuple))
    if from_disk and (mesh is not None or overlap):
        raise ValueError("mesh/overlap modes require in-memory image arrays")
    device = str(stage_device(mesh, device))
    timings = {}
    log = print if verbose else (lambda *a, **k: None)

    def timed(name, fn):
        t0 = time.perf_counter()
        # a named span on the profiler's timeline (chip_smoke.py --profile)
        with torch.profiler.record_function(f"stage:{name}"):
            out = fn()
        timings[name] = time.perf_counter() - t0
        log(f"[pipeline] {name}: {timings[name]:.2f}s")
        return out

    cache = Path(cache_dir) if cache_dir is not None else None
    reuse = False
    if cache is not None:
        fingerprint = input_fingerprint(images_left, images_right)
        cache.mkdir(parents=True, exist_ok=True)
        cfg_file, fp_file = cache / "config.json", cache / "inputs.json"
        reuse = (cfg_file.exists() and cfg_file.read_text() == cfg.to_json()
                 and fp_file.exists() and fp_file.read_text() == fingerprint)
        if not reuse:
            cfg.save(cfg_file)
            fp_file.write_text(fingerprint)

    def stage(name, artifact, compute, load, save):
        """Load ``artifact`` while the reuse chain holds, else compute and
        save it (which breaks the chain for every later stage)."""
        nonlocal reuse
        if cache is not None and reuse and (cache / artifact).exists():
            out = timed(name, lambda: load(cache / artifact))
            log(f"[pipeline] {name}: loaded from cache")
            return out
        reuse = False
        out = timed(name, compute)
        if cache is not None:
            save(out, cache / artifact)
        return out

    ckpt = str(cache / "frontend_ckpt.npz") if cache is not None else None
    if mesh is not None:
        reuse = False  # the mesh stages are recomputed, and all after them
    if image_hw is not None and not from_disk:
        from .utils.kitti import pad_to_bucket  # the path mode's buckets

        images_left = pad_to_bucket(images_left, tuple(image_hw))
        images_right = pad_to_bucket(images_right, tuple(image_hw))
    if mesh is not None and overlap:
        from .parallel.stage_overlap import run_pipeline_overlapped

        fe, db, bundles = timed(
            "frontend+bundles_overlapped", lambda: run_pipeline_overlapped(
                images_left, images_right, calib, cfg, mesh=mesh))
        if cache is not None:
            db.save(cache / "trackstore.npz")
    else:
        if from_disk:
            from .parallel.pipeline import run_frontend_pipelined
            from .utils.kitti import _imread_gray

            if image_hw is None:
                image_hw = _imread_gray(Path(images_left[0])).shape
            fe = timed("frontend", lambda: run_frontend_pipelined(
                list(images_left), list(images_right), image_hw, calib, cfg,
                checkpoint_path=ckpt, resume=reuse, device=device))
        elif mesh is not None:
            from .parallel.sharded_frontend import run_frontend_sharded

            fe = timed("frontend", lambda: run_frontend_sharded(
                images_left, images_right, calib, mesh, cfg))
        else:
            fe = timed("frontend", lambda: frontend_mod.run_frontend(
                images_left, images_right, calib, cfg, device=device,
                checkpoint_path=ckpt, resume=reuse))
        db = stage("trackstore", "trackstore.npz",
                   lambda: TrackStore.from_frontend(fe), TrackStore.load,
                   lambda o, p: o.save(p))
        bundles = stage("bundles", "bundles.npz",
                        lambda: bundle_mod.run_bundles(
                            db, fe.T_w2c, calib, cfg, mesh=mesh,
                            device=device),
                        bundle_mod.load_bundles, bundle_mod.save_bundles)

    def _pg():
        g = PoseGraph.from_bundles(bundles, device=device)
        g.optimize()
        return g

    pg = stage("pose_graph", "pose_graph.npz", _pg,
               lambda p: PoseGraph.load(p, device=device),
               lambda o, p: o.save(p))
    pg_pre = pg.copy()
    closures = []
    if run_loop_closure:
        lc_file = cache / "pose_graph_lc.npz" if cache is not None else None
        cl_file = cache / "closures.npz" if cache is not None else None
        if cache is not None and reuse and lc_file.exists() \
                and cl_file.exists():
            t0 = time.perf_counter()
            pg = PoseGraph.load(lc_file, device=device)
            closures = lc_mod.load_closures(cl_file)
            timings["loop_closure"] = time.perf_counter() - t0
            log(f"[pipeline] loop_closure: loaded from cache "
                f"({timings['loop_closure']:.2f}s)")
        else:
            closures = timed("loop_closure", lambda: lc_mod.find_loops(
                pg, db, fe.desc, fe.valid, calib, cfg))
            if cache is not None:
                pg.save(lc_file)
                lc_mod.save_closures(closures, cl_file)
        log(f"[pipeline] {len(closures)} loop closures: "
            f"{[(c.frame_i, c.frame_j, c.num_inliers) for c in closures]}")
    return PipelineResult(frontend=fe, db=db, bundles=bundles,
                          pose_graph=pg, pose_graph_pre_lc=pg_pre,
                          closures=closures, timings=timings,
                          calib=np.asarray(calib, np.float32))


def evaluate(result: PipelineResult, T_gt: np.ndarray) -> dict:
    """Stage-by-stage accuracy summary against ground truth."""
    gt_kf = T_gt[result.pose_graph.keyframes]
    b = result.bundles
    out = {
        "frontend": metrics.trajectory_summary(result.T_frontend, T_gt),
        "bundles_kf": metrics.trajectory_summary(b.T_w2c_keyframes, gt_kf),
        "pose_graph_kf": metrics.trajectory_summary(
            result.pose_graph_pre_lc.nodes, gt_kf),
        "num_closures": len(result.closures),
        "num_pose_failures": result.frontend.num_pose_failures,
        "timings_s": result.timings,
        "db_stats": result.db.stats(),
        "bundle_obs_dropped": int(b.obs_dropped),
        "bundle_obs_total": int(b.obs_total),
        "bundle_obs_drop_rate": (float(b.obs_dropped / b.obs_total)
                                 if b.obs_total else 0.0),
    }
    if result.closures:
        out["pose_graph_lc_kf"] = metrics.trajectory_summary(
            result.pose_graph.nodes, gt_kf)
    return out


def save_report(path: str | Path, report: dict) -> None:
    Path(path).write_text(json.dumps(report, indent=2, default=float))
