"""End-to-end SLAM pipeline: the stages in order, and their evaluation.

Counterpart of ``slam_tpu/pipeline.py``. Stages:

  1. frontend odometry  -> FrontendResult    (models/frontend.py)
  2. track store        -> TrackStore        (slam_tpu.models.trackstore)
  3. windowed BA        -> BundleResult      (models/bundle.py)
  4. pose graph         -> PoseGraph         (models/pose_graph.py)
  5. loop closure       -> PoseGraph + closures (models/loop_closure.py)
  6. evaluation         -> metrics dict

Images are in-memory (F, H, W) arrays; every device stage runs on
``device``. The stage cache, disk streaming, mesh and overlap modes keep
their argument names and raise ``NotImplementedError`` until they are
ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from slam_tpu.config import SlamConfig
from slam_tpu.models.trackstore import TrackStore
from slam_tpu.utils import metrics

from .models import bundle as bundle_mod
from .models import frontend as frontend_mod
from .models import loop_closure as lc_mod
from .models.pose_graph import PoseGraph
from .ops.cuda_kernels import resolve_device


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


def run_pipeline(images_left: np.ndarray, images_right: np.ndarray, calib,
                 cfg: SlamConfig = SlamConfig(), cache_dir=None,
                 run_loop_closure: bool = True, verbose: bool = True,
                 mesh=None, overlap: bool = False, image_hw=None,
                 device="cuda") -> PipelineResult:
    """The full pipeline on in-memory images, on ``device``: the card by
    default, where the kernels run (raises without one); ``"cpu"`` runs
    their plain versions."""
    if cache_dir is not None:
        raise NotImplementedError("the stage cache is still to be ported")
    if isinstance(images_left, (list, tuple)) or image_hw is not None:
        raise NotImplementedError(
            "streaming images from disk is still to be ported")
    if mesh is not None or overlap:
        raise NotImplementedError(
            "mesh and overlap modes are still to be ported")
    device = str(resolve_device(device))
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

    fe = timed("frontend", lambda: frontend_mod.run_frontend(
        images_left, images_right, calib, cfg, device=device))
    db = timed("trackstore", lambda: TrackStore.from_frontend(fe))
    bundles = timed("bundles", lambda: bundle_mod.run_bundles(
        db, fe.T_w2c, calib, cfg, device=device))

    def _pg():
        g = PoseGraph.from_bundles(bundles, device=device)
        g.optimize()
        return g

    pg = timed("pose_graph", _pg)
    pg_pre = pg.copy()
    closures = []
    if run_loop_closure:
        closures = timed("loop_closure", lambda: lc_mod.find_loops(
            pg, db, fe.desc, fe.valid, calib, cfg))
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
