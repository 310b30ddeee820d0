"""The benchmark's plain reference of the stereo SLAM pipeline.

A frozen copy of the modules that ``slam_tpu_torch.pipeline.run_pipeline``
runs on in-memory images (the port's semantics of the JAX package), with
everything that is not plain PyTorch or numpy taken out: the hand-written
CUDA kernels are their plain versions (``ops/cuda_kernels.py``), no
function is captured as a CUDA graph (``runtime/graphs.py``), the track
store chains in numpy, and there is no mesh, stage cache, checkpoint or
disk path: where the program's mesh re-solves a capacity-overflowed BA
window at full size, ``run(resolve_overflow=True)`` does the same by the
plain LM. It imports nothing of the program, so a change to the program
cannot change what the program is held to.

``run`` works every layer out again from the images, the calibration
and the configuration (whose seed fixes RANSAC's draws) on ``device``.
Importing the package turns the card's TF32 switches off, as the
program's does (``ops/precision.py``).
"""

from __future__ import annotations

import numpy as np

from .config import SlamConfig
from .models import bundle as bundle_mod
from .models import frontend as frontend_mod
from .models import loop_closure as lc_mod
from .models.pose_graph import PoseGraph
from .models.trackstore import TrackStore
from .ops import precision as _precision  # noqa: F401  (sets the policy)


def run(images_left, images_right, calib, cfg: SlamConfig, device,
        resolve_overflow: bool = False, stats: dict | None = None) -> dict:
    """Every layer of the pipeline on one sequence: the frontend's
    per-frame extrinsics (with its keypoints and RANSAC's inlier counts),
    the window BA's keyframes and their extrinsics,
    the pose graph's nodes before and after loop closure, and the
    closures' frame pairs. With ``resolve_overflow`` each window that
    overflows BA's capacities is re-solved at its full size, as the
    program's mesh does (``cfg.bundle.tp_overflow`` on). ``stats``, when
    given, gets the count of overflowed windows."""
    calib = np.asarray(calib, np.float32)
    fe = frontend_mod.run_frontend(images_left, images_right, calib, cfg,
                                   device=device)
    db = TrackStore.from_frontend(fe)
    bundles = bundle_mod.run_bundles(
        db, fe.T_w2c, calib, cfg, device=device,
        resolve_overflow=resolve_overflow, stats=stats)
    pg = PoseGraph.from_bundles(bundles, device=device)
    pg.optimize()
    pg_pre = pg.copy()
    closures = lc_mod.find_loops(pg, db, fe.desc, fe.valid, calib, cfg, {})
    return {"frontend": np.asarray(fe.T_w2c, np.float64),
            "inliers": np.asarray(fe.num_inliers),
            "xy": np.asarray(fe.xy), "valid": np.asarray(fe.valid),
            "keyframes": np.asarray(bundles.keyframes, np.int64),
            "bundles": np.asarray(bundles.T_w2c_keyframes, np.float64),
            "pose_graph": np.asarray(pg_pre.nodes, np.float64),
            "closures": sorted((int(c.frame_i), int(c.frame_j))
                               for c in closures),
            "loop_closed": np.asarray(pg.nodes, np.float64)}
