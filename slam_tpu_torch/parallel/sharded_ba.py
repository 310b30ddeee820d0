"""Bundle adjustment of every keyframe window in one batch over a mesh.

Counterpart of ``slam_tpu/parallel/sharded_ba.py``. All windows of a
sequence are one padded batch; the JAX package shards its window axis
over the mesh, and each device LM-optimizes its shard with one compiled
program. Here the mesh's shards share one device, so a mesh is a batch
size: ``models.bundle.optimize_windows(mesh=...)`` runs every window as
one slice padded to a multiple of ``mesh.size``, through the step its
``device_batch`` slices use (``models.bundle.window_step``), each LM
iteration's reduced systems solved by kernel B6 at (B_pad, 6P, 6P) on
the card. The JAX package's entry points below are thin calls into it.

The dense cross blocks dominate the batch's memory: B_pad x 512 x 24 x
18 floats per iteration at the default capacities, ~0.58 GB at KITTI
00's 651 windows, and the Schur products as much again each.
"""

from __future__ import annotations

from ..config import BundleConfig
from ..models import bundle
from .mesh import Mesh


def ba_training_step(mesh: Mesh, calib, iters: int = 20,
                     min_depth: float = 0.1, max_depth: float = 1000.0,
                     huber_delta: float = 0.0):
    """The batched BA step on the mesh's device
    (``models.bundle.window_step``): fn(poses0, points0, cam_idx, lm_idx,
    meas, w, n_poses) -> (poses, points, w, cost, cost0, rel_T, rel_cov),
    host numpy in (the window axis leading, padded to a multiple of
    ``mesh.size`` by ``models.bundle.window_inputs``), device tensors out,
    launched without waiting for the device."""
    return bundle.window_step(calib, mesh.device, iters=iters,
                              min_depth=min_depth, max_depth=max_depth,
                              huber_delta=huber_delta)


def optimize_windows_sharded(batch, calib, mesh: Mesh, iters: int = 20,
                             min_depth: float = 0.1,
                             max_depth: float = 1000.0,
                             huber_delta: float = 0.0):
    """Every window of a BundleBatch in one batched BA step on the mesh.
    Returns host arrays (poses, points, w, cost, cost0, rel_T, rel_cov),
    the window axis cut back to the batch's."""
    res = bundle.optimize_windows(
        batch, calib, BundleConfig(lm_iters=iters, min_depth=min_depth,
                                   max_depth=max_depth,
                                   huber_delta_px=huber_delta), mesh=mesh)
    return (res.poses, res.points, res.w, res.cost, res.cost0, res.rel_T,
            res.rel_cov)
