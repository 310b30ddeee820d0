"""The multi-device dry run over ranks: the window BA, the TP mega-bundle
and the frame-sharded frontend on a mesh of one rank per device.

Counterpart of ``__graft_entry__.dryrun_multichip``, with its own copy of
that dry run's three checks, inputs and thresholds:

  1. the window BA, 2 windows per rank (4 poses, 32 landmarks, 128
     observations each) from a perturbed start, 10 LM iterations: every
     window's cost below 0.25 of its initial cost, the mean pose error
     below 0.25 of its starting value;
  2. the TP mega-bundle, L = 8n + 3 landmarks (so that the partition's
     padding must stay inert) seen 5 times each, 10 iterations: cost below
     0.25 of the initial cost, every pose within 0.05 m;
  3. two chained frontend steps (one frame per rank each) on a rendered
     128x256 scene: more than 100 stereo links, every camera centre
     within 0.5 m.

The scene is the port's own (``utils.synthetic``), not the JAX package's:
the two draw different worlds from one seed. Rank 0 prints the JAX line's
format, ``dryrun_multichip ok: n devices, ...``.

    python -m slam_tpu_torch.parallel.dryrun --ranks 4 --backend nccl
    python -m slam_tpu_torch.parallel.dryrun --ranks 4 --backend gloo --cpu
    torchrun --nproc-per-node 4 -m slam_tpu_torch.parallel.dryrun \\
        --backend nccl

The first two start the ranks through ``parallel.ranks.spawn``; under
torchrun each process is one rank.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch.distributed as dist

from . import ranks


def _so3_exp_np(wv):
    th = np.linalg.norm(wv)
    Wx = np.array([[0, -wv[2], wv[1]], [wv[2], 0, -wv[0]],
                   [-wv[1], wv[0], 0]], np.float64)
    if th < 1e-12:
        return np.eye(3) + Wx
    return (np.eye(3) + np.sin(th) / th * Wx
            + (1 - np.cos(th)) / th**2 * (Wx @ Wx))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, backend: str = "nccl", device="cuda",
                     timeout: float = 600.0) -> str:
    """The dry run on ``n_devices`` ranks: in a rank of a process group of
    that many, run the three checks (module docstring) and return the
    line; in a process with no group, start that many ranks on
    ``device`` over ``backend`` (``parallel.ranks.spawn``, one torch
    thread each, all within ``timeout`` seconds) and return rank 0's
    line. Raises if a check fails."""
    if not dist.is_initialized():
        return ranks.spawn(_rank, n_devices, backend, device,
                           args=(n_devices, backend, device),
                           timeout=timeout, threads=1)[0]
    from ..config import (FeatureConfig, KeyframeConfig, RansacConfig,
                          RuntimeConfig, SlamConfig)
    from ..models.bundle import BundleBatch
    from ..utils import metrics, synthetic
    from .mesh import make_mesh
    from .sharded_ba import optimize_windows_sharded
    from .sharded_frontend import run_frontend_sharded
    from .tp_megabundle import optimize_megabundle, partition_megabundle

    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a process group "
                         f"of {world} ranks")
    mesh = make_mesh(device=device)

    # ---- the window BA: 2 windows per rank, from a perturbed start -------
    B = n_devices * 2
    Pn, L, M = 4, 32, 128
    rng = np.random.default_rng(0)
    calib = np.array([700.0, 700.0, 320.0, 180.0, 0.54], np.float32)
    poses_gt = np.tile(np.eye(4, dtype=np.float32), (B, Pn, 1, 1))
    for p in range(Pn):
        poses_gt[:, p, 2, 3] = -0.5 * p
    points_gt = rng.uniform(-5, 5, (B, L, 3)).astype(np.float32)
    points_gt[..., 2] = rng.uniform(8, 30, (B, L)).astype(np.float32)
    cam_idx = np.tile(np.repeat(np.arange(Pn, dtype=np.int32), L)[None],
                      (B, 1))
    lm_idx = np.tile(np.tile(np.arange(L, dtype=np.int32), Pn)[None], (B, 1))
    fx, fy, cx, cy, bl = calib
    meas = np.zeros((B, M, 3), np.float32)
    for b in range(B):
        T = poses_gt[b][cam_idx[b]]
        X = points_gt[b][lm_idx[b]]
        Xc = np.einsum("mij,mj->mi", T[:, :3, :3], X) + T[:, :3, 3]
        z = np.maximum(Xc[:, 2], 1e-3)
        meas[b, :, 0] = fx * Xc[:, 0] / z + cx
        meas[b, :, 1] = fx * (Xc[:, 0] - bl) / z + cx
        meas[b, :, 2] = fy * Xc[:, 1] / z + cy
    meas += 0.2 * rng.standard_normal(meas.shape).astype(np.float32)
    poses0 = poses_gt.copy()
    for b in range(B):
        for p in range(1, Pn):
            dR = _so3_exp_np(0.01 * rng.standard_normal(3))
            poses0[b, p, :3, :3] = (dR @ poses_gt[b, p, :3, :3].astype(
                np.float64)).astype(np.float32)
            poses0[b, p, :3, 3] += 0.05 * rng.standard_normal(3).astype(
                np.float32)
    points0 = points_gt + 0.15 * rng.standard_normal(
        points_gt.shape).astype(np.float32)
    batch = BundleBatch(
        poses0=poses0, points0=points0, cam_idx=cam_idx, lm_idx=lm_idx,
        meas=meas, w=np.ones((B, M), np.float32),
        n_poses=np.full(B, Pn, np.int32),
        frames=np.tile(np.arange(Pn), (B, 1)),
        track_of_lm=np.tile(np.arange(L), (B, 1)),
        keyframes=list(range(B + 1)))
    poses, _, _, cost, cost0, _, _ = optimize_windows_sharded(
        batch, calib, mesh, iters=10)
    _check(np.isfinite(cost).all() and (cost0 > 1.0).all()
           and (cost < 0.25 * cost0).all(), f"BA cost {cost} from {cost0}")
    err_before = np.linalg.norm((poses0 - poses_gt)[:, 1:, :3, 3],
                                axis=-1).mean()
    err_after = np.linalg.norm((poses - poses_gt)[:, 1:, :3, 3],
                               axis=-1).mean()
    _check(err_after < 0.25 * err_before,
           f"BA pose error {err_before} -> {err_after}")

    # ---- the TP mega-bundle: one bundle, landmarks over the ranks --------
    tp_mesh = make_mesh(axis="tp", device=device)
    Ltp, Otp = 8 * n_devices + 3, 5
    lm_tp = np.repeat(np.arange(Ltp), Otp)
    cam_tp = rng.integers(0, Pn, lm_tp.shape[0])
    X_gt = np.stack([rng.uniform(-6, 6, Ltp), rng.uniform(-2, 2, Ltp),
                     rng.uniform(8, 30, Ltp)], axis=-1).astype(np.float32)
    T_tp = poses_gt[0][cam_tp]
    Xc_tp = np.einsum("mij,mj->mi", T_tp[:, :3, :3], X_gt[lm_tp]) \
        + T_tp[:, :3, 3]
    z_tp = np.maximum(Xc_tp[:, 2], 1e-3)
    meas_tp = np.stack([fx * Xc_tp[:, 0] / z_tp + cx,
                        fx * (Xc_tp[:, 0] - bl) / z_tp + cx,
                        fy * Xc_tp[:, 1] / z_tp + cy],
                       axis=-1).astype(np.float32)
    meas_tp += 0.2 * rng.standard_normal(meas_tp.shape).astype(np.float32)
    parts = partition_megabundle(
        X_gt + 0.15 * rng.standard_normal(X_gt.shape).astype(np.float32),
        cam_tp, lm_tp, meas_tp, np.ones(lm_tp.shape[0], np.float32),
        n_devices, pad_to=8)
    tp_poses, _, tp_cost, tp_cost0 = optimize_megabundle(
        tp_mesh, poses0[0], *parts, calib, iters=10)
    _check(tp_cost0 > 1.0 and tp_cost < 0.25 * tp_cost0,
           f"TP cost {tp_cost0} -> {tp_cost}")
    tp_err = np.linalg.norm((tp_poses - poses_gt[0])[1:, :3, 3],
                            axis=-1).max()
    _check(tp_err < 0.05, f"TP pose error {tp_err}")

    # ---- the frame-sharded frontend: two chained steps --------------------
    cfg = SlamConfig(
        features=FeatureConfig(max_kp=384, border=8),
        ransac=RansacConfig(num_hypotheses=128),
        runtime=RuntimeConfig(chunk_frames=1),
        keyframes=KeyframeConfig(min_gap=2, max_gap=5, max_dist_m=5.0))
    Ff = 2 * n_devices
    scene = synthetic.make_scene(13, num_frames=Ff, num_landmarks=1500,
                                 hw=(128, 256), step_m=0.8)
    Li, Ri = synthetic.render_sequence(scene)
    res = run_frontend_sharded(Li, Ri, scene.calib, mesh, cfg)
    n_links = int(res.link_valid.sum())
    _check(n_links > 100, f"frontend links {n_links}")
    _check(np.isfinite(res.T_w2c).all(), "frontend poses not finite")
    traj_err = float(np.linalg.norm(
        metrics.camera_centers(res.T_w2c)
        - metrics.camera_centers(scene.T_w2c), axis=-1).max())
    _check(traj_err < 0.5, f"frontend trajectory error {traj_err} m")
    line = (f"dryrun_multichip ok: {n_devices} devices, "
            f"BA cost0 {cost0[:4].round(2).tolist()} -> "
            f"cost {cost[:4].round(2).tolist()}, "
            f"pose err {err_before:.4f} -> {err_after:.4f} m, "
            f"TP mega-bundle cost {tp_cost0:.1f} -> {tp_cost:.1f} "
            f"(pose err {tp_err:.4f} m), "
            f"sharded frontend links {n_links}, "
            f"traj err {traj_err:.4f} m over {Ff} frames")
    if mesh.rank == 0:
        print(line, flush=True)
    return line


def _rank(n_devices: int, backend: str, device) -> str:
    """One spawned rank of :func:`dryrun_multichip`."""
    return dryrun_multichip(n_devices, backend, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (one per card under nccl); under "
                         "torchrun, its world size")
    ap.add_argument("--backend", choices=ranks.BACKENDS, required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (gloo), the kernels' plain versions")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        ranks.init_rank(args.backend, device)
        try:
            dryrun_multichip(dist.get_world_size(), args.backend, device)
        finally:
            dist.destroy_process_group()
        return 0
    if args.ranks is None:
        ap.error("--ranks is required outside torchrun")
    dryrun_multichip(args.ranks, args.backend, device, timeout=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
