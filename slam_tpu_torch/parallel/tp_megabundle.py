"""Landmark-sharded (sharded-Schur) bundle adjustment of one large window.

Counterpart of ``slam_tpu/parallel/tp_megabundle.py``. A window too large
for the dense batch's static capacities (a capacity-overflowed BA window,
or a mega-bundle with tens of thousands of landmarks) is solved with its
landmarks, and with them all their observations, sharded over the mesh.
The Schur complement is a sum over landmarks:

    S  = Hpp + lam I - sum_l  W_l (Hll_l + lam I)^-1 W_l^T
    g^ = g_p         - sum_l  W_l (Hll_l + lam I)^-1 g_l

so each shard builds its landmark blocks and its partial pose terms, and
one sum over the shards gives the (6P, 6P) reduced system. The JAX
package makes that sum a ``psum`` across devices. Here a rank's shards
are the batch axis on its device: each rank uploads only its own shards,
builds their blocks (``ops.ba._linearize`` / ``_build_blocks``, index
gathers and ``index_add_``; the poses replicated to every shard) and its
partial sums (Hpp and g_p summed over its shards, and one Schur product
over its shards' landmarks side by side), and one ``mesh.all_sum`` of
the four gives every rank the same system (with one rank, the sum over
its shards alone). The landmarks are disjoint, so Hll is damped per
shard, while the pose block is damped once, after the sum, and the gauge
on pose 0 goes on after it too. Every rank solves that system by
``ops.ba._spd_solve``, kernel B6 at (1, 6P, 6P) on the card (the JAX
package's replicated ``out_specs=P()``), which keeps the ranks in
lockstep with no broadcast. LM accepts on the cost summed the same way,
with the dense LM's rule (lam / 3 or lam * 4 within [1e-9, 1e6]), so
every rank accepts alike. The landmarks and weights come back to the
host through ``mesh.host_gather``.

The residuals, the shard blocks, their sum and the cost are formed in
float64 from the float32 state; only the reduced system goes to B6 in
float32, and the step comes back to float32. A mega-bundle sums 10^5 to
10^6 observations into a Schur complement that cancels heavily: in
float32 that sum's rounding, which on the card changes with the order of
``index_add_``'s atomics, leaves LM stalled at a different point of the
flat optimum from run to run and from one shard count to another. In
float64 only the float32 solve's error is left, and the LM's fixed point
(where the float64 gradient vanishes) does not depend on it.

Unlike the JAX package, there are no one-hot contractions (its (M_loc,
L_loc) one-hot alone would be gigabytes at 100k observations per shard)
and no bf16 engines. ``optimize_megabundle_pruned`` gates depth and
weights by Huber as ``ops.ba.optimize_bundle_pruned`` does for a dense
window; the JAX package's TP re-solve does neither (ROADMAP.md queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba, se3
from .mesh import Mesh, all_sum, host_gather


def partition_megabundle(points, cam_idx, lm_idx, meas, w, n_dev,
                         pad_to: int = 128):
    """Host-side observation partitioning: landmarks in contiguous blocks
    over ``n_dev`` shards, every observation routed to its landmark's
    shard with ``lm_idx`` made local. Returns (points_sh (n_dev, L_loc,
    3), cam_sh (n_dev, M_loc), lm_sh, meas_sh (n_dev, M_loc, 3), w_sh
    (n_dev, M_loc)), M_loc a multiple of ``pad_to``; padded lanes carry
    w = 0."""
    points = np.asarray(points, np.float32)
    cam_idx = np.asarray(cam_idx)
    lm_idx = np.asarray(lm_idx)
    meas = np.asarray(meas, np.float32)
    w = np.asarray(w, np.float32)
    L = points.shape[0]
    L_loc = (L + n_dev - 1) // n_dev
    pts_sh = np.zeros((n_dev, L_loc, 3), np.float32)
    pts_sh.reshape(-1, 3)[:L] = points
    shard_of = lm_idx // L_loc
    counts = np.bincount(shard_of, minlength=n_dev)
    M_loc = int(-(-counts.max() // pad_to) * pad_to)
    cam_sh = np.zeros((n_dev, M_loc), np.int32)
    lm_sh = np.zeros((n_dev, M_loc), np.int32)
    meas_sh = np.zeros((n_dev, M_loc, 3), np.float32)
    w_sh = np.zeros((n_dev, M_loc), np.float32)
    for d in range(n_dev):
        sel = shard_of == d
        n = int(sel.sum())
        cam_sh[d, :n] = cam_idx[sel]
        lm_sh[d, :n] = lm_idx[sel] - d * L_loc
        meas_sh[d, :n] = meas[sel]
        w_sh[d, :n] = w[sel]
    return pts_sh, cam_sh, lm_sh, meas_sh, w_sh


def _check_mesh(mesh: Mesh, axis: str, n_dev: int) -> None:
    """The partition must match the mesh's axis (the JAX package's
    shard_map would otherwise solve shard 0 alone)."""
    if axis not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {axis!r} (available: {list(mesh.shape)})")
    if mesh.shape[axis] != n_dev:
        raise ValueError(
            f"mesh axis {axis!r} has {mesh.shape[axis]} devices but the "
            f"problem was partitioned for {n_dev} "
            f"(partition_megabundle(n_dev=...) must match the mesh)")


def _to_device(mesh: Mesh, poses, points_sh, cam_sh, lm_sh, meas_sh, w_sh):
    """This rank's part of the problem as tensors on its device: poses
    (1, P, 4, 4), its shards of the shard arrays with the shard axis
    leading, indices int64."""
    dev, mine = mesh.device, mesh.local_shards

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    points_sh, cam_sh, lm_sh, meas_sh, w_sh = (
        np.asarray(a)[mine] for a in (points_sh, cam_sh, lm_sh, meas_sh,
                                      w_sh))
    return (f32(poses)[None], f32(points_sh), i64(cam_sh), i64(lm_sh),
            f32(meas_sh), f32(w_sh))


def _replicated(poses, n_sh):
    """The (1, P, 4, 4) poses as every shard's (n_sh, P, 4, 4)."""
    return poses.expand(n_sh, -1, -1, -1)


def _f64(poses, X, meas, w, calib):
    """The float32 state and data as float64 (module docstring)."""
    return (poses.double(), X.double(), meas.double(), w.double(),
            calib.double())


def _summed_cost(mesh, poses, X, cam, lm, meas, w, calib):
    """Half squared error summed over the mesh's shards, in float64: a (1,)
    tensor, the same on every rank."""
    poses, X, meas, w, calib = _f64(poses, X, meas, w, calib)
    T, Xo = ba._gather_obs(_replicated(poses, X.shape[0]), X, cam, lm)
    r, _ = ba._residuals_tx(T, Xo, meas, w, calib)
    return all_sum(mesh, 0.5 * torch.sum(r * r)[None])


def _shard_blocks(poses, X, cam, lm, meas, w, calib, huber_delta=0.0):
    """``ops.ba._build_blocks`` of every shard, in float64, at the float32
    state poses (1, P, 4, 4), X (n_sh, L_loc, 3)."""
    poses, X, meas, w, calib = _f64(poses, X, meas, w, calib)
    J_pose, J_lm, r = ba._linearize(_replicated(poses, X.shape[0]), X, cam,
                                    lm, meas, w, calib, huber_delta)
    return ba._build_blocks(J_pose, J_lm, r, cam, lm, poses.shape[1],
                            X.shape[1])


def _summed_system(mesh, blocks, lam):
    """The reduced system of this rank's shard blocks from
    ``ops.ba._build_blocks`` (shard axis leading), summed over the mesh:
    (S (1, 6P, 6P), ghat (1, 6P), Bm, Hll_inv, g_l), the last three this
    rank's, with its shards' landmarks side by side. lam (1,): Hll damped
    per landmark; the pose block once, after the sum. One ``all_sum`` of
    Hpp, g_p and the Schur partials."""
    g_p, g_l, Hpp, Hll, Wc = blocks
    n_sh, L_loc, P = Wc.shape[:3]
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    Hll_inv = ba._inv3x3(Hll + lam * eye3 + 1e-8 * eye3).reshape(
        1, n_sh * L_loc, 3, 3)
    g_l = g_l.reshape(1, n_sh * L_loc, 3)
    U, Ag, Bm = ba._schur_terms(
        Hll_inv, Wc.reshape(1, n_sh * L_loc, P, 6, 3), g_l)
    Hpp, g_p, U, Ag = all_sum(mesh, Hpp, g_p, U, Ag)
    S, ghat = ba._pose_system(Hpp + lam * eye6, g_p, U, Ag)
    return S, ghat, Bm, Hll_inv, g_l


def _lm(mesh, poses, X, cam, lm, meas, w, calib, iters, lam0, huber_delta):
    """LM on the sharded problem; poses (1, P, 4, 4), X (n_sh, L_loc, 3)
    this rank's shards. Returns (poses, X, cost (1,))."""
    P = poses.shape[1]
    cost = _summed_cost(mesh, poses, X, cam, lm, meas, w, calib)
    lam = torch.full((1,), lam0, dtype=torch.float64, device=X.device)
    for _ in range(iters):
        blocks = _shard_blocks(poses, X, cam, lm, meas, w, calib,
                               huber_delta)
        S, ghat, Bm, Hll_inv, g_l = _summed_system(mesh, blocks, lam)
        dp = -ba._spd_solve(S.float(), ghat.float()).double()
        dl = ba._back_substitute(dp, Bm, Hll_inv, g_l).reshape(X.shape)
        new_poses = se3.retract(poses, dp.reshape(1, P, 6).float())
        new_X = X + dl.float()
        new_cost = _summed_cost(mesh, new_poses, new_X, cam, lm, meas, w,
                                calib)
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        poses = torch.where(ok, new_poses, poses)
        X = torch.where(ok, new_X, X)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(ok, new_cost, cost)
    return poses, X, cost


def optimize_megabundle(mesh: Mesh, poses0, points_sh, cam_sh, lm_sh,
                        meas_sh, w_sh, calib, iters: int = 20,
                        lam0: float = 1e-4, axis: str = "tp"):
    """LM on one bundle whose landmarks and observations are sharded over
    ``axis``, each rank's shards on its device. Inputs are the outputs of
    :func:`partition_megabundle`, the same on every rank. Returns
    (poses (P, 4, 4), points (n_dev * L_loc, 3), cost, cost0) on the
    host, the same on every rank."""
    _check_mesh(mesh, axis, np.shape(points_sh)[0])
    poses, X, cam, lm, meas, w = _to_device(mesh, poses0, points_sh, cam_sh,
                                            lm_sh, meas_sh, w_sh)
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=mesh.device)
    cost0 = _summed_cost(mesh, poses, X, cam, lm, meas, w, calib_t)
    poses, X, cost = _lm(mesh, poses, X, cam, lm, meas, w, calib_t, iters,
                         lam0, 0.0)
    X = host_gather(mesh, X.cpu().numpy())
    return (poses[0].cpu().numpy(), X.reshape(-1, 3), float(cost),
            float(cost0))


def optimize_megabundle_pruned(mesh: Mesh, poses0, points_sh, cam_sh, lm_sh,
                               meas_sh, w_sh, calib, iters: int = 20,
                               prune_rounds: int = 2, min_depth: float = 0.1,
                               max_depth: float = 1000.0,
                               huber_delta: float = 0.0, axis: str = "tp"):
    """:func:`optimize_megabundle` with the dense window's depth gate
    (``ops.ba.optimize_bundle_pruned``): prune, optimize, repeat
    ``prune_rounds`` times, prune again; each round's LM restarts at
    lam0 = 1e-4. A landmark behind ``min_depth`` or beyond ``max_depth``
    in any observing camera loses all its observations (within its shard,
    which holds all of them). Returns (poses (P, 4, 4), points_sh
    (n_dev, L_loc, 3), w_sh (n_dev, M_loc), cost) on the host, the same on
    every rank, the middle two in the shard layout, ready for
    :func:`megabundle_pose_covariances`."""
    _check_mesh(mesh, axis, np.shape(points_sh)[0])
    poses, X, cam, lm, meas, w = _to_device(mesh, poses0, points_sh, cam_sh,
                                            lm_sh, meas_sh, w_sh)
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=mesh.device)
    n_sh = X.shape[0]
    for _ in range(prune_rounds):
        w = ba.prune_depth_weights(_replicated(poses, n_sh), X, cam, lm, w,
                                   min_depth, max_depth)
        poses, X, _ = _lm(mesh, poses, X, cam, lm, meas, w, calib_t, iters,
                          1e-4, huber_delta)
    w = ba.prune_depth_weights(_replicated(poses, n_sh), X, cam, lm, w,
                               min_depth, max_depth)
    cost = _summed_cost(mesh, poses, X, cam, lm, meas, w, calib_t)
    X, w = host_gather(mesh, (X.cpu().numpy(), w.cpu().numpy()))
    return poses[0].cpu().numpy(), X, w, float(cost)


def megabundle_pose_covariances(mesh: Mesh, poses, points_sh, cam_sh, lm_sh,
                                meas_sh, w_sh, calib, axis: str = "tp"):
    """(P, 6, 6) marginal pose covariances of a converged mega-bundle, as
    ``ops.ba.pose_covariances`` gives them for a dense window (the
    inverse undamped Gauss-Newton Schur complement, pose 0 gauge-fixed:
    its block zero), with the landmark sum over the shards (one
    ``all_sum``); every rank inverts the same system. Hll gets 1e-8 I as
    in the JAX package's TP path (the dense path adds 1e-6)."""
    n_dev = np.shape(points_sh)[0]
    if axis not in mesh.shape or mesh.shape[axis] != n_dev:
        raise ValueError(
            f"mesh axis {axis!r} incompatible with partitioning "
            f"({mesh.shape} vs n_dev={n_dev})")
    poses, X, cam, lm, meas, w = _to_device(mesh, poses, points_sh, cam_sh,
                                            lm_sh, meas_sh, w_sh)
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=mesh.device)
    P = poses.shape[1]
    blocks = _shard_blocks(poses, X, cam, lm, meas, w, calib_t)
    S = _summed_system(mesh, blocks, torch.zeros(1, dtype=torch.float64,
                                                 device=X.device))[0]
    S = S + 1e-8 * torch.eye(P * 6, dtype=S.dtype, device=S.device)
    cov = torch.linalg.inv_ex(S)[0].reshape(P, 6, P, 6)
    d = torch.arange(P, device=S.device)
    out = cov[d, :, d, :]
    out = 0.5 * (out + out.transpose(-1, -2))
    mask = ba._gauge_mask(P, S.dtype, S.device).reshape(P, 6)
    return (out * mask[:, :, None]).float().cpu().numpy()
