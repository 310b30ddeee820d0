"""The TP mega-bundle (parallel/tp_megabundle.py) against the JAX package
on its 8-device CPU mesh, against the port's dense single-window solver,
and the two places where the port departs from the JAX package's TP
re-solve on purpose (ROADMAP.md queue C): covariances at the optimized
landmarks, and the dense window's depth gate.

One seeded numpy problem (``utils.synthetic.megaproblem``, the JAX test's
construction) feeds both packages: P = 8 poses 0.9 m apart, L = 520
landmarks (not a multiple of 8, so the last shard's padding must stay
inert) seen 5 times each by random cameras, 0.3 px noise, the initial
state perturbed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import tp_megabundle as jtp
from slam_tpu_torch.ops import ba
from slam_tpu_torch.parallel import tp_megabundle as tp
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)
# no depth gate, Huber off: the pruned solve is then the plain LM
NO_GATE = dict(prune_rounds=1, min_depth=-1e9, max_depth=1e9,
               huber_delta=0.0)


def make_problem(seed):
    """utils.synthetic.megaproblem at the JAX test's size: (poses_gt,
    points_gt, poses0, points0, cam_idx, lm_idx, meas, w)."""
    return synthetic.megaproblem(CALIB, 8, 520, 5, seed)


def pose_err(A, B):
    """Largest norm of log(A_p^-1 B_p) over the poses."""
    return synthetic.twist_err(A, B)


@pytest.fixture(scope="module")
def problem():
    return make_problem(1)


@pytest.fixture(scope="module")
def jax_tp(problem):
    """The JAX package's TP solve on 8 virtual devices, and its
    covariances at the INITIAL landmarks, as its overflow re-solve
    evaluates them (slam_tpu/models/bundle.py:605-608)."""
    _, _, poses0, points0, ci, li, meas, w = problem
    mesh = jmesh.make_mesh(8, axis="tp")
    parts = jtp.partition_megabundle(points0, ci, li, meas, w, 8)
    poses, X, cost, cost0 = jtp.optimize_megabundle(
        mesh, poses0, *parts, jnp.asarray(CALIB), iters=20, engine="onehot")
    cov0 = jtp.megabundle_pose_covariances(mesh, poses, *parts,
                                           jnp.asarray(CALIB))
    return np.asarray(poses), np.asarray(X), cost, cost0, np.asarray(cov0)


@pytest.fixture(scope="module")
def port_tp(problem):
    """The port's TP solve on 8 shards (no gate, Huber off) and its
    covariances at the optimized landmarks."""
    _, _, poses0, points0, ci, li, meas, w = problem
    mesh = make_mesh(8, axis="tp", device="cpu")
    parts = tp.partition_megabundle(points0, ci, li, meas, w, 8)
    poses, X_sh, w_sh, cost = tp.optimize_megabundle_pruned(
        mesh, poses0, *parts, CALIB, iters=20, **NO_GATE)
    cov = tp.megabundle_pose_covariances(mesh, poses, X_sh, parts[1],
                                         parts[2], parts[3], w_sh, CALIB)
    return poses, X_sh, w_sh, cost, cov, parts


def test_partition_equals_jax(problem):
    """partition_megabundle equals the JAX package's array for array, at 8
    shards and at 3 (unequal shards)."""
    _, _, _, points0, ci, li, meas, w = problem
    for n in (8, 3):
        ours = tp.partition_megabundle(points0, ci, li, meas, w, n)
        ref = jtp.partition_megabundle(points0, ci, li, meas, w, n)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_tp_matches_jax(problem, jax_tp, port_tp):
    """8 shards against the JAX package's optimize_megabundle on 8
    devices, 20 iterations: poses within 1e-3 (norm of the relative
    twist) and final cost within 1e-2 relative, the JAX package's own
    TP-vs-dense tolerances; the pruned solve with no gate equals the plain
    optimize_megabundle to float32 rounding (1e-5)."""
    _, _, poses0, points0, ci, li, meas, w = problem
    j_poses, j_X, j_cost, j_cost0 = jax_tp[:4]
    poses, X_sh, w_sh, cost = port_tp[:4]
    assert j_cost < 0.9 * j_cost0
    assert pose_err(poses, j_poses) < 1e-3
    assert abs(cost - j_cost) < 1e-2 * j_cost
    mesh = make_mesh(8, axis="tp", device="cpu")
    parts = tp.partition_megabundle(points0, ci, li, meas, w, 8)
    p2, X2, cost2, cost0 = tp.optimize_megabundle(mesh, poses0, *parts,
                                                  CALIB, iters=20)
    assert abs(cost0 - j_cost0) < 1e-4 * j_cost0
    assert pose_err(p2, poses) < 1e-5 and abs(cost2 - cost) < 1e-5 * cost
    np.testing.assert_array_equal(w_sh, parts[4])  # nothing pruned


def test_tp_matches_dense_window(problem, port_tp):
    """The Schur sum over the shards is exact: 8 shards against the
    port's single-window ops.ba.optimize_bundle on the uncut problem, 20
    iterations, poses within 2e-4 and cost within 1e-4 relative (the
    dense window sums in float32, the TP solve in float64), and the
    landmarks within 2e-3 m."""
    _, _, poses0, points0, ci, li, meas, w = problem
    poses, X_sh, _, cost = port_tp[:4]

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt)[None]

    d_poses, d_X, d_cost, _ = ba.optimize_bundle(
        t(poses0), t(points0), t(ci, torch.int64), t(li, torch.int64),
        t(meas), t(w), torch.as_tensor(CALIB), iters=20)
    assert pose_err(poses, d_poses[0].numpy()) < 2e-4
    assert abs(cost - float(d_cost)) < 1e-4 * float(d_cost)
    L = points0.shape[0]
    np.testing.assert_allclose(X_sh.reshape(-1, 3)[:L], d_X[0].numpy(),
                               atol=2e-3)


def test_covariances_at_optimized_landmarks(problem, jax_tp, port_tp):
    """The port's TP covariances, at the optimized landmarks, equal
    ops.ba.pose_covariances of the uncut window at the same state within
    1e-3 relative (Frobenius, per pose; the dense path adds 1e-6 I to
    Hll, the TP path 1e-8 I). The JAX package's re-solve evaluates them at
    the initial landmarks (defect 1): here at least 10x further off."""
    _, _, poses0, points0, ci, li, meas, w = problem
    poses, X_sh, w_sh, _, cov, _ = port_tp
    L = points0.shape[0]

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt)[None]

    dense = ba.pose_covariances(
        t(poses), t(X_sh.reshape(-1, 3)[:L]), t(ci, torch.int64),
        t(li, torch.int64), t(meas), t(w), torch.as_tensor(CALIB))[0].numpy()

    def rel(a, b):
        return float((np.linalg.norm(a - b, axis=(1, 2))[1:]
                      / np.linalg.norm(b, axis=(1, 2))[1:]).max())

    assert np.all(cov[0] == 0.0)
    ours = rel(cov, dense)
    theirs = rel(jax_tp[4], dense)
    print(f"TP covariances vs the dense window: at the optimized landmarks "
          f"{ours:.3e}, at the initial landmarks (JAX) {theirs:.3e}")
    assert ours < 1e-3
    assert theirs > 10 * max(ours, 1e-4)
    for c in cov[1:]:
        assert np.linalg.eigvalsh(c.astype(np.float64)).min() > 0


def test_landmark_behind_camera_is_pruned(problem):
    """Three landmarks 5 m behind the cameras, each with 5 outlier
    measurements: the port's TP solve prunes all 15 observations at the
    window's min_depth, as a dense window does, and keeps the poses within
    2e-3 of the clean solve; the JAX package's TP solve has no gate
    (defect 2) and its poses are pulled further from the clean solve."""
    poses_gt, _, poses0, points0, ci, li, meas, w = problem
    rng = np.random.default_rng(7)
    L = points0.shape[0]
    bad = np.array([[1.0, 0.5, -5.0], [-2.0, 0.0, -5.0], [0.0, -1.0, -6.0]],
                   np.float32)
    pts = np.concatenate([points0, bad])
    li2 = np.concatenate([li, np.repeat(np.arange(L, L + 3), 5)]).astype(
        np.int32)
    ci2 = np.concatenate([ci, rng.integers(0, 8, 15)]).astype(np.int32)
    m_bad = np.stack([rng.uniform(0, 1241, 15), rng.uniform(0, 1241, 15),
                      rng.uniform(0, 376, 15)], -1).astype(np.float32)
    m_bad[:, 1] = m_bad[:, 0] - rng.uniform(1, 40, 15)
    meas2 = np.concatenate([meas, m_bad])
    w2 = np.concatenate([w, np.ones(15, np.float32)])

    mesh = make_mesh(8, axis="tp", device="cpu")
    clean = tp.optimize_megabundle_pruned(
        mesh, poses0, *tp.partition_megabundle(points0, ci, li, meas, w, 8),
        CALIB, iters=20)
    parts = tp.partition_megabundle(pts, ci2, li2, meas2, w2, 8)
    poses, X_sh, w_sh, _ = tp.optimize_megabundle_pruned(
        mesh, poses0, *parts, CALIB, iters=20)
    assert float(parts[4].sum() - w_sh.sum()) == 15.0
    assert pose_err(poses, clean[0]) < 2e-3

    jparts = jtp.partition_megabundle(pts, ci2, li2, meas2, w2, 8)
    j_poses = np.asarray(jtp.optimize_megabundle(
        jmesh.make_mesh(8, axis="tp"), poses0, *jparts, jnp.asarray(CALIB),
        iters=20, engine="onehot")[0])
    print(f"pose error vs the clean solve: port "
          f"{pose_err(poses, clean[0]):.3e}, JAX "
          f"{pose_err(j_poses, clean[0]):.3e}")
    assert pose_err(j_poses, clean[0]) > 5 * pose_err(poses, clean[0])


@pytest.mark.parametrize("axis, n_parts, match", [
    ("tp", 8, "partitioned for 8"), ("dp", 4, "has no axis")])
def test_mesh_axis_mismatch_raises(problem, axis, n_parts, match):
    """A mesh whose axis does not match the partition raises ValueError
    in the solve and in the covariances, as in the JAX package."""
    _, _, poses0, points0, ci, li, meas, w = problem
    mesh = make_mesh(4, axis=axis, device="cpu")
    parts = tp.partition_megabundle(points0, ci, li, meas, w, n_parts)
    with pytest.raises(ValueError, match=match):
        tp.optimize_megabundle(mesh, poses0, *parts, CALIB, iters=1)
    with pytest.raises(ValueError, match=match):
        tp.optimize_megabundle_pruned(mesh, poses0, *parts, CALIB, iters=1)
    with pytest.raises(ValueError, match="incompatible"):
        tp.megabundle_pose_covariances(mesh, poses0, *parts, CALIB)
