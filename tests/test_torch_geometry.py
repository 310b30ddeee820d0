"""Parity of the port's small geometry modules with the JAX package's:
weighted rigid alignment and EPnP (ops/epnp.py), triangulation
(ops/triangulation.py), the PnP trajectory rebuilt from a track store
(models/db_odometry.py) and the covariance path graph
(models/covgraph.py).

The same numpy inputs, made from a seed, go through the JAX function on
the CPU and the port's on the CPU; each comparison states its tolerance.
The solvers are float32 eigen- and singular-value decompositions by
different libraries, so poses agree to ~1e-5 where the problem is well
conditioned; the tolerances below are ~10x what was observed.
"""

import types

import jax
import numpy as np
import pytest
import torch

from slam_tpu.models import covgraph as jcovgraph
from slam_tpu.models import db_odometry as jdbo
from slam_tpu.models.pose_graph import PoseGraph as JPoseGraph
from slam_tpu.ops import epnp as jepnp
from slam_tpu.ops import triangulation as jtri
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.models import covgraph, db_odometry
from slam_tpu_torch.models.pose_graph import PoseGraph
from slam_tpu_torch.ops import epnp, se3, triangulation
from slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)


def t(x):
    return torch.as_tensor(np.asarray(x))


def random_poses(rng, n, trans=2.0):
    xi = np.concatenate([rng.normal(size=(n, 3)) * 0.4,
                         rng.normal(size=(n, 3)) * trans], 1)
    return se3.se3_exp(t(xi.astype(np.float32))).numpy()


def apply(T, p):
    return p @ T[..., :3, :3].swapaxes(-1, -2) + T[..., None, :3, 3]


# ---------------------------------------------------------------------------
# rigid_align (weighted Kabsch)
# ---------------------------------------------------------------------------

def test_rigid_align_matches_jax_and_truth():
    """Batches of 16 noisy 20-point sets with random weights (some zero):
    T within 2e-4 of the JAX package's, proper rotations (det +1), and
    within 5e-3 of the true pose; ok everywhere."""
    rng = np.random.default_rng(0)
    B, N = 16, 20
    T_true = random_poses(rng, B)
    pa = rng.normal(size=(B, N, 3)).astype(np.float32) * 3
    pb = (apply(T_true, pa) + 1e-3 * rng.normal(size=(B, N, 3))).astype(
        np.float32)
    w = rng.uniform(0.2, 1.0, (B, N)).astype(np.float32)
    w[:, :3] = 0.0
    T, ok = epnp.rigid_align(t(pa), t(pb), t(w))
    Tj, okj = jax.vmap(jepnp.rigid_align)(pa, pb, w)
    assert ok.all() and np.asarray(okj).all()
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=2e-4)
    np.testing.assert_allclose(np.linalg.det(T.numpy()[:, :3, :3]), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(T.numpy(), T_true, atol=5e-3)
    # unweighted equals all-ones weights
    T1, _ = epnp.rigid_align(t(pa), t(pb))
    T2, _ = epnp.rigid_align(t(pa), t(pb), torch.ones(B, N))
    np.testing.assert_allclose(T1.numpy(), T2.numpy(), atol=1e-6)


def test_rigid_align_reflection_fix():
    """Where the unfixed Kabsch solution would be a reflection: a target
    that is the mirror image of a 3D set, and a flat set (its smallest
    singular value ~0, so the sign of its axis is noise). Both packages
    return the same proper rotation (det +1), and the flat set's pose is
    the true one."""
    rng = np.random.default_rng(1)
    n = 12
    pa = (rng.normal(size=(n, 3)) * [4, 3, 2]).astype(np.float32)
    pb = (pa * np.array([1, 1, -1], np.float32) + 1.0).astype(np.float32)
    H = (pa - pa.mean(0)).T @ (pb - pb.mean(0))
    U, _, Vt = np.linalg.svd(H)
    assert np.linalg.det(Vt.T @ U.T) < 0  # the unfixed solution reflects
    flat = np.stack([rng.normal(size=n) * 4, rng.normal(size=n) * 4,
                     1e-4 * rng.normal(size=n)], -1).astype(np.float32)
    T_true = random_poses(rng, 1)[0]
    flat_b = (apply(T_true, flat) + 2e-3 * rng.normal(size=(n, 3))).astype(
        np.float32)
    for a, b in ((pa, pb), (flat, flat_b)):
        T, ok = epnp.rigid_align(t(a), t(b))
        Tj, okj = jepnp.rigid_align(a, b)
        assert bool(ok) and bool(okj)
        assert abs(np.linalg.det(T.numpy()[:3, :3]) - 1.0) < 1e-5
        np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=2e-4)
    np.testing.assert_allclose(T.numpy(), T_true, atol=1e-2)


@pytest.mark.parametrize("case", ["collinear", "zero weights", "two points"])
def test_rigid_align_degenerate_sets(case):
    """Collinear points, all weights zero, or two weighted points: ok is
    False and T the identity in both packages."""
    rng = np.random.default_rng(2)
    n = 10
    d = rng.normal(size=3)
    pa = (np.linspace(-3, 3, n)[:, None] * d).astype(np.float32)
    w = np.ones(n, np.float32)
    if case != "collinear":
        pa = rng.normal(size=(n, 3)).astype(np.float32)
        w[:] = 0.0
        if case == "two points":
            w[:2] = 1.0
    pb = (pa + np.array([1.0, 2.0, 3.0], np.float32)).astype(np.float32)
    T, ok = epnp.rigid_align(t(pa), t(pb), t(w))
    Tj, okj = jepnp.rigid_align(pa, pb, w)
    assert not bool(ok) and not bool(okj)
    np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(Tj), np.eye(4))


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------

def _pnp_problem(rng, B, N, noise=0.0):
    T_true = random_poses(rng, B, trans=0.5)
    pc = np.stack([rng.uniform(-4, 4, (B, N)), rng.uniform(-2, 2, (B, N)),
                   rng.uniform(6, 30, (B, N))], -1)
    pw = apply(np.linalg.inv(T_true), pc).astype(np.float32)
    fx, fy, cx, cy, _ = CALIB
    pix = np.stack([fx * pc[..., 0] / pc[..., 2] + cx,
                    fy * pc[..., 1] / pc[..., 2] + cy], -1)
    pix = (pix + noise * rng.normal(size=pix.shape)).astype(np.float32)
    return T_true, pw, pix


def test_epnp_matches_jax_and_truth():
    """12-point problems with exact and with 0.5 px noisy pixels: the
    port's pose within 1e-2 of the JAX package's (rotation entries and
    meters; up to 3.1e-3 seen, float32 eigh of M^T M, whose entries span
    fx^2) and of its own float64 solution; with exact pixels within 1e-2
    of the truth (single-beta EPnP is exact there; with noise it is off
    by up to 0.23 m at 30 m in float64 too, so the truth is not compared);
    proper rotations; the null vector's sign puts every point in front of
    the camera."""
    rng = np.random.default_rng(3)
    for noise in (0.0, 0.5):
        T_true, pw, pix = _pnp_problem(rng, 8, 12, noise)
        T, ok = epnp.solve_pnp_epnp(t(pw), t(pix), t(CALIB))
        Tj, okj = jax.vmap(jepnp.solve_pnp_epnp, in_axes=(0, 0, None))(
            pw, pix, CALIB)
        T64, _ = epnp.solve_pnp_epnp(t(pw).double(), t(pix).double(),
                                     t(CALIB).double())
        assert ok.all() and np.asarray(okj).all()
        np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-2)
        np.testing.assert_allclose(T.numpy(), T64.numpy(), atol=1e-2)
        if noise == 0.0:
            np.testing.assert_allclose(T.numpy(), T_true, atol=1e-2)
        np.testing.assert_allclose(np.linalg.det(T.numpy()[:, :3, :3]), 1.0,
                                   atol=1e-4)
        assert (apply(T.numpy(), pw)[..., 2] > 0).all()


@pytest.mark.parametrize("case", ["coincident", "collinear"])
def test_epnp_degenerate_sets(case):
    """Every point at one location, or all on one line: both packages give
    the same ok flag and a finite pose (never NaN downstream); ok False
    means the identity. A single unbatched problem works too."""
    n = 8
    if case == "coincident":
        pw = np.tile(np.array([[1.0, 2.0, 10.0]], np.float32), (n, 1))
    else:
        pw = (np.array([1.0, 2.0, 10.0]) + np.linspace(0, 3, n)[:, None]
              * np.array([0.3, -0.2, 1.0])).astype(np.float32)
    fx, fy, cx, cy, _ = CALIB
    pix = np.stack([fx * pw[:, 0] / pw[:, 2] + cx,
                    fy * pw[:, 1] / pw[:, 2] + cy], -1).astype(np.float32)
    T, ok = epnp.solve_pnp_epnp(t(pw), t(pix), t(CALIB))
    Tj, okj = jepnp.solve_pnp_epnp(pw, pix, CALIB)
    assert bool(ok) == bool(okj)
    assert np.isfinite(T.numpy()).all() and np.isfinite(np.asarray(Tj)).all()
    if not bool(ok):
        np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
    T_true, pw, pix = _pnp_problem(np.random.default_rng(4), 1, 10)
    T1, ok1 = epnp.solve_pnp_epnp(t(pw[0]), t(pix[0]), t(CALIB))
    assert bool(ok1) and T1.shape == (4, 4)
    np.testing.assert_allclose(T1.numpy(), T_true[0], atol=1e-2)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def _rig():
    fx, fy, cx, cy, b = CALIB
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    P = K @ np.eye(3, 4, dtype=np.float32)
    Q = K @ np.concatenate([np.eye(3), [[-b], [0], [0]]], 1).astype(
        np.float32)
    return P, Q


def test_triangulate_matches_jax():
    """The DLT over 200 rectified correspondences: the port's points
    within 1e-3 relative of the JAX package's and of the truth (up to
    1.1e-4 seen: a float32 eigenvector of a nearly singular 4x4);
    triangulate_links and triangulate_rectified agree with them."""
    rng = np.random.default_rng(5)
    P, Q = _rig()
    X = np.stack([rng.uniform(-8, 8, 200), rng.uniform(-2, 2, 200),
                  rng.uniform(4, 60, 200)], -1).astype(np.float32)
    xl = X @ P[:, :3].T + P[:, 3]
    xr = X @ Q[:, :3].T + Q[:, 3]
    pl = (xl[:, :2] / xl[:, 2:]).astype(np.float32)
    pr = (xr[:, :2] / xr[:, 2:]).astype(np.float32)
    out = triangulation.triangulate(t(P), t(Q), t(pl), t(pr)).numpy()
    ref = np.asarray(jtri.triangulate(P, Q, pl, pr))
    scale = np.abs(X).max(-1, keepdims=True)
    assert (np.abs(out - ref) / scale).max() < 1e-3
    assert (np.abs(out - X) / scale).max() < 1e-3
    links = np.stack([pl[:, 0], pr[:, 0], pl[:, 1]], -1)
    np.testing.assert_allclose(
        triangulation.triangulate_links(t(P), t(Q), t(links)).numpy(),
        np.asarray(jtri.triangulate_links(P, Q, links)), rtol=1e-3)
    np.testing.assert_allclose(
        triangulation.triangulate_rectified(t(CALIB), t(links)).numpy(),
        np.asarray(jtri.triangulate_rectified(CALIB, links)), rtol=1e-5)


# ---------------------------------------------------------------------------
# db_odometry
# ---------------------------------------------------------------------------

def exact_db(num_frames=30, K=160):
    """A track store of exact stereo observations of a JAX-made straight
    scene: each frame's first K visible landmarks, the track id the
    landmark's index (what db_odometry reads: track_ids, links,
    num_frames)."""
    scene = jsynth.make_scene(jax.random.PRNGKey(0), num_frames=num_frames,
                              num_landmarks=1500, trajectory="straight",
                              hw=(192, 320))
    calib = np.asarray(scene.calib)
    F = num_frames
    tids = np.full((F, K), -1, np.int32)
    links = np.zeros((F, K, 3), np.float32)
    for f in range(F):
        meas, vis, _ = synthetic.observe_frame(
            types.SimpleNamespace(
                T_w2c=np.asarray(scene.T_w2c),
                landmarks=np.asarray(scene.landmarks), calib=calib,
                hw=scene.hw), f)
        ids = np.nonzero(vis)[0][:K]
        tids[f, :len(ids)] = ids
        links[f, :len(ids)] = meas[ids]
    db = types.SimpleNamespace(track_ids=tids, links=links, num_frames=F)
    return db, calib, np.asarray(scene.T_w2c)


def test_consecutive_correspondences_equal_jax():
    db, _, _ = exact_db()
    for a, b in zip(db_odometry.consecutive_correspondences(db, 64),
                    jdbo.consecutive_correspondences(db, 64)):
        np.testing.assert_array_equal(a, b)


def test_pnp_trajectory_matches_jax_and_truth():
    """The rebuilt trajectory of 30 frames from exact observations: every
    frame within 2e-3 (rotation entries, meters) of the JAX package's
    associative-scan chain and within 5e-3 of the truth; the log-depth
    prefix product equals a sequential chain to 1e-5."""
    db, calib, T_gt = exact_db()
    T = db_odometry.pnp_trajectory_from_db(db, calib, device="cpu")
    Tj = jdbo.pnp_trajectory_from_db(db, calib)
    assert T.shape == (30, 4, 4) and np.isfinite(T).all()
    np.testing.assert_allclose(T, Tj, atol=2e-3)
    rel_gt = T_gt @ np.linalg.inv(T_gt[:1])
    np.testing.assert_allclose(T, rel_gt, atol=5e-3)
    rng = np.random.default_rng(6)
    M = t(random_poses(rng, 21, trans=0.3)).double()
    seq = [M[0]]
    for k in range(1, 21):
        seq.append(M[k] @ seq[-1])
    np.testing.assert_allclose(db_odometry.prefix_products(M).numpy(),
                               torch.stack(seq).numpy(), atol=1e-10)


def test_pnp_trajectory_skips_pairs_without_tracks():
    """A frame pair with fewer than 3 common tracks contributes the
    identity, as in the JAX package."""
    db, calib, _ = exact_db(num_frames=8)
    db.track_ids[4, 2:] = -1
    T = db_odometry.pnp_trajectory_from_db(db, calib, device="cpu")
    Tj = jdbo.pnp_trajectory_from_db(db, calib)
    np.testing.assert_allclose(T, Tj, atol=2e-3)
    np.testing.assert_allclose(T[4], T[3], atol=1e-6)


# ---------------------------------------------------------------------------
# covgraph
# ---------------------------------------------------------------------------

def random_cov(rng):
    A = rng.normal(size=(6, 6)) * 0.1
    return A @ A.T + 1e-3 * np.eye(6)


def test_covariance_graph_equals_jax():
    """The same edges in both graphs: equal weights, distances, paths and
    path covariances; from_pose_graph on the same graph equal too."""
    rng = np.random.default_rng(7)
    n = 9
    g, gj = covgraph.CovarianceGraph(n), jcovgraph.CovarianceGraph(n)
    edges = [(k, k + 1) for k in range(n - 1)] + [(0, 5), (2, 7), (3, 8)]
    for i, j in edges:
        c = random_cov(rng)
        g.add_edge(i, j, c)
        gj.add_edge(i, j, c)
    c = random_cov(rng)
    g.update_edge(0, 1, c)
    gj.update_edge(0, 1, c)
    np.testing.assert_array_equal(g.w, gj.w)
    for src in range(n):
        for a, b in zip(g.dijkstra(src), gj.dijkstra(src)):
            np.testing.assert_array_equal(a, b)
    for src, dst in ((0, 8), (1, 6), (8, 2)):
        assert g.shortest_path(src, dst) == gj.shortest_path(src, dst)
        np.testing.assert_array_equal(g.path_covariance(src, dst),
                                      gj.path_covariance(src, dst))
    Z = random_poses(rng, 4, 0.5)
    si = np.stack([np.linalg.cholesky(np.linalg.inv(random_cov(rng))).T
                   for _ in range(4)]).astype(np.float32)
    arrays = dict(nodes=np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)),
                  keyframes=[0, 3, 6, 9], e_i=np.array([0, 1, 2, 0], np.int32),
                  e_j=np.array([1, 2, 3, 3], np.int32), Z=Z, sqrt_info=si,
                  is_loop=np.array([0, 0, 0, 1], bool))
    pg = covgraph.CovarianceGraph.from_pose_graph(
        PoseGraph(device="cpu", **arrays))
    pgj = jcovgraph.CovarianceGraph.from_pose_graph(JPoseGraph(**arrays))
    np.testing.assert_array_equal(pg.w, pgj.w)
    np.testing.assert_array_equal(pg.path_covariance(0, 3),
                                  pgj.path_covariance(0, 3))
