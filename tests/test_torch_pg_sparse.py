"""Parity of the port's sparse (selected-inverse) pose graph
(``slam_tpu_torch/ops/pg_sparse.py``) with the JAX package's
``slam_tpu/ops/pg_sparse.py``, with the dense float64 inverse and with the
port's dense path, and ``PoseGraph``'s routing above
``SPARSE_NODE_THRESHOLD``.

Both packages build the same graph from one numpy construction (the JAX
tests' ``make_stiff_loop_graph`` and ``add_loops``, whose sqrt-information
is reference-scale stiff); the port's graph is a copy of the JAX one's
arrays. The recurrences are compared at float64 on the same inputs
(1e-9 relative); the entry points, which both hand back float32 from a
float64 computation, within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import pg_sparse as jps
from slam_tpu_torch.models import pose_graph as pg_model
from slam_tpu_torch.models.pose_graph import PoseGraph
from slam_tpu_torch.ops import pg_sparse

import chip_smoke
from tests.test_pg_sparse import add_loops
from tests.test_pose_graph_scale import make_stiff_loop_graph

torch.set_num_threads(2)


def port_graph(pg) -> PoseGraph:
    """The port's PoseGraph with the JAX graph's arrays, on the CPU."""
    return PoseGraph(nodes=pg.nodes.copy(), keyframes=list(pg.keyframes),
                     e_i=pg.e_i.copy(), e_j=pg.e_j.copy(), Z=pg.Z.copy(),
                     sqrt_info=pg.sqrt_info.copy(),
                     is_loop=pg.is_loop.copy(), device="cpu")


def graphs(N, loops=(), seed=0):
    """(JAX graph, port graph) of one construction."""
    pg, _ = make_stiff_loop_graph(N, seed=seed)
    add_loops(pg, loops)
    return pg, port_graph(pg)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def tridiagonal(seed, N):
    """A random SPD block-tridiagonal T as (A, Bsub) at float64, with a
    zero Bsub[0], and a right-hand side (N, 6, 5)."""
    rng = np.random.default_rng(seed)
    Bsub = 0.3 * rng.standard_normal((N, 6, 6))
    Bsub[0] = 0.0
    M = rng.standard_normal((N, 6, 6))
    A = M @ M.transpose(0, 2, 1) + 8.0 * np.eye(6)
    return A, Bsub, rng.standard_normal((N, 6, 5))


# ---------------------------------------------------------------------------
# the recurrences, at float64 on the same inputs
# ---------------------------------------------------------------------------

def test_recurrences_match_jax_float64():
    """Block Cholesky, Takahashi, block Thomas, the segment table and the
    interval products against the JAX functions within 1e-9 relative, and
    the Thomas solve against a dense float64 solve of T."""
    N = 37
    A, Bsub, rhs = tridiagonal(1, N)
    prod_valid = (np.arange(N) >= 1) & (np.arange(N) <= N - 2)
    a = np.array([1, 3, 5, 1, 20, 2, 35])
    b = np.array([1, 9, 5, 35, 33, 34, 35])
    with jax.enable_x64():
        jA, jB = jnp.asarray(A), jnp.asarray(Bsub)
        Dinv_j = jps._factorize(jA, jB)
        Cd_j, G_j = jps._takahashi(Dinv_j, jB)
        x_j = jps._thomas_solve(jB, Dinv_j, G_j, jnp.asarray(rhs))
        tab_j = jps._segment_table(G_j, jnp.asarray(prod_valid))
        P_j = jax.vmap(lambda i, j: jps._interval_product(tab_j, i, j))(
            jnp.asarray(a), jnp.asarray(b))
        want = [np.asarray(x) for x in (Dinv_j, Cd_j, G_j, x_j, tab_j, P_j)]
    tA, tB = torch.from_numpy(A), torch.from_numpy(Bsub)
    Dinv = pg_sparse._factorize(tA, tB)
    Cd, G = pg_sparse._takahashi(Dinv, tB)
    x = pg_sparse._thomas_solve(tB, Dinv, G, torch.from_numpy(rhs))
    tab = pg_sparse._segment_table(G, torch.from_numpy(prod_valid))
    P = pg_sparse._interval_product(tab, torch.from_numpy(a),
                                    torch.from_numpy(b))
    got = [Dinv, Cd, G, x, tab, P]
    for name, g, w in zip(("Dinv", "Cd", "G", "x", "tab", "P"), got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        assert rel(g.numpy(), w) < 1e-9, name
    # the solve itself, against the assembled T
    T = np.zeros((N, 6, N, 6))
    for k in range(N):
        T[k, :, k, :] = A[k]
        if k:
            T[k, :, k - 1, :] = Bsub[k]
            T[k - 1, :, k, :] = Bsub[k].T
    ref = np.linalg.solve(T.reshape(6 * N, 6 * N), rhs.reshape(6 * N, 5))
    assert rel(x.numpy().reshape(6 * N, 5), ref) < 1e-9
    # and the diagonal blocks of its inverse
    Tinv = np.linalg.inv(T.reshape(6 * N, 6 * N)).reshape(N, 6, N, 6)
    assert rel(Cd.numpy(), np.einsum("kikj->kij", Tinv)) < 1e-9


def test_state_blocks_match_jax_float64():
    """Jacobians, assembly, the loop factor U and Woodbury's W of one
    graph with loops, against the JAX functions at float64 within 1e-9
    relative."""
    pg, tp = graphs(40, [(5, 30), (10, 38)])
    args = [np.asarray(x) for x in pg._sparse_arrays()]
    n_count = int(args[-1])

    def blocks(nodes, Zc, sic, li, lj, Zl, sil, lv):
        N = nodes.shape[0]
        m, _ = jps._node_masks(N, n_count, jnp.float64)
        _, Ji, Jj = jps._chain_jacobians(nodes, Zc, sic, m)
        A, Bsub = jps._assemble_chain(Ji, Jj, m, jnp.float64, N)
        _, Ji_l, Jj_l = jps._loop_jacobians(nodes, li, lj, Zl, sil, lv, m)
        U = jps._loop_U(Ji_l, Jj_l, li, lj, N)
        Dinv = jps._factorize(A, Bsub)
        _, G = jps._takahashi(Dinv, Bsub)
        return Ji, Jj, A, Bsub, U, jps._woodbury_W(Bsub, Dinv, G, U)

    with jax.enable_x64():
        a64 = [jnp.asarray(x.astype(np.float64)) if x.dtype == np.float32
               else jnp.asarray(x) for x in args[:-1]]
        want = [np.asarray(x) for x in jax.jit(blocks)(*a64)]
    t64 = [torch.from_numpy(np.array(x)) for x in args[:-1]]
    X, Zc_inv, si_c, Zl_inv, si_l, v = pg_sparse._inputs64(
        t64[0], t64[1], t64[2], t64[5], t64[6], t64[7])
    li_t, lj_t = t64[3].long(), t64[4].long()
    m_t, _ = pg_sparse._node_masks(X.shape[0], n_count, X)
    _, Ji_t, Jj_t = pg_sparse._chain_jacobians(X, Zc_inv, si_c, m_t)
    A_t, B_t = pg_sparse._assemble_chain(Ji_t, Jj_t, m_t)
    _, Jil_t, Jjl_t = pg_sparse._loop_jacobians(X, li_t, lj_t, Zl_inv, si_l,
                                                v, m_t)
    U_t = pg_sparse._loop_U(Jil_t, Jjl_t, li_t, lj_t, X.shape[0])
    Dinv_t = pg_sparse._factorize(A_t, B_t)
    W_t = pg_sparse._woodbury_W(B_t, Dinv_t, pg_sparse._cross_maps(
        Dinv_t, B_t), U_t)
    for name, g, w in zip(("Ji", "Jj", "A", "Bsub", "U", "W"),
                          (Ji_t, Jj_t, A_t, B_t, U_t, W_t), want):
        assert g.shape == w.shape, name
        assert rel(g.numpy(), w) < 1e-9, name


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_selected_blocks_match_jax_and_dense_inverse():
    """N = 48 with two loop edges: the diagonal blocks and the queried
    cross blocks (both orders, the gauge, equal indices) within 1e-5 of
    max |C| of the JAX package's and of the dense float64 inverse of the
    same whitened Hessian (chip_smoke.dense_cov64, phase 4k's reference);
    within 1e-3 of the port's dense path
    (float32, with its 1e-6 damping in the preconditioned space; the JAX
    tests' tolerance for the dense path)."""
    pg, tp = graphs(48, [(5, 30), (10, 44)])
    qi = np.array([0, 3, 3, 7, 20, 1, 44, 47], np.int64)
    qj = np.array([0, 3, 9, 3, 45, 44, 1, 2], np.int64)
    Cd_j, Cq_j = (np.asarray(x) for x in jps.selected_blocks(
        *pg._sparse_arrays(), jnp.asarray(qi, jnp.int32),
        jnp.asarray(qj, jnp.int32)))
    Cd_t, Cq_t = (x.numpy() for x in pg_sparse.selected_blocks(
        *tp._sparse_arrays(), torch.from_numpy(qi), torch.from_numpy(qj)))
    assert Cd_t.dtype == np.float32 and Cd_t.shape == (48, 6, 6)
    C = chip_smoke.dense_cov64(pg_sparse, tp._sparse_arrays())[0].numpy()
    scale = np.abs(Cd_j).max()
    assert np.abs(Cd_t - Cd_j[:48]).max() < 1e-5 * scale
    assert np.abs(Cq_t - Cq_j).max() < 1e-5 * scale
    assert np.abs(Cd_t - np.einsum("kikj->kij", C)).max() < 1e-5 * scale
    assert np.abs(Cq_t - C[qi, :, qj, :]).max() < 1e-5 * scale
    C_dense = tp.covariance_full()
    assert np.abs(Cq_t - C_dense[qi, :, qj, :]).max() < 1e-3 * scale


def test_gate_and_logdets_match_jax_and_dense_path(monkeypatch):
    """N = 96, one loop edge: gate distances and marginal log-dets through
    the routing switch within 1e-5 relative of the JAX package's sparse
    path (node 0 is the gauge: both emit the log of the clamp there); and
    against the port's dense path as the JAX tests hold the JAX sparse
    path against the JAX dense one (95th percentile of the relative gate
    difference < 0.05; log-dets within 0.2 nats)."""
    N = 96
    pg, tp = graphs(N, [(4, 60)])
    pi = np.arange(0, N - 11, 3, dtype=np.int64)
    pj = pi + 11
    d_dense = tp.gate_distances(pi, pj)
    loc_d, rot_d = tp.marginal_logdets()
    assert not tp._use_sparse()
    monkeypatch.setattr(pg_model, "SPARSE_NODE_THRESHOLD", 1)
    assert tp._use_sparse()
    d_s = tp.gate_distances(pi, pj)
    loc_s, rot_s = tp.marginal_logdets()
    args = pg._sparse_arrays()
    d_j = np.asarray(jps.gate_matrix_sparse(
        *args, jnp.asarray(np.resize(pi, 8192), jnp.int32),
        jnp.asarray(np.resize(pj, 8192), jnp.int32)))[:pi.size]
    loc_j, rot_j = (np.asarray(x)[:N] for x in
                    jps.marginal_logdets_sparse(*args))
    assert d_s.dtype == np.float32 and np.isfinite(d_s).all()
    assert rel(d_s, d_j) < 1e-5
    assert rel(loc_s[1:], loc_j[1:]) < 1e-5
    assert rel(rot_s[1:], rot_j[1:]) < 1e-5
    m = np.isfinite(d_dense) & (d_dense < 1e5)
    assert m.mean() > 0.9
    r = np.abs(d_s[m] - d_dense[m]) / np.maximum(d_dense[m], 1.0)
    assert np.percentile(r, 95) < 0.05
    assert np.abs(loc_s - loc_d)[1:].max() < 0.2
    assert np.abs(rot_s - rot_d)[1:].max() < 0.2


def test_optimize_matches_jax_and_dense(monkeypatch):
    """N = 64 with its stiff loop edge: the sparse LM against the JAX
    package's after 1, 2 and 25 iterations (so every accept decision is
    the same: nodes within 1e-5 of max |t|, costs within 1e-5 relative),
    and against the port's dense LM as the JAX tests hold the two JAX
    paths (the loop moves the nodes > 5 cm, cost below 1.5x the dense
    path's + 1, trajectories within 5 cm)."""
    N = 64
    pg, tp = graphs(N)
    args = pg._sparse_arrays()
    before = tp.nodes.copy()
    for iters in (1, 2, 25):
        nj, cj = jps.optimize_sparse(*args, iters=iters)
        nt, ct = pg_sparse.optimize_sparse(*tp._sparse_arrays(),
                                           iters=iters)
        nj = np.asarray(nj)[:N]
        assert nt.dtype == torch.float32
        assert np.abs(nt.numpy() - nj).max() < 1e-5 * np.abs(nj).max()
        assert abs(float(ct) - float(cj)) <= 1e-5 * float(cj)
    dense = tp.copy()
    cost_d = dense.optimize(iters=25)
    monkeypatch.setattr(pg_model, "SPARSE_NODE_THRESHOLD", 1)
    cost_s = tp.optimize(iters=25)
    assert np.isfinite(cost_s) and cost_s < 1.5 * cost_d + 1.0
    assert np.abs(tp.nodes[:, :3, 3] - before[:, :3, 3]).max() > 0.05
    assert np.abs(tp.nodes[:, :3, 3] - dense.nodes[:, :3, 3]).max() < 0.05


def test_routing_and_chain_layout(monkeypatch):
    """Above the threshold optimize, gate_distances and marginal_logdets
    go through ops/pg_sparse (and only they); an odometry-only graph
    still takes the analytic chain first; a graph whose non-loop edges are
    not the chain in node order raises ValueError on the sparse path."""
    calls = []
    for name in ("optimize_sparse", "gate_matrix_sparse",
                 "marginal_logdets_sparse"):
        fn = getattr(pg_sparse, name)
        monkeypatch.setattr(pg_sparse, name, lambda *a, fn=fn, name=name,
                            **k: calls.append(name) or fn(*a, **k))
    monkeypatch.setattr(pg_model, "SPARSE_NODE_THRESHOLD", 8)
    _, tp = graphs(16)
    no_loop = tp.copy()
    keep = ~no_loop.is_loop
    no_loop.e_i, no_loop.e_j = no_loop.e_i[keep], no_loop.e_j[keep]
    no_loop.Z, no_loop.sqrt_info = no_loop.Z[keep], no_loop.sqrt_info[keep]
    no_loop.is_loop = no_loop.is_loop[keep]
    assert no_loop.optimize() == 0.0 and calls == []
    d = no_loop.gate_distances(np.array([1, 2]), np.array([9, 15]))
    assert np.isfinite(d).all() and calls == ["gate_matrix_sparse"]
    tp.optimize(iters=2)
    tp.marginal_logdets()
    C = tp.covariance_full()
    assert C.shape == (16, 6, 16, 6)
    assert calls == ["gate_matrix_sparse", "optimize_sparse",
                     "marginal_logdets_sparse"]
    bad = tp.copy()
    bad.e_i, bad.e_j = bad.e_i[::-1].copy(), bad.e_j[::-1].copy()
    with pytest.raises(ValueError, match="consecutive odometry chain"):
        bad.optimize()
    with pytest.raises(ValueError, match="consecutive odometry chain"):
        bad.gate_distances(np.array([1]), np.array([9]))


def test_odometry_only_gate_matches_jax(monkeypatch):
    """A graph without loop edges on the sparse path (one invalid loop
    slot in the port, eight in the JAX package's bucket): gate distances
    and log-dets within 1e-5 relative of the JAX package's."""
    pg, tp = graphs(30)
    keep = ~pg.is_loop
    for g in (pg, tp):
        g.e_i, g.e_j, g.Z = g.e_i[keep], g.e_j[keep], g.Z[keep]
        g.sqrt_info, g.is_loop = g.sqrt_info[keep], g.is_loop[keep]
    monkeypatch.setattr(pg_model, "SPARSE_NODE_THRESHOLD", 1)
    pi, pj = np.array([1, 3, 10]), np.array([20, 29, 11])
    args = pg._sparse_arrays()
    d_j = np.asarray(jps.gate_matrix_sparse(
        *args, jnp.asarray(np.resize(pi, 8192), jnp.int32),
        jnp.asarray(np.resize(pj, 8192), jnp.int32)))[:3]
    assert rel(tp.gate_distances(pi, pj), d_j) < 1e-5
    loc_j, _ = jps.marginal_logdets_sparse(*args)
    assert rel(tp.marginal_logdets()[0][1:], np.asarray(loc_j)[1:30]) < 1e-5


def test_1100_nodes_as_shipped():
    """Above the threshold as shipped (1024): a graph of 1100 nodes with
    its loop edge optimizes, gates and gives log-dets through the sparse
    path, and covariance_full, marginal and relative_covariance answer
    densely with the (N, 6, N, 6) covariance instead of raising."""
    assert pg_model.SPARSE_NODE_THRESHOLD == 1024
    N = 1100
    _, tp = graphs(N, [(100, 1000)])
    assert tp._use_sparse()
    before = tp.nodes.copy()
    cost = tp.optimize(iters=4)
    assert np.isfinite(cost)
    assert np.abs(tp.nodes[:, :3, 3] - before[:, :3, 3]).max() > 0.05
    d = tp.gate_distances(np.arange(1, 1000, 37), np.arange(1, 1000, 37) + 90)
    assert np.isfinite(d).all() and (d > 0).all()
    loc, rot = tp.marginal_logdets()
    assert loc.shape == rot.shape == (N,) and np.isfinite(loc).all()
    assert np.median(loc[-100:]) > np.median(loc[1:101])
    C = tp.covariance_full()
    assert C.shape == (N, 6, N, 6) and np.isfinite(C).all()
    np.testing.assert_array_equal(tp.marginal(500, C), C[500, :, 500, :])
    R = tp.relative_covariance(10, 900, C)
    assert R.shape == (6, 6) and np.allclose(R, R.T)


def test_phase_4k_graph_equals_jax_construction():
    """chip_smoke.py's stiff_loop_graph (phase 4k's graph, built without
    the JAX package) equals the JAX tests' make_stiff_loop_graph +
    add_loops bit for bit."""
    N, loops = 600, ((100, 400), (250, 590))
    pg, _ = graphs(N, loops)
    tp = chip_smoke.stiff_loop_graph(N, "cpu", loops=loops)
    for k in ("nodes", "e_i", "e_j", "Z", "sqrt_info", "is_loop"):
        a, b = getattr(tp, k), getattr(pg, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert tp.keyframes == pg.keyframes


def test_selected_blocks_accurate_at_1024():
    """At N = 1024 with three loop edges (phase 4k's graph, shorter), every
    diagonal block but the gauge's and the cross blocks of pairs 499 apart
    within 1e-6 of the dense float64 inverse (chip_smoke.dense_cov64),
    relative to each block's largest entry; the JAX package's blocks, whose
    factorization forms B D^-1 B^T from an LU inverse, more than 1e-6 off
    on the same graph (ops/pg_sparse.py _factorize). Prints both."""
    N, loops = 1024, ((100, 464), (500, 864))
    tp = chip_smoke.stiff_loop_graph(N, "cpu", loops=loops)
    pg, _ = graphs(N, loops)
    args = tp._sparse_arrays()
    pi = np.arange(17, N - 500, 17)
    qi = np.concatenate([pi, pi + 499, [2]])
    qj = np.concatenate([pi + 499, pi, [N - 2]])
    Cdiag, Cq = pg_sparse.selected_blocks(*args, torch.as_tensor(qi),
                                          torch.as_tensor(qj))
    Cd_j, Cq_j = (torch.as_tensor(np.asarray(x)) for x in jps.selected_blocks(
        *pg._sparse_arrays(), jnp.asarray(qi, jnp.int32),
        jnp.asarray(qj, jnp.int32)))
    C, _ = chip_smoke.dense_cov64(pg_sparse, args)
    k = torch.arange(1, N)
    ref = (C[k, :, k, :], C[qi, :, qj, :])

    def err(diag, cross):
        return max(float(((got.double() - want).abs().amax((1, 2))
                          / want.abs().amax((1, 2))).max())
                   for got, want in zip((diag[1:N], cross), ref))

    e_port, e_jax = err(Cdiag, Cq), err(Cd_j, Cq_j)
    print(f"N = {N}: selected blocks off the dense float64 inverse per "
          f"block: port {e_port:.2e}, JAX package {e_jax:.2e}")
    assert e_port < 1e-6 < e_jax

