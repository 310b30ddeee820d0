"""Kernel B9 (``cuda_kernels.pg_system`` / ``pg_step``): the dense pose
graph's LM system and step.

On the CPU the wrappers run the plain versions, which are held here bit
for bit to the composition ``ops.pose_graph`` ran before B9 (written out
below: the forward-mode linearization, ``_assemble``, ``_precondition``,
the LU solve, the retraction and the accept rule), at 17 keyframes in
the 64 bucket and 68 in the 128 one, with padded nodes and edges. The
closed-form edge Jacobian B9 computes (``J_j = S Jr^-1(xi) Ad(X_i)``,
``J_i = -J_j``) is written here as its specification (``spec_edge``)
and held to the forward-mode Jacobians in float64; B9's schedule (every
node's diagonal block and gradient from the edges touching it, each
off-diagonal block from the edges joining the pair, in edge order, the
Jacobi scaling by the product of the two scales) is written in torch
(``b9_schedule``) and held to the plain system in float64.

The tests marked ``cuda`` hold the kernel against the plain version on
the card at the 64, 128 and 704 buckets (``tests/pg_system_check.py``),
the graphed ``optimize`` to itself across replays bit for bit, and its
launch counts; they skip without a card. No JAX is imported:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pg_system.py
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from pg_system_check import (BUCKETS, bucket_graph, check_system, f64,
                             loop_graph, system_args)
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import pose_graph as pg
from slam_tpu_torch.ops import se3
from slam_tpu_torch.runtime import graphs

torch.set_num_threads(2)

# (keyframes, edges): 64 nodes / 64 edges and 128 / 128 once padded
CPU_CASES = [BUCKETS[64], BUCKETS[128]]


def padded_args(N, E):
    """The dense ops' padded arguments of loop_graph(N, E) on the CPU:
    (nodes, e_i, e_j, Z, sqrt_info, e_valid) and n_valid."""
    return loop_graph(N, E)._dense_args()


def optimize_before_b9(nodes, e_i, e_j, Z, sqrt_info, e_valid, iters,
                       n_valid, lam0=1e-6):
    """ops.pose_graph.optimize as it was before B9."""
    N = nodes.shape[0]
    Z_inv = se3.inverse(Z)
    wE = pg._edge_weights(e_valid, e_i, nodes.dtype)
    mask = pg._node_mask(N, nodes.dtype, nodes.device, n_valid)
    eye = torch.eye(6 * N, dtype=nodes.dtype)

    def cost_of(X):
        r = pg.edge_residual(X[e_i], X[e_j], Z_inv, sqrt_info) * wE[:, None]
        return 0.5 * torch.sum(r * r)

    cost = cost_of(nodes)
    lam = torch.full((), lam0, dtype=nodes.dtype)
    for _ in range(iters):
        r, Ji, Jj = pg._weighted_res_jac(nodes, e_i, e_j, Z_inv, sqrt_info,
                                         wE)
        H, g = pg._assemble(N, e_i, e_j, Ji, Jj, r)
        Hs, dscale = pg._precondition(H, mask)
        x = torch.linalg.solve_ex(Hs + lam * eye,
                                  (dscale * g * mask)[:, None])[0][:, 0]
        new_nodes = se3.retract(nodes, -(dscale * x).reshape(N, 6))
        new_cost = cost_of(new_nodes)
        ok = torch.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
        nodes = torch.where(ok, new_nodes, nodes)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(ok, new_cost, cost)
    return nodes, cost


def covariance_before_b9(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid):
    """ops.pose_graph._covariance_full as it was before B9."""
    N = nodes.shape[0]
    wE = pg._edge_weights(e_valid, e_i, nodes.dtype)
    r, Ji, Jj = pg._weighted_res_jac(nodes, e_i, e_j, se3.inverse(Z),
                                     sqrt_info, wE)
    H = pg._assemble(N, e_i, e_j, Ji, Jj, r)[0]  # H does not read r
    mask = pg._node_mask(N, nodes.dtype, nodes.device, n_valid)
    Hs, dscale = pg._precondition(H, mask)
    Hs = Hs + 1e-6 * torch.eye(6 * N, dtype=H.dtype, device=H.device)
    C = torch.linalg.inv_ex(Hs)[0] * dscale[:, None] * dscale[None, :]
    C = 0.5 * (C + C.T)
    C = C * mask[:, None] * mask[None, :]
    return C.reshape(N, 6, N, 6)


# ---------------------------------------------------------------------------
# on the CPU: the plain path, unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 15, 40])
@pytest.mark.parametrize("N,E", CPU_CASES)
def test_plain_optimize_equals_the_old_composition(N, E, iters):
    """optimize on CPU tensors runs B9's plain versions, once each an
    iteration, and gives the nodes and cost of the composition before B9
    bit for bit (40 iterations reach rejected steps, where the damping
    grows)."""
    (nodes, *edges), n_valid = padded_args(N, E)
    want = optimize_before_b9(nodes, *edges, iters, n_valid)
    ck.reset_counters()
    got = pg.optimize(nodes, *edges, iters=iters, n_valid=n_valid)
    assert ck.PLAIN_CALLS["pg_system"] == ck.PLAIN_CALLS["pg_step"] == iters
    assert not any(ck.LAUNCHES.values())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], nodes)  # the LM moved the nodes


@pytest.mark.parametrize("N,E", CPU_CASES)
def test_plain_covariance_equals_the_old_composition(N, E):
    """The covariances' body runs B9's plain system once (lam 1e-6) and
    gives the covariance before B9 bit for bit."""
    (nodes, *edges), n_valid = padded_args(N, E)
    want = covariance_before_b9(nodes, *edges, n_valid)
    ck.reset_counters()
    got = pg.gn_hessian_inverse(nodes, *edges, n_valid=n_valid)
    assert ck.PLAIN_CALLS["pg_system"] == 1 and not ck.PLAIN_CALLS["pg_step"]
    assert torch.equal(got, want)


def test_wrappers_check_their_shapes():
    """The wrappers refuse arguments of the wrong shape before they
    dispatch."""
    args = system_args(loop_graph(*BUCKETS[64]))
    nodes, e_i, e_j, Z_inv, si, wE, mask, lam = args
    with pytest.raises(ValueError, match="nodes"):
        ck.pg_system(nodes[..., :3], *args[1:])
    with pytest.raises(ValueError, match="do not match"):
        ck.pg_system(nodes, e_i, e_j[:5], *args[3:])
    with pytest.raises(ValueError, match="mask"):
        ck.pg_system(*args[:6], mask[:6], lam)
    x = torch.zeros(6 * nodes.shape[0])
    with pytest.raises(ValueError, match="x and dscale"):
        ck.pg_step(nodes, x[:6], x, lam.clone(), lam.clone(), e_i, e_j, Z_inv,
                   si, wE)


# ---------------------------------------------------------------------------
# on the CPU: the closed-form Jacobian B9 computes, its specification
# ---------------------------------------------------------------------------

SMALL2 = 1e-3  # se3's Taylor threshold on theta^2, B9's for c1, c2, c3


def jr_inv(xi):
    """Jr^-1 of SE(3) at twists xi (..., 6) [w, v], as B9 computes it:
    [[A, 0], [-A Q A, A]], A = I + W/2 + k W^2 with se3_log's k, and Q
    Barfoot's Q at (-v, -w)."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < SMALL2
    th = torch.sqrt(th2 + 1e-16)
    k = torch.where(small, 1 / 12 + th2 / 720,
                    (1 - 0.5 * th * torch.cos(0.5 * th)
                     / torch.sin(0.5 * th)) / th2)
    s = torch.where(small, torch.ones_like(th), torch.sqrt(th2))
    c1 = torch.where(small, 1 / 6 - th2 / 120 + th2 ** 2 / 5040,
                     (s - torch.sin(s)) / s ** 3)
    c2 = torch.where(small, 1 / 24 - th2 / 720 + th2 ** 2 / 40320,
                     (s * s + 2 * torch.cos(s) - 2) / (2 * s ** 4))
    c3 = torch.where(small, 1 / 120 - th2 / 2520 + th2 ** 2 / 120960,
                     (2 * s - 3 * torch.sin(s) + s * torch.cos(s))
                     / (2 * s ** 5))
    W = se3.hat(w)
    A = (torch.eye(3, dtype=xi.dtype) + 0.5 * W
         + k[..., None, None] * (W @ W))
    P, U = -W, se3.hat(-v)
    PUP = P @ U @ P

    def e(c):
        return c[..., None, None]

    Q = (0.5 * U + e(c1) * (P @ U + U @ P + PUP)
         + e(c2) * (P @ P @ U + U @ P @ P - 3 * PUP)
         + e(c3) * (PUP @ P + P @ PUP))
    out = torch.zeros(xi.shape[:-1] + (6, 6), dtype=xi.dtype)
    out[..., :3, :3] = A
    out[..., 3:, 3:] = A
    out[..., 3:, :3] = -A @ Q @ A
    return out


def spec_edge(Xi, Xj, Z_inv, S):
    """B9's residual (se3.se3_log's, with its branches) and Jacobians of
    edges (E,): r = S xi, xi = log(Z^-1 Xj Xi^-1), J_j = S Jr^-1(xi)
    Ad(Xi), J_i = -J_j."""
    xi = se3.se3_log(Z_inv @ (Xj @ se3.inverse(Xi)))
    Jj = S @ jr_inv(xi) @ pg.adjoint(Xi)
    return (S @ xi[..., None])[..., 0], -Jj, Jj


def random_T(gen, n, rot, trans):
    xi = torch.cat([rot * torch.randn((n, 3), generator=gen,
                                      dtype=torch.float64),
                    trans * torch.randn((n, 3), generator=gen,
                                        dtype=torch.float64)], -1)
    return se3.se3_exp(xi)


def edges_at(gen, n, angle):
    """n edges whose error xi has rotation angles ``angle`` (n,) about
    random axes: (Xi, Xj, Z_inv, S), float64."""
    axis = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen, dtype=torch.float64), dim=-1)
    err = se3.se3_exp(torch.cat([axis * angle[:, None],
                                 torch.randn((n, 3), generator=gen,
                                             dtype=torch.float64)], -1))
    Xi = random_T(gen, n, 1.0, 20.0)
    Z_inv = random_T(gen, n, 1.0, 2.0)
    Xj = se3.inverse(Z_inv) @ err @ Xi
    S = torch.randn((n, 6, 6), generator=gen, dtype=torch.float64)
    return Xi, Xj, Z_inv, S


@pytest.mark.parametrize("case", ["random", "under 1e-4 rad",
                                  "0.03-0.1 rad from pi"])
def test_closed_form_jacobian_matches_forward_mode(case):
    """In float64 the specification's Jacobians equal the forward-mode
    ones (``_edge_res_jac``) within 1e-9 and its residuals equal theirs,
    for random edge errors, rotations under 1e-4 rad and rotations 0.03
    to 0.1 rad from pi (se3_log's generic branch)."""
    gen = torch.Generator().manual_seed(7)
    n = 64
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    angle = {"random": 3.0 * u, "under 1e-4 rad": 1e-4 * u,
             "0.03-0.1 rad from pi": math.pi - 0.03 - 0.07 * u}[case]
    Xi, Xj, Z_inv, S = edges_at(gen, n, angle)
    r0, Ji0, Jj0 = pg._edge_res_jac(Xi, Xj, Z_inv, S)
    r1, Ji1, Jj1 = spec_edge(Xi, Xj, Z_inv, S)
    assert torch.equal(r0, r1)
    assert float((Ji0 + Jj0).abs().max()) <= 1e-12 * float(Jj0.abs().max())
    assert float((Jj1 - Jj0).abs().max()) <= 1e-9
    assert float((Ji1 - Ji0).abs().max()) <= 1e-9


def test_near_pi_branch_residual_and_finite_jacobian():
    """Within 1e-3 rad of pi se3_log takes its axis from a column of R + I
    (the near-pi branch): B9's residual is that branch's value, and its
    Jacobian, Jr^-1 at that twist, is finite. (The forward-mode Jacobian
    there is the derivative of the branch's approximation, whose axis
    can flip sign: it departs from the log's derivative by O(1), and the
    two are not compared.)"""
    gen = torch.Generator().manual_seed(11)
    n = 64
    angle = math.pi - 1e-3 * torch.rand(n, generator=gen,
                                        dtype=torch.float64)
    Xi, Xj, Z_inv, S = edges_at(gen, n, angle)
    r0, _, _ = pg._edge_res_jac(Xi, Xj, Z_inv, S)
    r1, Ji1, Jj1 = spec_edge(Xi, Xj, Z_inv, S)
    assert torch.equal(r0, r1)
    assert torch.isfinite(Jj1).all() and torch.equal(Ji1, -Jj1)


def b9_schedule(nodes, e_i, e_j, Z_inv, sqrt_info, wE, mask, lam):
    """B9's system, written in torch: each edge's P = J^T J, q = J^T r
    and c = r . r from the specification; a node's diagonal block and
    gradient summed over the edges touching it in edge order (a self edge
    twice in the block, +q - q in the gradient), each off-diagonal block
    -sum P over the edges joining the pair in edge order; the masks, d =
    1 / sqrt(max(diag, 1e-12)), A = Hm (d_a d_b) + lam I, rhs = d g m, the
    cost c / 2. Float64 throughout."""
    N, E = nodes.shape[0], e_i.shape[0]
    r, _, J = spec_edge(nodes[e_i], nodes[e_j], Z_inv, sqrt_info)
    r, J = r * wE[:, None], J * wE[:, None, None]
    P, q = J.transpose(1, 2) @ J, (J.transpose(1, 2) @ r[..., None])[..., 0]
    H = torch.zeros((N, N, 6, 6), dtype=nodes.dtype)
    g = torch.zeros((N, 6), dtype=nodes.dtype)
    for e in range(E):
        i, j = int(e_i[e]), int(e_j[e])
        H[i, i] += P[e]
        H[j, j] += P[e]
        g[j] += q[e]
        g[i] -= q[e]
        if i != j:
            H[i, j] -= P[e]
            H[j, i] -= P[e]
    H = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    Hm = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
    A = Hm * (d[:, None] * d[None, :]) + lam * torch.eye(6 * N,
                                                         dtype=H.dtype)
    return A, d * g.reshape(-1) * mask, d, 0.5 * (r * r).sum()


@pytest.mark.parametrize("N,E", CPU_CASES)
def test_b9_schedule_matches_the_plain_system(N, E):
    """B9's schedule against the plain system in float64 on the padded
    graph (padded edges join node 0 to itself at zero weight): A within
    1e-9 of its largest entry and exactly symmetric, rhs, dscale and the
    cost within 1e-9 relative. The rotations of the nodes and of Z^-1
    are made orthonormal in float64 first: the closed form is the log's
    derivative on SO(3), and the forward-mode one departs from it by the
    float32 rotations' departure from orthonormality (~1e-7)."""
    nodes, e_i, e_j, Z_inv, *rest = f64(system_args(loop_graph(N, E)))
    for T in (nodes, Z_inv):
        T[:, :3, :3] = se3.project_to_so3(T[:, :3, :3])
    args = (nodes, e_i, e_j, Z_inv, *rest)
    want = ck.pg_system_plain(*args)
    got = b9_schedule(*args)
    assert torch.equal(got[0], got[0].T)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_cuda_pg_system_matches_plain(cuda, bucket):
    """B9's system and step against the plain version at each node
    bucket (``pg_system_check.check_system``): A and rhs within 1e-4 of
    their largest entry, the cost within 1e-5 relative, A exactly
    symmetric, the step's decision and damping equal; no plain version
    runs inside the wrappers."""
    g = bucket_graph(bucket, str(cuda))
    args = system_args(g)
    assert args[0].shape[0] == bucket
    ck.reset_counters()
    errs = check_system(ck, args)
    print(bucket, errs)
    assert ck.LAUNCHES["pg_system"] == ck.LAUNCHES["pg_step"] == 1
    assert ck.PLAIN_CALLS["pg_system"] == 2  # the check's own calls
    assert ck.PLAIN_CALLS["pg_step"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [64, 704])
def test_cuda_optimize_replays_bit_for_bit(cuda, bucket):
    """The graphed optimize (warm-up, capture, replays) gives the same
    nodes and cost bit for bit at every call, and so does B9 eagerly;
    15 LM iterations are 15 launches of each entry point a call, and no
    plain version runs."""
    g = bucket_graph(bucket, str(cuda))
    args, n_valid = g._dense_args()
    graphs.clear()
    try:
        ck.reset_counters()
        runs = [pg.optimize(*args, iters=15, n_valid=n_valid)
                for _ in range(4)]
        launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        st = pg.optimize.stats()
        with graphs.eager():
            eager = pg.optimize(*args, iters=15, n_valid=n_valid)
    finally:
        graphs.clear()
    for nodes, cost in runs[1:] + [eager]:
        assert torch.equal(nodes, runs[0][0])
        assert torch.equal(cost, runs[0][1])
    # the second call captures and replays, the next two replay
    assert (st["captures"], st["replays"]) == (1, 3)
    assert launches["pg_system"] == launches["pg_step"] == 4 * 15
    assert not any(plain.values()), plain
    assert not torch.equal(runs[0][0], args[0])


@pytest.mark.cuda
def test_cuda_launches_count_iterations_and_covariances(cuda):
    """B9's system launches once per LM iteration and once per covariance
    (gn_hessian_inverse, gate_matrix, marginal_logdets), its step once
    per iteration, eagerly and from graphs alike; no plain version."""
    g = bucket_graph(64, str(cuda))
    N = g.num_nodes
    ii, jj = np.tril_indices(N, k=-1)
    graphs.clear()
    try:
        for mode in ("eager", "graphed", "graphed", "graphed"):
            ck.reset_counters()
            with (graphs.eager() if mode == "eager"
                  else contextlib.nullcontext()):
                h = g.copy()
                h.optimize(iters=15)
                h.covariance_full()
                h.gate_distances(jj, ii)
                h.marginal_logdets()
            assert ck.LAUNCHES["pg_step"] == 15, (mode, ck.LAUNCHES)
            assert ck.LAUNCHES["pg_system"] == 15 + 3, (mode, ck.LAUNCHES)
            assert not any(ck.PLAIN_CALLS.values()), ck.PLAIN_CALLS
    finally:
        graphs.clear()


@pytest.mark.cuda
def test_cuda_pg_system_refuses_what_it_cannot_take(cuda):
    """More nodes than B9 takes, or float64 state, raises; the wrappers
    never fall back to the plain versions."""
    args = system_args(bucket_graph(64, str(cuda)))
    ck.build()
    ck.reset_counters()
    N = ck.pg_max_nodes + 1
    nodes = torch.eye(4, device=cuda).repeat(N, 1, 1)
    mask = torch.ones(6 * N, device=cuda)
    with pytest.raises(ValueError, match="nodes B9 takes"):
        ck.pg_system(nodes, *args[1:6], mask, args[7])
    with pytest.raises(ValueError, match="float32"):
        ck.pg_system(*f64(args))
    assert not any(ck.PLAIN_CALLS.values())
