"""Dense pose-graph optimization and posterior covariances.

Counterpart of ``slam_tpu/ops/pose_graph.py``. Nodes are extrinsics X_i
(T_w2c of keyframe i), node 0 frozen. Edge (i, j) carries Z = X_j X_i^-1
and a 6x6 sqrt-information; the residual is
``r_ij = sqrt_info log(Z^-1 X_j X_i^-1)``. The normal equations are
assembled dense, (6N, 6N), and Jacobi-preconditioned before every solve
(the raw diagonal spans ~1 to ~1e7, which breaks float32 solves at a few
hundred nodes). Kernel B9 (``cuda_kernels.pg_system`` and ``pg_step``)
builds each LM iteration's system and takes its step on the card, around
the library's LU; its plain version, on the CPU, takes the edge Jacobians
as forward-mode derivatives of the residual in the right perturbations
of both nodes, as ``jax.jacfwd`` gives them in the JAX package, and B9 in
their closed form (``J_j = S Jr^-1(xi) Ad(X_i)``, ``J_i = -J_j``).

The models pad the graph to static buckets (``models/pose_graph.py``), as
the JAX package does: ``e_valid`` (E,) bool weighs the edges and
``n_valid`` (N,) bool the nodes, with the JAX package's semantics. An
invalid edge has zero residual and Jacobians; an invalid node, like the
gauge node 0, becomes an identity row and column of H with a zero
gradient, so its step is zero and its covariance block reads 0. Both
default to every entry valid. ``optimize``, ``gn_hessian_inverse``,
``gate_matrix`` and ``marginal_logdets`` run from CUDA graphs on the card
(``runtime.graphs``), one per padded shape, where the JAX package jits
them: all ``iters`` LM iterations, the posterior's dense inverse and the
gate's quadratic forms in one replay each, the accept/reject logic on
the device.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..runtime import graphs
from . import cuda_kernels as ck
from . import se3


def edge_residual(Xi, Xj, Z_inv, sqrt_info):
    """Whitened between-residuals (E, 6)."""
    r = se3.se3_log(Z_inv @ (Xj @ se3.inverse(Xi)))
    return (sqrt_info @ r[..., None])[..., 0]


def _edge_res_jac(Xi, Xj, Z_inv, sqrt_info):
    """Residuals (E, 6) and Jacobians (E, 6, 6) w.r.t. the right
    perturbations of Xi and Xj: one forward-mode pass over the edges
    repeated 12 times, copy k carrying the tangent of perturbation k."""
    E = Xi.shape[0]

    def rep(x):
        return x.repeat((12,) + (1,) * (x.dim() - 1))

    Xi12, Xj12, Zi12, S12 = rep(Xi), rep(Xj), rep(Z_inv), rep(sqrt_info)
    d0 = torch.zeros((12 * E, 12), dtype=Xi.dtype, device=Xi.device)
    tangent = torch.eye(12, dtype=Xi.dtype, device=Xi.device
                        ).repeat_interleave(E, dim=0)
    with fwAD.dual_level():
        d = fwAD.make_dual(d0, tangent)
        out = edge_residual(se3.retract(Xi12, d[:, :6]),
                            se3.retract(Xj12, d[:, 6:]), Zi12, S12)
        r, dr = fwAD.unpack_dual(out)
    J = dr.reshape(12, E, 6).permute(1, 2, 0)                    # (E, 6, 12)
    return r[:E], J[..., :6], J[..., 6:]


def _node_mask(N, dtype, device, n_valid=None):
    """(6N,) mask: 0 for the gauge node 0 and for padded nodes (``n_valid``
    False), 1 elsewhere."""
    m = (torch.ones(N, dtype=dtype, device=device) if n_valid is None
         else n_valid.to(dtype))
    m = torch.cat([torch.zeros_like(m[:1]), m[1:]])
    return m.repeat_interleave(6)


def _edge_weights(e_valid, e_i, dtype):
    """(E,) edge weights: 1 for a valid edge, 0 for padding."""
    if e_valid is None:
        return torch.ones(e_i.shape, dtype=dtype, device=e_i.device)
    return e_valid.to(dtype)


def _weighted_res_jac(nodes, e_i, e_j, Z_inv, sqrt_info, wE):
    """Residuals and Jacobians of the edges, zero on padded edges."""
    r, Ji, Jj = _edge_res_jac(nodes[e_i], nodes[e_j], Z_inv, sqrt_info)
    return (r * wE[:, None], Ji * wE[:, None, None],
            Jj * wE[:, None, None])


def _assemble(N, e_i, e_j, Ji, Jj, r):
    """Dense (6N, 6N) Gauss-Newton matrix and gradient (6N,), the same bit
    for bit for the same valid edges on every run and at every padding:
    a node's diagonal block and gradient sum its few edge
    terms in float64, where the sum is exact (up to the terms' exponent
    span), so the order ``index_add_``'s atomics take cannot change the
    float32 result; an edge's off-diagonal blocks go to slots of their own
    (padded edges add zeros there)."""
    dt, dev = Ji.dtype, Ji.device
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    diag = torch.zeros((N, 6, 6), dtype=torch.float64, device=dev)
    diag.index_add_(0, e_i, (JiT @ Ji).double())
    diag.index_add_(0, e_j, (JjT @ Jj).double())
    blocks = torch.zeros((N * N, 6, 6), dtype=dt, device=dev)
    blocks.index_add_(0, e_i * N + e_j, JiT @ Jj)
    blocks.index_add_(0, e_j * N + e_i, JjT @ Ji)
    d = torch.arange(N, device=dev)
    blocks[d * N + d] = diag.to(dt)
    H = blocks.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    g = torch.zeros((N, 6), dtype=torch.float64, device=dev)
    g.index_add_(0, e_i, (JiT @ r[..., None])[..., 0].double())
    g.index_add_(0, e_j, (JjT @ r[..., None])[..., 0].double())
    return H, g.to(dt).reshape(6 * N)


def _precondition(H, mask):
    H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    return H * dscale[:, None] * dscale[None, :], dscale


def _cost(nodes, e_i, e_j, Z_inv, sqrt_info, wE):
    """Half the sum of the squared whitened residuals, padded edges
    weighing zero."""
    r = edge_residual(nodes[e_i], nodes[e_j], Z_inv, sqrt_info) * wE[:, None]
    return 0.5 * torch.sum(r * r)


@graphs.graphed(static=("iters", "lam0"))
def optimize(nodes, e_i, e_j, Z, sqrt_info, e_valid=None, iters: int = 15,
             lam0: float = 1e-6, n_valid=None):
    """LM over the pose graph, node 0 frozen. nodes (N, 4, 4), edges
    e_i / e_j (E,), Z (E, 4, 4), sqrt_info (E, 6, 6), the padding masks
    e_valid (E,) and n_valid (N,). A step is accepted only if it cuts the
    cost by more than 0.1%: below that, float32 cost noise would read as
    improvement and random-walk the nodes. An iteration is B9's system,
    the LU solve and B9's step, which updates the nodes, the cost and the
    damping in place on the device. Returns (nodes, cost)."""
    N = nodes.shape[0]
    Z_inv = se3.inverse(Z)
    wE = _edge_weights(e_valid, e_i, nodes.dtype)
    mask = _node_mask(N, nodes.dtype, nodes.device, n_valid)
    if not iters:
        return nodes, _cost(nodes, e_i, e_j, Z_inv, sqrt_info, wE)
    # B9's step writes the nodes in place
    nodes = nodes.clone(memory_format=torch.contiguous_format)
    lam = torch.full((), lam0, dtype=nodes.dtype, device=nodes.device)
    for _ in range(iters):
        A, rhs, dscale, cost = ck.pg_system(nodes, e_i, e_j, Z_inv,
                                            sqrt_info, wE, mask, lam)
        x = torch.linalg.solve_ex(A, rhs[:, None])[0][:, 0]
        ck.pg_step(nodes, x, dscale, cost, lam, e_i, e_j, Z_inv, sqrt_info,
                   wE)
    return nodes, cost


def _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid):
    """The body :func:`gn_hessian_inverse`, :func:`gate_matrix` and
    :func:`marginal_logdets` share: the covariance (N, 6, N, 6), from B9's
    system at lam = 1e-6."""
    N = nodes.shape[0]
    wE = _edge_weights(e_valid, e_i, nodes.dtype)
    mask = _node_mask(N, nodes.dtype, nodes.device, n_valid)
    lam = torch.full((), 1e-6, dtype=nodes.dtype, device=nodes.device)
    Hs, _, dscale, _ = ck.pg_system(nodes, e_i, e_j, se3.inverse(Z),
                                    sqrt_info, wE, mask, lam)
    C = torch.linalg.inv_ex(Hs)[0] * dscale[:, None] * dscale[None, :]
    C = 0.5 * (C + C.T)
    C = C * mask[:, None] * mask[None, :]
    return C.reshape(N, 6, N, 6)


@graphs.graphed
def gn_hessian_inverse(nodes, e_i, e_j, Z, sqrt_info, e_valid=None,
                       n_valid=None):
    """Full posterior covariance (N, 6, N, 6): the Jacobi-preconditioned
    inverse of the Gauss-Newton Hessian, node 0 gauge-fixed and padded
    nodes masked (their blocks zero)."""
    return _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)


def relative_covariance(C, i, j):
    """Covariance (..., 6, 6) of the relative perturbation dj - di for
    index tensors i, j."""
    Sii, Sij, Sjj = C[i, :, i, :], C[i, :, j, :], C[j, :, j, :]
    rel = Sii + Sjj - Sij - Sij.transpose(-1, -2)
    return 0.5 * (rel + rel.transpose(-1, -2))


def adjoint(T):
    """SE(3) adjoint for twist order [w, v]: (..., 4, 4) -> (..., 6, 6)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([se3.hat(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mahalanobis_batched(C, nodes, i, j):
    """Loop-closure gating distances (P,) of keyframe pairs: the relative
    displacement D = log(Xj Xi^-1) weighed by its posterior covariance
    Adj(Xi) Cov(dj - di) Adj(Xi)^T. A broken (non-finite or negative)
    quadratic form fails closed: the pair is infinitely far."""
    Xi, Xj = nodes[i], nodes[j]
    D = se3.se3_log(Xj @ se3.inverse(Xi))
    A = adjoint(Xi)
    eye = 1e-9 * torch.eye(6, dtype=C.dtype, device=C.device)
    cov_D = A @ relative_covariance(C, i, j) @ A.transpose(-1, -2) + eye
    sol = torch.linalg.solve_ex(cov_D, D[..., None])[0][..., 0]
    d2 = torch.sum(D * sol, dim=-1)
    bad = ~torch.isfinite(d2) | (d2 < 0.0)
    return torch.where(bad, torch.full_like(d2, float("inf")),
                       torch.sqrt(torch.clamp(d2, min=0.0)))


def mahalanobis_distance(C, nodes, i: int, j: int):
    """:func:`mahalanobis_batched` of the one pair (i, j), a scalar."""
    idx = torch.as_tensor([i, j], device=nodes.device)
    return mahalanobis_batched(C, nodes, idx[:1], idx[1:])[0]


@graphs.graphed
def gate_matrix(nodes, e_i, e_j, Z, sqrt_info, e_valid, pair_i, pair_j,
                n_valid=None):
    """Posterior refresh + Mahalanobis sweep over candidate pairs (P,),
    without the covariance leaving the device. The JAX package's argument
    order: ``e_valid`` (None: every edge valid) before the pairs."""
    C = _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)
    return mahalanobis_batched(C, nodes, pair_i, pair_j)


@graphs.graphed
def marginal_logdets(nodes, e_i, e_j, Z, sqrt_info, e_valid=None,
                     n_valid=None):
    """Per-node natural-log determinants of the 3x3 location and rotation
    marginal covariance blocks, (N,) each."""
    C = _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)
    N = C.shape[0]
    d = torch.arange(N, device=C.device)
    blocks = C[d, :, d, :]
    eye3 = 1e-18 * torch.eye(3, dtype=C.dtype, device=C.device)
    tiny = torch.finfo(C.dtype).tiny

    def logdet3(M):
        det = torch.linalg.det(M + eye3)
        return torch.log(torch.clamp(torch.abs(det), min=tiny))

    return logdet3(blocks[:, 3:, 3:]), logdet3(blocks[:, :3, :3])
