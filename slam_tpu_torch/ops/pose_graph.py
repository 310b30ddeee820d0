"""Dense pose-graph optimization and posterior covariances.

Counterpart of ``slam_tpu/ops/pose_graph.py``. Nodes are extrinsics X_i
(T_w2c of keyframe i), node 0 frozen. Edge (i, j) carries Z = X_j X_i^-1
and a 6x6 sqrt-information; the residual is
``r_ij = sqrt_info log(Z^-1 X_j X_i^-1)``. The normal equations are
assembled dense, (6N, 6N), and Jacobi-preconditioned before every solve
(the raw diagonal spans ~1 to ~1e7, which breaks float32 solves at a few
hundred nodes). Edge Jacobians are forward-mode derivatives of the
residual in the right perturbations of both nodes, as ``jax.jacfwd``
gives them in the JAX package.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

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


def _node_mask(N, dtype, device):
    """(6N,) mask: 0 for the gauge node 0, 1 elsewhere."""
    m = torch.ones(6 * N, dtype=dtype, device=device)
    m[:6] = 0.0
    return m


def _assemble(N, e_i, e_j, Ji, Jj, r=None):
    """Dense (6N, 6N) Gauss-Newton matrix (and gradient (6N,) with r)."""
    dt, dev = Ji.dtype, Ji.device
    blocks = torch.zeros((N * N, 6, 6), dtype=dt, device=dev)
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    for a, b, Ja, Jb in ((e_i, e_i, JiT, Ji), (e_j, e_j, JjT, Jj),
                         (e_i, e_j, JiT, Jj), (e_j, e_i, JjT, Ji)):
        blocks.index_add_(0, a * N + b, Ja @ Jb)
    H = blocks.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    if r is None:
        return H
    g = torch.zeros((N, 6), dtype=dt, device=dev)
    g.index_add_(0, e_i, (JiT @ r[..., None])[..., 0])
    g.index_add_(0, e_j, (JjT @ r[..., None])[..., 0])
    return H, g.reshape(6 * N)


def _precondition(H, mask):
    H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    return H * dscale[:, None] * dscale[None, :], dscale


def optimize(nodes, e_i, e_j, Z, sqrt_info, iters: int = 15,
             lam0: float = 1e-6):
    """LM over the pose graph, node 0 frozen. nodes (N, 4, 4), edges
    e_i / e_j (E,), Z (E, 4, 4), sqrt_info (E, 6, 6). A step is accepted
    only if it cuts the cost by more than 0.1%: below that, float32 cost
    noise would read as improvement and random-walk the nodes. Returns
    (nodes, cost)."""
    N = nodes.shape[0]
    Z_inv = se3.inverse(Z)
    mask = _node_mask(N, nodes.dtype, nodes.device)
    eye = torch.eye(6 * N, dtype=nodes.dtype, device=nodes.device)

    def cost_of(X):
        r = edge_residual(X[e_i], X[e_j], Z_inv, sqrt_info)
        return 0.5 * torch.sum(r * r)

    cost = cost_of(nodes)
    lam = torch.tensor(lam0, dtype=nodes.dtype, device=nodes.device)
    for _ in range(iters):
        r, Ji, Jj = _edge_res_jac(nodes[e_i], nodes[e_j], Z_inv, sqrt_info)
        H, g = _assemble(N, e_i, e_j, Ji, Jj, r)
        Hs, dscale = _precondition(H, mask)
        x = torch.linalg.solve_ex(Hs + lam * eye, (dscale * g * mask)[:, None]
                                  )[0][:, 0]
        new_nodes = se3.retract(nodes, -(dscale * x).reshape(N, 6))
        new_cost = cost_of(new_nodes)
        ok = torch.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
        nodes = torch.where(ok, new_nodes, nodes)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(ok, new_cost, cost)
    return nodes, cost


def gn_hessian_inverse(nodes, e_i, e_j, Z, sqrt_info):
    """Full posterior covariance (N, 6, N, 6): the Jacobi-preconditioned
    inverse of the Gauss-Newton Hessian, node 0 gauge-fixed (its block
    zeroed)."""
    N = nodes.shape[0]
    r, Ji, Jj = _edge_res_jac(nodes[e_i], nodes[e_j], se3.inverse(Z),
                              sqrt_info)
    H = _assemble(N, e_i, e_j, Ji, Jj)
    mask = _node_mask(N, nodes.dtype, nodes.device)
    Hs, dscale = _precondition(H, mask)
    Hs = Hs + 1e-6 * torch.eye(6 * N, dtype=H.dtype, device=H.device)
    C = torch.linalg.inv_ex(Hs)[0] * dscale[:, None] * dscale[None, :]
    C = 0.5 * (C + C.T)
    C = C * mask[:, None] * mask[None, :]
    return C.reshape(N, 6, N, 6)


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


def gate_matrix(nodes, e_i, e_j, Z, sqrt_info, pair_i, pair_j):
    """Posterior refresh + Mahalanobis sweep over candidate pairs (P,),
    without the covariance leaving the device."""
    C = gn_hessian_inverse(nodes, e_i, e_j, Z, sqrt_info)
    return mahalanobis_batched(C, nodes, pair_i, pair_j)


def marginal_logdets(nodes, e_i, e_j, Z, sqrt_info):
    """Per-node natural-log determinants of the 3x3 location and rotation
    marginal covariance blocks, (N,) each."""
    C = gn_hessian_inverse(nodes, e_i, e_j, Z, sqrt_info)
    N = C.shape[0]
    d = torch.arange(N, device=C.device)
    blocks = C[d, :, d, :]
    eye3 = 1e-18 * torch.eye(3, dtype=C.dtype, device=C.device)
    tiny = torch.finfo(C.dtype).tiny

    def logdet3(M):
        det = torch.linalg.det(M + eye3)
        return torch.log(torch.clamp(torch.abs(det), min=tiny))

    return logdet3(blocks[:, 3:, 3:]), logdet3(blocks[:, :3, :3])
