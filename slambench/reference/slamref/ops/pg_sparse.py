"""Sparse (selected-inverse) pose-graph covariances and LM.

Counterpart of ``slam_tpu/ops/pg_sparse.py``. The keyframe graph's
Gauss-Newton Hessian is a block-tridiagonal odometry chain plus a few
loop edges, H = T + U U^T (T with 6x6 blocks, U (6N, 6K) low rank), so
nothing of size (6N)^2 is needed:

  * block Cholesky of T, forward (D_k = A_k - B_k D_{k-1}^-1 B_k^T, in
    square-root form: see ``_factorize``);
  * Takahashi's selected inverse, backward (C_kk = D_k^-1 + G_k C_{k+1,k+1}
    G_k^T, G_k = -D_k^-1 B_{k+1}^T);
  * cross blocks C_ij = (G_i ... G_{j-1}) C_jj, the interval product taken
    from a log-depth table of segment products in chain order, largest
    power of two first (global prefix products overflow by N ~ 2500);
  * Jacobi preconditioning (every Jacobian's node columns scaled by
    diag(H)^-1/2), unscaled on the way out;
  * the loop edges by Woodbury: C = T^-1 - W W^T,
    W = T^-1 U chol(I + U^T T^-1 U)^-T;
  * LM solving (T + lam diag(H) + U U^T) d = -g by block Thomas + Woodbury.

Everything runs in float64 on the graph's device (the card by default):
relative covariances of nodes ~2500 steps from the gauge cancel ~8
digits, more than float32 holds. Results come back as float32, as the JAX
package's wrappers give them. The recurrences are plain loops over the
nodes, a few small launches per node; the JAX package's padding buckets
(node, loop, pair) exist for XLA's compile cache and are not needed here.
The gauge node and the node count mask stay.

Inputs (the JAX package's sparse-path layout): nodes (N, 4, 4); the chain
Z_chain (N-1, 4, 4), si_chain (N-1, 6, 6), edge k joining nodes k and
k+1; loops loop_i, loop_j (K,), Z_loop (K, 4, 4), si_loop (K, 6, 6),
loop_valid (K,); n_count, the number of real nodes (the rest padding).
"""

from __future__ import annotations

import torch

from . import se3
from .pose_graph import _edge_res_jac, adjoint, edge_residual

_PAIR_CHUNK = 1 << 16  # pairs priced at once (bounds the per-pair memory)


def _eye6(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# block-tridiagonal recurrences (one node per step)
# ---------------------------------------------------------------------------

def _factorize(A: torch.Tensor, Bsub: torch.Tensor) -> torch.Tensor:
    """Forward block Cholesky of T: A (N, 6, 6) diagonal blocks, Bsub
    (N, 6, 6) with Bsub[k] = T[k, k-1] (Bsub[0] zero). Returns Dinv.

    The Schur complement is formed in square-root form, D_k = A_k - V^T V
    with V = L_{k-1}^-1 B_k^T and L_{k-1} the Cholesky factor of D_{k-1}.
    The JAX package forms B_k D_{k-1}^-1 B_k^T from an LU inverse, which
    squares D's condition: on the stiff 2 m-step chain with three loop
    edges at N = 1024 its selected blocks sit 1.3e-5 off the dense float64
    inverse relative to each block's largest entry, this form's 8e-8
    (tests/test_torch_pg_sparse.py prints both)."""
    N = A.shape[0]
    Dinv = torch.empty_like(A)
    L = _eye6(A)
    for k in range(N):
        V = torch.linalg.solve_triangular(L, Bsub[k].T, upper=False)
        Dk = A[k] - V.T @ V
        L = torch.linalg.cholesky_ex(0.5 * (Dk + Dk.T))[0]
        Dinv[k] = torch.cholesky_inverse(L)
    return Dinv


def _cross_maps(Dinv: torch.Tensor, Bsub: torch.Tensor) -> torch.Tensor:
    """G[k] = -Dinv[k] @ Bsub[k+1]^T, the block taking C_{k+1, j} to
    C_{k, j} for j > k (G[N-1] = 0)."""
    Bnext = torch.cat([Bsub[1:], torch.zeros_like(Bsub[:1])])
    return -(Dinv @ Bnext.transpose(1, 2))


def _takahashi(Dinv: torch.Tensor, Bsub: torch.Tensor):
    """Backward selected-inverse recurrence: (Cd, G) with Cd[k] =
    (T^-1)_kk."""
    G = _cross_maps(Dinv, Bsub)
    N = Dinv.shape[0]
    Cd = torch.empty_like(Dinv)
    Cd[N - 1] = Dinv[N - 1]
    for k in range(N - 2, -1, -1):
        torch.addmm(Dinv[k], G[k] @ Cd[k + 1], G[k].T, out=Cd[k])
    return Cd, G


def _thomas_solve(Bsub, Dinv, G, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs for block-tridiagonal T; rhs (N, 6, R)."""
    N = rhs.shape[0]
    Dinv_prev = torch.cat([_eye6(Dinv)[None], Dinv[:-1]])
    L = Bsub @ Dinv_prev                 # L[k] = B_k D_{k-1}^-1 (L[0] = 0)
    y = torch.empty_like(rhs)
    y[0] = rhs[0]
    for k in range(1, N):
        torch.addmm(rhs[k], L[k], y[k - 1], alpha=-1.0, out=y[k])
    x = Dinv @ y                         # then x_k += G_k x_{k+1}
    for k in range(N - 2, -1, -1):
        x[k].addmm_(G[k], x[k + 1])
    return x


def _segment_table(G: torch.Tensor, prod_valid: torch.Tensor
                   ) -> torch.Tensor:
    """tab[l][k] = Gp_k @ ... @ Gp_{k + 2^l - 1} (identity past the end),
    Gp[k] = G[k] where ``prod_valid`` else I (the gauge link and the
    padding, which no query spans): (levels, N, 6, 6)."""
    N = G.shape[0]
    eye = _eye6(G)
    Gp = torch.where(prod_valid[:, None, None], G, eye)
    levels = max(1, (N - 1).bit_length())
    tab = [Gp]
    for lvl in range(1, levels):
        h = 1 << (lvl - 1)
        prev = tab[-1]
        shifted = torch.cat([prev[h:], eye.expand(min(h, N), 6, 6)])[:N]
        tab.append(prev @ shifted)
    return torch.stack(tab)


def _interval_product(tab: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """(P, 6, 6) products Gp_a @ ... @ Gp_{b-1} (I where a == b), from the
    table's binary decomposition of [a, b), largest segment first so the
    products run in chain order."""
    ln = b - a
    acc = _eye6(tab).expand(a.shape[0], 6, 6)
    pos = a
    for lvl in range(tab.shape[0] - 1, -1, -1):
        bit = (ln >> lvl) & 1
        seg = tab[lvl][pos]
        acc = torch.where(bit[:, None, None] == 1, acc @ seg, acc)
        pos = pos + (bit << lvl)
    return acc


# ---------------------------------------------------------------------------
# graph -> blocks
# ---------------------------------------------------------------------------

def _node_masks(N: int, n_count: int, like: torch.Tensor):
    idx = torch.arange(N, device=like.device)
    m = ((idx > 0) & (idx < n_count)).to(like.dtype)       # gauge, padding
    # G[k] enters cross products only for 1 <= k <= n_count - 2
    prod_valid = (idx >= 1) & (idx <= n_count - 2)
    return m, prod_valid


def _chain_jacobians(nodes, Zc_inv, si_chain, m):
    """Whitened residuals and Jacobians of the N-1 edges (k, k+1); edge k
    exists iff node k+1 is real, and each node's Jacobian is masked by
    that node's gauge/padding mask."""
    r, Ji, Jj = _edge_res_jac(nodes[:-1], nodes[1:], Zc_inv, si_chain)
    e_valid = m[1:]
    return (r * e_valid[:, None], Ji * (e_valid * m[:-1])[:, None, None],
            Jj * e_valid[:, None, None])


def _loop_jacobians(nodes, loop_i, loop_j, Zl_inv, si_loop, v, m):
    r, Ji, Jj = _edge_res_jac(nodes[loop_i], nodes[loop_j], Zl_inv, si_loop)
    return (r * v[:, None], Ji * (v * m[loop_i])[:, None, None],
            Jj * (v * m[loop_j])[:, None, None])


def _assemble_chain(Ji, Jj, m):
    """Diagonal and subdiagonal blocks of T from the chain Jacobians:
    A[k] = Ji_k^T Ji_k + Jj_{k-1}^T Jj_{k-1} + (1 - m_k) I,
    Bsub[k] = Jj_{k-1}^T Ji_{k-1}."""
    z = torch.zeros_like(Ji[:1])
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    A = torch.cat([JiT @ Ji, z]) + torch.cat([z, JjT @ Jj])
    A = A + (1.0 - m)[:, None, None] * _eye6(A)
    return A, torch.cat([z, JjT @ Ji])


def _loop_U(Ji_l, Jj_l, loop_i, loop_j, N):
    """U (N, 6, 6K): loop edge e's two 6x6 blocks at nodes i_e and j_e,
    so that U U^T holds every loop edge's J^T J."""
    K = Ji_l.shape[0]
    e = torch.arange(K, device=Ji_l.device)
    Ut = Ji_l.new_zeros((N, K, 6, 6))
    Ut.index_put_((loop_i, e), Ji_l.transpose(1, 2), accumulate=True)
    Ut.index_put_((loop_j, e), Jj_l.transpose(1, 2), accumulate=True)
    return Ut.permute(0, 2, 1, 3).reshape(N, 6, K * 6)


def _inputs64(nodes, Z_chain, si_chain, Z_loop, si_loop, loop_valid):
    """Float64 copies, the edge measurements inverted."""
    return (nodes.double(), se3.inverse(Z_chain.double()), si_chain.double(),
            se3.inverse(Z_loop.double()), si_loop.double(),
            loop_valid.double())


def _woodbury_W(Bsub, Dinv, G, U):
    """W of C = T^-1 - W W^T for H = T + U U^T."""
    N, _, KK = U.shape
    Y = _thomas_solve(Bsub, Dinv, G, U)
    S = torch.eye(KK, dtype=U.dtype, device=U.device) + torch.einsum(
        "kiu,kiv->uv", U, Y)
    L = torch.linalg.cholesky_ex(0.5 * (S + S.T))[0]
    Wt = torch.linalg.solve_triangular(L, Y.reshape(N * 6, KK).T,
                                       upper=False)
    return Wt.T.reshape(N, 6, KK)


def _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop, si_loop,
                 loop_valid, n_count):
    """What gate and log-det queries need: (Cdiag, Cd, tab, W, m, s),
    from the recurrences on the Jacobi-preconditioned Hessian S H S
    (covariances are unscaled on the way out, C = S Chat S)."""
    X, Zc_inv, si_c, Zl_inv, si_l, v = _inputs64(
        nodes, Z_chain, si_chain, Z_loop, si_loop, loop_valid)
    N = X.shape[0]
    m, prod_valid = _node_masks(N, n_count, X)
    _, Ji, Jj = _chain_jacobians(X, Zc_inv, si_c, m)
    _, Ji_l, Jj_l = _loop_jacobians(X, loop_i, loop_j, Zl_inv, si_l, v, m)
    # Jacobi scales from the unscaled diagonal (chain + loops); gauge and
    # padding rows carry the (1 - m) identity, so s = 1 there
    A0, _ = _assemble_chain(Ji, Jj, m)
    diag = torch.diagonal(A0, dim1=1, dim2=2).clone()
    diag.index_add_(0, loop_i, (Ji_l * Ji_l).sum(1))
    diag.index_add_(0, loop_j, (Jj_l * Jj_l).sum(1))
    s = torch.rsqrt(torch.clamp(diag, min=1e-12))
    Ji = Ji * s[:-1][:, None, :]
    Jj = Jj * s[1:][:, None, :]
    Ji_l = Ji_l * s[loop_i][:, None, :]
    Jj_l = Jj_l * s[loop_j][:, None, :]
    A, Bsub = _assemble_chain(Ji, Jj, m)
    Dinv = _factorize(A, Bsub)
    Cd, G = _takahashi(Dinv, Bsub)
    tab = _segment_table(G, prod_valid)
    W = _woodbury_W(Bsub, Dinv, G, _loop_U(Ji_l, Jj_l, loop_i, loop_j, N))
    Chat = Cd - W @ W.transpose(1, 2)
    Cdiag = (s[:, :, None] * Chat * s[:, None, :]) * m[:, None, None]
    return Cdiag, Cd, tab, W, m, s


def _cross_blocks(state, a, b):
    """C[a, b] (unscaled) for a <= b, (P, 6, 6)."""
    _, Cd, tab, W, m, s = state
    P_ab = _interval_product(tab, a, b)
    Chat = (P_ab @ Cd[b] - W[a] @ W[b].transpose(1, 2)) * (
        m[a] * m[b])[:, None, None]
    return s[a][:, :, None] * Chat * s[b][:, None, :]


def _pair_distances(state, X, i, j):
    """Mahalanobis gate distances of pairs (i, j), as
    ops/pose_graph.mahalanobis_batched but from the selected inverse."""
    Cdiag = state[0]
    a, b = torch.minimum(i, j), torch.maximum(i, j)
    C_ab = _cross_blocks(state, a, b)
    rel = Cdiag[a] + Cdiag[b] - C_ab - C_ab.transpose(1, 2)
    rel = 0.5 * (rel + rel.transpose(1, 2))
    Xi, Xj = X[i], X[j]
    D = se3.se3_log(Xj @ se3.inverse(Xi))
    Ad = adjoint(Xi)
    cov_D = Ad @ rel @ Ad.transpose(1, 2) + 1e-9 * _eye6(X)
    d2 = torch.sum(D * torch.linalg.solve_ex(cov_D, D[..., None])[0][..., 0],
                   dim=-1)
    bad = ~torch.isfinite(d2) | (d2 < 0.0)
    return torch.where(bad, torch.full_like(d2, float("inf")),
                       torch.sqrt(torch.clamp(d2, min=0.0)))


# ---------------------------------------------------------------------------
# entry points (float64 inside, float32 out)
# ---------------------------------------------------------------------------

def gate_matrix_sparse(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                       si_loop, loop_valid, n_count, pair_i, pair_j):
    """Mahalanobis gate distances (P,) of candidate pairs: an O(N) state
    build, then the pairs priced in chunks of _PAIR_CHUNK."""
    state = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                         si_loop, loop_valid, n_count)
    X = nodes.double()
    d = [_pair_distances(state, X, pair_i[c:c + _PAIR_CHUNK],
                         pair_j[c:c + _PAIR_CHUNK])
         for c in range(0, pair_i.shape[0], _PAIR_CHUNK)]
    return torch.cat(d).float() if d else X.new_zeros(0).float()


def _logdet3(M: torch.Tensor) -> torch.Tensor:
    M = M + 1e-18 * torch.eye(3, dtype=M.dtype, device=M.device)
    det = (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                           - M[..., 1, 2] * M[..., 2, 1])
           - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                             - M[..., 1, 2] * M[..., 2, 0])
           + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                             - M[..., 1, 1] * M[..., 2, 0]))
    return torch.log(torch.clamp(torch.abs(det),
                                 min=torch.finfo(M.dtype).tiny))


def marginal_logdets_sparse(nodes, Z_chain, si_chain, loop_i, loop_j,
                            Z_loop, si_loop, loop_valid, n_count):
    """Per-node (log det location cov, log det rotation cov), (N,) each."""
    Cdiag = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                         si_loop, loop_valid, n_count)[0]
    return (_logdet3(Cdiag[:, 3:, 3:]).float(),
            _logdet3(Cdiag[:, :3, :3]).float())


def selected_blocks(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                    si_loop, loop_valid, n_count, qi, qj):
    """Diagnostic access: (Cdiag (N, 6, 6), C[qi, qj] (Q, 6, 6))."""
    state = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                         si_loop, loop_valid, n_count)
    Cdiag = state[0]
    a, b = torch.minimum(qi, qj), torch.maximum(qi, qj)
    C_ab = _cross_blocks(state, a, b)
    C = torch.where((qi < qj)[:, None, None], C_ab, C_ab.transpose(1, 2))
    C = torch.where((qi == qj)[:, None, None], Cdiag[a], C)
    return Cdiag.float(), C.float()


def optimize_sparse(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                    si_loop, loop_valid, n_count, iters: int = 15,
                    lam0: float = 1e-6):
    """LM over the graph by the sparse solver: each step solves
    (T + lam diag(H) + U U^T) d = -g by block Thomas + Woodbury, O(N) per
    iteration. Marquardt (relative) damping, as the dense path's
    Jacobi-scaled lam I; a step is accepted only if it cuts the cost by
    more than 0.1%. No host synchronisation inside. Returns (nodes, cost)
    in float32."""
    X, Zc_inv, si_c, Zl_inv, si_l, v = _inputs64(
        nodes, Z_chain, si_chain, Z_loop, si_loop, loop_valid)
    N = X.shape[0]
    m, _ = _node_masks(N, n_count, X)
    e_valid = m[1:]

    def cost_of(X):
        r_c = edge_residual(X[:-1], X[1:], Zc_inv, si_c) * e_valid[:, None]
        r_l = edge_residual(X[loop_i], X[loop_j], Zl_inv, si_l) * v[:, None]
        return 0.5 * (torch.sum(r_c * r_c) + torch.sum(r_l * r_l))

    def step(X, lam):
        r_c, Ji, Jj = _chain_jacobians(X, Zc_inv, si_c, m)
        r_l, Ji_l, Jj_l = _loop_jacobians(X, loop_i, loop_j, Zl_inv, si_l,
                                          v, m)
        U = _loop_U(Ji_l, Jj_l, loop_i, loop_j, N)
        # gradient: J^T r summed over each node's edges
        g = torch.zeros((N, 6), dtype=X.dtype, device=X.device)
        g[:-1] += torch.einsum("eai,ea->ei", Ji, r_c)
        g[1:] += torch.einsum("eai,ea->ei", Jj, r_c)
        g.index_add_(0, loop_i, torch.einsum("eai,ea->ei", Ji_l, r_l))
        g.index_add_(0, loop_j, torch.einsum("eai,ea->ei", Jj_l, r_l))
        # Marquardt damping on diag(H) = diag(T) + the rows of U squared
        A, Bsub = _assemble_chain(Ji, Jj, m)
        dA = torch.diagonal(A, dim1=1, dim2=2)
        dA += lam * (dA + torch.sum(U * U, dim=-1))
        Dinv = _factorize(A, Bsub)
        G = _cross_maps(Dinv, Bsub)
        # Woodbury: (T' + U U^T)^-1 g
        sol = _thomas_solve(Bsub, Dinv, G, torch.cat([g[:, :, None], U], -1))
        x_g, Y = sol[:, :, 0], sol[:, :, 1:]
        KK = U.shape[-1]
        S = torch.eye(KK, dtype=X.dtype, device=X.device) + torch.einsum(
            "kiu,kiv->uv", U, Y)
        UTx = torch.einsum("kiu,ki->u", U, x_g)
        corr = Y @ torch.linalg.solve_ex(0.5 * (S + S.T), UTx)[0]
        return se3.retract(X, -(x_g - corr))

    cost = cost_of(X)
    lam = torch.full((), lam0, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        new_X = step(X, lam)
        new_cost = cost_of(new_X)
        ok = torch.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
        X = torch.where(ok, new_X, X)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(ok, new_cost, cost)
    return X.float(), cost.float()
