"""Stiff pose graphs built without the JAX package, and the dense float64
reference of the sparse path's selected inverse: what
``tests/test_torch_pg_sparse.py`` holds against the JAX package on the
CPU, and what the card tests (``test_torch_kernels.py``,
``test_torch_card_paths.py``) run on the card, where JAX is absent.

The module imports no JAX.
"""

import numpy as np
import torch

# the sparse pose graph's card scene: 2560 keyframes, above
# models.pose_graph.SPARSE_NODE_THRESHOLD, with two loop edges besides the
# stiff one from keyframe 2 to N - 2
PG_NODES = 2560
PG_LOOPS = ((100, 2000), (500, 2400))


def stiff_loop_graph(N: int, device: str, loops=PG_LOOPS, seed: int = 0):
    """A port PoseGraph of N keyframes: a ~2 m-step odometry chain with
    gentle yaw noise and reference-scale stiff sqrt-information (5e3
    rotation, 1.5e2 translation rows), built on the host in float64; a loop
    edge (2, N - 2) whose measurement disagrees with the chain by 0.5 m;
    and one loop edge per pair of ``loops`` off by 0.05 m. The same
    construction as the JAX package's tests (make_stiff_loop_graph,
    add_loops; tests/test_torch_pg_sparse.py holds the two equal)."""
    from slam_tpu_torch.models.pose_graph import PoseGraph

    rng = np.random.default_rng(seed)
    nodes = np.zeros((N, 4, 4))
    nodes[0] = np.eye(4)
    Z = np.zeros((N - 1, 4, 4))
    for i, yaw in enumerate(0.002 * rng.standard_normal(N - 1)):
        c, s_ = np.cos(yaw), np.sin(yaw)
        Z[i] = [[c, 0.0, s_, 0.0], [0.0, 1.0, 0.0, 0.0], [-s_, 0.0, c, 2.0],
                [0.0, 0.0, 0.0, 1.0]]
        nodes[i + 1] = Z[i] @ nodes[i]
    si = np.eye(6, dtype=np.float32)
    si[:3, :3] *= 5e3
    si[3:, 3:] *= 1.5e2
    pg = PoseGraph(nodes=nodes.astype(np.float32), keyframes=list(range(N)),
                   e_i=np.arange(N - 1, dtype=np.int32),
                   e_j=np.arange(1, N, dtype=np.int32),
                   Z=Z.astype(np.float32),
                   sqrt_info=np.tile(si, (N - 1, 1, 1)),
                   is_loop=np.zeros(N - 1, bool), device=device)
    i, j = 2, N - 2
    T_mis = np.eye(4)
    T_mis[0, 3] = 0.5
    rel = (pg.nodes[j].astype(np.float64)
           @ np.linalg.inv(pg.nodes[i].astype(np.float64)))
    pg.add_edge(i, j, (rel @ T_mis).astype(np.float32), np.eye(6) * 1e-4)
    for i, j in loops:
        rel = pg.nodes[j] @ np.linalg.inv(pg.nodes[i])
        T_mis = np.eye(4, dtype=np.float32)
        T_mis[0, 3] = 0.05
        pg.add_edge(i, j, rel @ T_mis, np.eye(6) * 1e-4)
    return pg


def dense_cov64(pg_sparse, args):
    """The dense float64 inverse of the sparse path's whitened Hessian
    (the same Jacobians, the chain and the loop edges assembled into
    (6N, 6N), the gauge rows the identity), Jacobi-scaled for the
    inversion, refined by one Newton step X += X (I - H X), unscaled
    after, the gauge rows zeroed: (N, 6, N, 6), and the step's largest
    change relative to max |X|."""
    nodes, Z_c, si_c, li, lj, Z_l, si_l, lv, n = args
    X, Zc_inv, si_c, Zl_inv, si_l, v = pg_sparse._inputs64(
        nodes, Z_c, si_c, Z_l, si_l, lv)
    N = X.shape[0]
    m, _ = pg_sparse._node_masks(N, n, X)
    _, Ji, Jj = pg_sparse._chain_jacobians(X, Zc_inv, si_c, m)
    _, Jil, Jjl = pg_sparse._loop_jacobians(X, li, lj, Zl_inv, si_l, v, m)
    k = torch.arange(N - 1, device=X.device)
    H = torch.zeros((N, N, 6, 6), dtype=X.dtype, device=X.device)
    for a, b, Ja, Jb in ((k, k + 1, Ji, Jj), (li, lj, Jil, Jjl)):
        for r, c, Jr, Jc in ((a, a, Ja, Ja), (b, b, Jb, Jb), (a, b, Ja, Jb),
                             (b, a, Jb, Ja)):
            H.index_put_((r, c), Jr.transpose(1, 2) @ Jc, accumulate=True)
    H = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    mask = m.repeat_interleave(6)
    H = H + torch.diag(1.0 - mask)
    s = torch.rsqrt(torch.diagonal(H))
    H = H * s[:, None] * s[None, :]
    C = torch.linalg.inv(H)
    R = -(H @ C)
    R.diagonal().add_(1.0)
    D = C @ R
    step = float(D.abs().max() / C.abs().max())
    C += D
    del R, D
    C = C * (s * mask)[:, None] * (s * mask)[None, :]
    return C.reshape(N, 6, N, 6), step
