"""Kernel B9's graphs and its rule against the plain version, shared by
``tests/test_torch_pg_system.py`` and ``chip_smoke.py``.

The graphs sit at the dense pose graph's node buckets: a 17-keyframe
loop (64 nodes, 64 edges), a 68-keyframe clover-sized loop (128, 128)
and KITTI 00's 652 keyframes as a stiff 2 m-step chain (704, 704), each
with loop edges and padded nodes and edges. The rule (``check_system``):
B9's A and rhs within 1e-4 of their largest entry and its cost within
1e-5 relative of the plain version's on float64 copies of the same
inputs (B9 computes its terms in float64; the plain version in float32
rounds its residuals of the 1.3 km chain by up to ~1e-2 whitened), A
exactly symmetric. The module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# KITTI 00's keyframe count: the dense pose graph's 704-node bucket
KITTI00_KEYFRAMES = 652
# bucket -> (keyframes, edges before padding); None: the stiff KITTI graph
BUCKETS = {64: (17, 20), 128: (68, 80), 704: None}
# B9 against the plain version on float64 copies
TOL = {"A": 1e-4, "rhs": 1e-4, "cost": 1e-5}


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def loop_graph(N: int, E: int, device: str = "cpu", seed: int = 0):
    """A port PoseGraph: a drifting odometry chain of N keyframes around
    a 20 m loop (noise 0.002 rad / 0.02 m an edge) and E - (N - 1) loop
    edges between keyframes at least 3 apart (0.01 rad / 0.1 m), their
    sqrt-information the inverse of those sigmas."""
    from slam_tpu_torch.models.pose_graph import PoseGraph
    from slam_tpu_torch.ops import se3

    rng = np.random.default_rng(seed + 1000 * N + E)
    T_gt = np.zeros((N, 4, 4), np.float32)
    for i, a in enumerate(np.linspace(0, 2 * np.pi * (N - 1) / N, N)):
        c = 20 * np.array([1 - np.cos(a), 0.1 * np.sin(3 * a), np.sin(a)])
        T_gt[i, :3, :3] = _ry(a).T
        T_gt[i, :3, 3] = -_ry(a).T @ c
        T_gt[i, 3, 3] = 1

    def noisy(T, sigma):
        xi = np.concatenate([rng.normal(0, sigma[0], 3),
                             rng.normal(0, sigma[1], 3)]).astype(np.float32)
        return se3.retract(torch.from_numpy(T), torch.from_numpy(xi)).numpy()

    odo, loop = (0.002, 0.02), (0.01, 0.1)
    Z = [noisy(T_gt[k + 1] @ np.linalg.inv(T_gt[k]), odo)
         for k in range(N - 1)]
    cand = [(i, j) for i in range(N) for j in range(i + 3, N)]
    loops = [cand[k] for k in rng.choice(len(cand), E - (N - 1),
                                         replace=False)]
    Z += [noisy(T_gt[j] @ np.linalg.inv(T_gt[i]), loop) for i, j in loops]
    nodes = np.zeros_like(T_gt)
    nodes[0] = T_gt[0]
    for k in range(N - 1):
        nodes[k + 1] = Z[k] @ nodes[k]
    si = [np.diag([1 / s[0]] * 3 + [1 / s[1]] * 3) for s in (odo, loop)]
    K = len(loops)
    return PoseGraph(
        nodes=nodes, keyframes=list(range(N)),
        e_i=np.array(list(range(N - 1)) + [i for i, _ in loops], np.int32),
        e_j=np.array(list(range(1, N)) + [j for _, j in loops], np.int32),
        Z=np.stack(Z).astype(np.float32),
        sqrt_info=np.stack([si[0]] * (N - 1) + [si[1]] * K).astype(
            np.float32),
        is_loop=np.array([False] * (N - 1) + [True] * K), device=device)


def bucket_graph(bucket: int, device: str = "cpu"):
    """The PoseGraph of one bucket of BUCKETS."""
    if BUCKETS[bucket] is None:
        from stiff_graphs import stiff_loop_graph

        return stiff_loop_graph(KITTI00_KEYFRAMES, device,
                                loops=((100, 600), (300, 640)))
    return loop_graph(*BUCKETS[bucket], device=device)


def system_args(g, lam: float = 1e-4):
    """B9's arguments for PoseGraph ``g`` at its padded shapes: (nodes,
    e_i, e_j, Z_inv, sqrt_info, wE, mask, lam), as ops.pose_graph's
    optimize makes them."""
    from slam_tpu_torch.ops import pose_graph as pg
    from slam_tpu_torch.ops import se3

    (nodes, e_i, e_j, Z, si, e_valid), n_valid = g._dense_args()
    N = nodes.shape[0]
    wE = pg._edge_weights(e_valid, e_i, nodes.dtype)
    mask = pg._node_mask(N, nodes.dtype, nodes.device, n_valid)
    return (nodes, e_i, e_j, se3.inverse(Z), si, wE, mask,
            torch.full((), lam, dtype=nodes.dtype, device=nodes.device))


def f64(args):
    return tuple(t.double() if t.is_floating_point() else t for t in args)


def rel_err(x, ref) -> float:
    """max |x - ref| over max |ref|."""
    return float((x.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def check_system(ck, args) -> dict:
    """B9's system against the plain version on float64 copies of
    ``args`` (TOL; A exactly symmetric), and the float32 plain version's
    errors beside it; then B9's step from that system's solution against
    the plain step on float64 copies: the same decision and damping, the
    nodes within 1e-6 of their largest entry (a few float32 roundings),
    and B9's trial cost within TOL["cost"] of the plain cost of B9's own
    trial nodes (rounding them to float32 moves the cost of the 1.3 km
    chain by ~1 %). Returns the errors."""
    from slam_tpu_torch.ops import pose_graph as pg

    k = ck.pg_system(*args)
    p = ck.pg_system_plain(*args)
    a64 = f64(args)
    r = ck.pg_system_plain(*a64)
    errs = {}
    for name, i in (("A", 0), ("rhs", 1)):
        errs[name] = rel_err(k[i], r[i])
        errs[name + "_plain32"] = rel_err(p[i], r[i])
        assert errs[name] <= TOL[name], (name, errs)
    errs["cost"] = rel_err(k[3], r[3])
    errs["cost_plain32"] = rel_err(p[3], r[3])
    assert errs["cost"] <= TOL["cost"], errs
    assert torch.equal(k[0], k[0].T), "A is not exactly symmetric"
    x = torch.linalg.solve(r[0], r[1])
    n_k, c_k, l_k = args[0].clone(), r[3].float(), args[7].clone()
    ck.pg_step(n_k, x.float(), r[2].float(), c_k, l_k, *args[1:6])
    n_p, c_p, l_p = a64[0].clone(), r[3].clone(), a64[7].clone()
    ck.pg_step_plain(n_p, x, r[2], c_p, l_p, *a64[1:6])
    assert torch.equal(l_k, l_p.float()), (l_k, l_p)
    errs["step_nodes"] = rel_err(n_k, n_p)
    accepted = bool(l_k < args[7])
    errs["step_cost"] = rel_err(
        c_k, pg._cost(n_k.double(), *a64[1:6]) if accepted else r[3])
    assert errs["step_nodes"] <= 1e-6 and errs["step_cost"] <= TOL["cost"], \
        errs
    return errs
