"""The pose graph's dense ops at the JAX package's padded buckets.

The JAX package pads the pose graph to static buckets (its
``PoseGraph._padded_edges`` / ``_padded_nodes``: 64 edges, 64 nodes,
8192 gate pairs) and passes ``e_valid`` / ``n_valid`` to every op. Here
the same padded arrays, made from a numpy seed, go through the JAX ops
and the port's: ``optimize``, ``gn_hessian_inverse``, ``gate_matrix`` and
``marginal_logdets``, at N = 17, 64 and 65 nodes and E = 64 and 65 edges
(both sides of each bucket's edge), with tests/test_torch_backend.py's
tolerances (nodes 5 mm / 0.01 deg, distances 2 %, the same pairs failing
closed, the covariance within 2 % of its largest entry, log-dets 0.05).
The port's padded calls are also held to its unpadded ones, and its
``PoseGraph`` to the JAX package's padding, array for array. The
``cuda``-marked tests replay the four ops from their CUDA graphs at the
same buckets against the port's CPU run; they skip here. The module
imports JAX only inside the functions that call it: the card tests run
where JAX is absent.
"""

import functools

import numpy as np
import pytest
import torch

from slam_tpu_torch.models import pose_graph as pg_model
from slam_tpu_torch.models.pose_graph import PoseGraph
from slam_tpu_torch.ops import pose_graph as pg
from slam_tpu_torch.ops import se3
from slam_tpu_torch.runtime import graphs

torch.set_num_threads(2)

# (nodes, edges): around the 64 buckets of both
CASES = [(17, 64), (17, 65), (64, 64), (64, 65), (65, 64), (65, 65)]
ITERS = 15
# odometry and loop-edge noise (rotation rad, translation m)
ODO_SIGMA, LOOP_SIGMA = (0.002, 0.02), (0.01, 0.1)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _noisy(T, sigma, rng):
    xi = np.concatenate([rng.normal(0, sigma[0], 3),
                         rng.normal(0, sigma[1], 3)]).astype(np.float32)
    return se3.retract(torch.from_numpy(T), torch.from_numpy(xi)).numpy()


def _sqrt_info(sigma):
    return np.diag([1 / sigma[0]] * 3 + [1 / sigma[1]] * 3).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def make_graph(N, E, seed=0):
    """A drifting odometry chain of N keyframes around a 20 m loop and
    E - (N - 1) loop edges between keyframes at least 3 apart, as the
    JAX package's PoseGraph holds them (chain first, loops appended)."""
    rng = np.random.default_rng(seed + 1000 * N + E)
    ang = np.linspace(0, 2 * np.pi * (N - 1) / N, N)
    T_gt = np.zeros((N, 4, 4), np.float32)
    for i, a in enumerate(ang):
        c = 20 * np.array([1 - np.cos(a), 0.1 * np.sin(3 * a), np.sin(a)])
        R = _ry(a)
        T_gt[i, :3, :3] = R.T
        T_gt[i, :3, 3] = -R.T @ c
        T_gt[i, 3, 3] = 1
    Z = [_noisy(T_gt[k + 1] @ np.linalg.inv(T_gt[k]), ODO_SIGMA, rng)
         for k in range(N - 1)]
    cand = [(i, j) for i in range(N) for j in range(i + 3, N)]
    loops = [cand[k] for k in rng.choice(len(cand), E - (N - 1),
                                         replace=False)]
    Z += [_noisy(T_gt[j] @ np.linalg.inv(T_gt[i]), LOOP_SIGMA, rng)
          for i, j in loops]
    nodes = np.zeros_like(T_gt)
    nodes[0] = T_gt[0]
    for k in range(N - 1):
        nodes[k + 1] = Z[k] @ nodes[k]
    K = len(loops)
    return dict(
        nodes=nodes, keyframes=list(range(N)),
        e_i=np.array(list(range(N - 1)) + [i for i, _ in loops], np.int32),
        e_j=np.array(list(range(1, N)) + [j for _, j in loops], np.int32),
        Z=np.stack(Z).astype(np.float32),
        sqrt_info=np.stack([_sqrt_info(ODO_SIGMA)] * (N - 1)
                           + [_sqrt_info(LOOP_SIGMA)] * K),
        is_loop=np.array([False] * (N - 1) + [True] * K))


@functools.lru_cache(maxsize=None)
def padded(N, E):
    """The JAX package's padded arrays of make_graph(N, E): (nodes, e_i,
    e_j, Z, sqrt_info, e_valid), n_valid, and the gate's pairs (every
    j < i pair, padded to its _PAIR_PAD bucket) with their count."""
    from slam_tpu.models.pose_graph import _PAIR_PAD
    from slam_tpu.models.pose_graph import PoseGraph as JPoseGraph

    g = JPoseGraph(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                      for k, v in make_graph(N, E).items()})
    e_i, e_j, Z, si, valid = g._padded_edges()
    nodes, n_valid = g._padded_nodes()
    ii, jj = np.tril_indices(N, k=-1)
    P = len(ii)
    cap = max(_PAIR_PAD, -(-P // _PAIR_PAD) * _PAIR_PAD)
    pi, pj = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    pi[:P], pj[:P] = jj, ii
    return (nodes, e_i, e_j, Z, si, valid), n_valid, (pi, pj), P


def jax_args(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def torch_args(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def rot_deg(A, B):
    """Rotation difference in degrees as |R_A - R_B|_F / sqrt(2)
    (tests/test_torch_backend.py's: arccos of the trace floors at ~0.02
    deg in float32)."""
    d = np.asarray(A[..., :3, :3], np.float64) - B[..., :3, :3]
    return np.degrees(np.sqrt((d * d).sum((-1, -2)) / 2.0))


@functools.lru_cache(maxsize=None)
def jax_results(N, E):
    import jax.numpy as jnp
    from slam_tpu.ops import pose_graph as jpg

    args, n_valid, (pi, pj), _ = padded(N, E)
    a, nv = jax_args(args), jnp.asarray(n_valid)
    nodes, cost = jpg.optimize(*a, iters=ITERS, n_valid=nv)
    return {"nodes": np.asarray(nodes), "cost": float(cost),
            "C": np.asarray(jpg.gn_hessian_inverse(*a, n_valid=nv)),
            "d": np.asarray(jpg.gate_matrix(*a, jnp.asarray(pi),
                                            jnp.asarray(pj), n_valid=nv)),
            "logdets": tuple(np.asarray(x) for x in jpg.marginal_logdets(
                *a, n_valid=nv))}


@functools.lru_cache(maxsize=None)
def port_results(N, E, pad=True):
    """The port's four ops on the padded arrays (pad) or on the graph as
    it is (no masks), on the CPU."""
    if pad:
        args, n_valid, (pi, pj), _ = padded(N, E)
        a, kw = torch_args(args), {"n_valid": torch.from_numpy(n_valid)}
    else:
        g = make_graph(N, E)
        ii, jj = np.tril_indices(N, k=-1)
        pi, pj = jj, ii
        a = torch_args([g["nodes"], g["e_i"], g["e_j"], g["Z"],
                        g["sqrt_info"]]) + [None]
        kw = {}
    nodes, cost = pg.optimize(*a, iters=ITERS, **kw)
    return {"nodes": nodes.numpy(), "cost": float(cost),
            "C": pg.gn_hessian_inverse(*a, **kw).numpy(),
            "d": pg.gate_matrix(*a, *torch_args([pi, pj]), **kw).numpy(),
            "logdets": tuple(x.numpy() for x in pg.marginal_logdets(*a,
                                                                    **kw))}


@pytest.mark.parametrize("N,E", CASES)
def test_padding_equals_jax(N, E):
    """The port's PoseGraph pads edges and nodes as the JAX package's does,
    array for array, to the same buckets."""
    from slam_tpu.models.pose_graph import PoseGraph as JPoseGraph

    g = make_graph(N, E)
    ours = PoseGraph(**g, device="cpu")
    ref = JPoseGraph(**g)
    for a, b in zip(ours._padded_edges() + ours._padded_nodes(),
                    ref._padded_edges() + ref._padded_nodes()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    (nodes, *edges), n_valid = ours._dense_args()
    assert nodes.shape[0] == -(-N // 64) * 64
    assert edges[0].shape[0] == -(-E // 64) * 64
    assert int(n_valid.sum()) == N and int(edges[-1].sum()) == E


@pytest.mark.parametrize("N,E", CASES)
def test_optimize_padded_matches_jax(N, E):
    """LM on the padded graph: the valid nodes within 5 mm / 0.01 deg of
    the JAX package's, the padded nodes left at the identity, the cost
    within 1 %."""
    got, want = port_results(N, E), jax_results(N, E)
    np.testing.assert_allclose(got["nodes"][:N, :3, 3],
                               want["nodes"][:N, :3, 3], atol=5e-3)
    assert rot_deg(got["nodes"][:N], want["nodes"][:N]).max() < 1e-2
    np.testing.assert_array_equal(got["nodes"][N:],
                                  np.tile(np.eye(4), (len(got["nodes"]) - N,
                                                      1, 1)))
    assert abs(got["cost"] - want["cost"]) <= 1e-2 * want["cost"] + 1e-3
    # LM moved the nodes: the loop edges pulled the drifted chain
    g = make_graph(N, E)
    moved = np.abs(got["nodes"][:N, :3, 3] - g["nodes"][:, :3, 3]).max()
    assert moved > 1e-3 or E == N - 1


@pytest.mark.parametrize("N,E", CASES)
def test_covariance_padded_matches_jax(N, E):
    """gn_hessian_inverse and marginal_logdets on the padded graph: the
    covariance within 2 % of its largest entry and zero on the padded and
    gauge nodes, as the JAX package's; the log-dets within 0.05."""
    got, want = port_results(N, E), jax_results(N, E)
    Ct, Cj = got["C"], want["C"]
    assert Ct.shape == Cj.shape
    assert np.abs(Ct - Cj).max() <= 2e-2 * np.abs(Cj).max()
    assert not Ct[N:].any() and not Ct[:, :, N:].any()
    assert not Ct[0].any() and not Ct[:, :, 0].any()
    for lt, lj in zip(got["logdets"], want["logdets"]):
        np.testing.assert_allclose(lt[1:N], lj[1:N], atol=5e-2)
        np.testing.assert_array_equal(lt[N:], lj[N:])


@pytest.mark.parametrize("N,E", CASES)
def test_gate_matrix_padded_matches_jax(N, E):
    """The gate sweep over every pair padded to its bucket: distances
    within 2 %, the same pairs failing closed (inf)."""
    _, _, (pi, _), P = padded(N, E)
    dt, dj = port_results(N, E)["d"], jax_results(N, E)["d"]
    assert dt.shape == dj.shape == pi.shape
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    f = np.isfinite(dj)
    assert f[:P].sum() > 0.9 * P
    np.testing.assert_allclose(dt[f], dj[f], rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("N,E", CASES)
def test_padded_equals_unpadded(N, E):
    """The port's ops on the padded graph against the same ops on the
    graph as it is: padded rows decouple, so the valid entries agree to
    float32 rounding of the dense solves (nodes 1e-4 m / 1e-3 deg,
    covariance 1e-3 of its largest entry, distances 1e-3 relative,
    log-dets 1e-3)."""
    a, b = port_results(N, E), port_results(N, E, pad=False)
    _, _, _, P = padded(N, E)
    np.testing.assert_allclose(a["nodes"][:N, :3, 3], b["nodes"][:, :3, 3],
                               atol=1e-4)
    assert rot_deg(a["nodes"][:N], b["nodes"]).max() < 1e-3
    Ca = a["C"][:N, :, :N, :]
    assert np.abs(Ca - b["C"]).max() <= 1e-3 * np.abs(b["C"]).max()
    np.testing.assert_array_equal(np.isfinite(a["d"][:P]),
                                  np.isfinite(b["d"]))
    f = np.isfinite(b["d"])
    np.testing.assert_allclose(a["d"][:P][f], b["d"][f], rtol=1e-3,
                               atol=1e-4)
    for x, y in zip(a["logdets"], b["logdets"]):
        np.testing.assert_allclose(x[1:N], y[1:], atol=1e-3)


def test_defaults_are_every_entry_valid():
    """e_valid / n_valid default to every entry valid: the same result,
    bit for bit, as masks of all True."""
    g = make_graph(17, 20)
    a = torch_args([g["nodes"], g["e_i"], g["e_j"], g["Z"],
                    g["sqrt_info"]])
    ev, nv = torch.ones(20, dtype=torch.bool), torch.ones(17,
                                                          dtype=torch.bool)
    for x, y in zip(pg.optimize(*a, iters=5),
                    pg.optimize(*a, ev, iters=5, n_valid=nv)):
        assert torch.equal(x, y)
    assert torch.equal(pg.gn_hessian_inverse(*a),
                       pg.gn_hessian_inverse(*a, ev, nv))


def test_model_pads_and_slices_back(monkeypatch):
    """PoseGraph's dense optimize, covariance_full, marginal_logdets and
    gate_distances call the ops at the bucket's shapes and return the
    first N (or P) entries of what the ops return there."""
    N, E = 17, 40
    g = make_graph(N, E)
    seen = []
    for name in ("optimize", "gn_hessian_inverse", "gate_matrix",
                 "marginal_logdets"):
        f = getattr(pg, name)

        def spy(*a, _f=f, _n=name, **kw):
            seen.append((_n, a[0].shape[0], a[1].shape[0],
                         kw["n_valid"].shape[0]))
            return _f(*a, **kw)

        monkeypatch.setattr(pg, name, spy)
    model = PoseGraph(**g, device="cpu")
    ii, jj = np.tril_indices(N, k=-1)
    d = model.gate_distances(jj, ii)
    C = model.covariance_full()
    loc, rot = model.marginal_logdets()
    model.optimize(iters=ITERS)
    assert seen == [(n, 64, 64, 64) for n in (
        "gate_matrix", "gn_hessian_inverse", "marginal_logdets", "optimize")]
    assert d.shape == (len(ii),) and C.shape == (N, 6, N, 6)
    assert loc.shape == rot.shape == (N,) and model.nodes.shape == (N, 4, 4)
    monkeypatch.undo()
    args, n_valid, (pi, pj), P = padded(N, E)
    ref = pg.gate_matrix(*torch_args(args), *torch_args([pi, pj]),
                         n_valid=torch.from_numpy(n_valid))
    np.testing.assert_array_equal(d, ref.numpy()[:len(ii)])
    from slam_tpu.models import pose_graph as jpg

    assert (pg_model._EDGE_PAD, pg_model._NODE_PAD, pg_model._PAIR_PAD) \
        == (jpg._EDGE_PAD, jpg._NODE_PAD, jpg._PAIR_PAD)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def port_padded(N, E, device):
    """The port's PoseGraph's padded arrays (equal to the JAX package's,
    test_padding_equals_jax) on ``device``: (args, n_valid, pairs, P)."""
    g = PoseGraph(**make_graph(N, E), device="cpu")
    args, n_valid = g._dense_args()
    ii, jj = np.tril_indices(N, k=-1)
    pi, pj = g._padded_pairs(jj, ii)
    to = [torch.as_tensor(x).to(device) for x in (*args, n_valid, pi, pj)]
    return tuple(to[:6]), to[6], tuple(to[7:]), len(ii)


def four_ops(args, n_valid, pairs):
    nodes, cost = pg.optimize(*args, iters=ITERS, n_valid=n_valid)
    return {"nodes": nodes, "cost": cost,
            "C": pg.gn_hessian_inverse(*args, n_valid=n_valid),
            "d": pg.gate_matrix(*args, *pairs, n_valid=n_valid),
            "logdets": pg.marginal_logdets(*args, n_valid=n_valid)}


@pytest.mark.cuda
@pytest.mark.parametrize("N,E", CASES)
def test_cuda_graphed_ops_match_the_cpu(N, E):
    """The four ops from their CUDA graphs (a warm-up, a capture, a
    replay) at the padded buckets against the port's CPU run of the same
    arrays, with the JAX parity's tolerances; one key per op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    graphs.clear()
    try:
        want = four_ops(*port_padded(N, E, "cpu")[:3])
        got = [four_ops(*port_padded(N, E, "cuda")[:3]) for _ in range(3)]
        stats = graphs.stats()
    finally:
        graphs.clear()
    got = {k: (tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple)
               else v.cpu().numpy()) for k, v in got[-1].items()}
    want = {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple)
                else v.numpy()) for k, v in want.items()}
    for name in ("optimize", "gn_hessian_inverse", "gate_matrix",
                 "marginal_logdets"):
        st = stats[f"ops.pose_graph.{name}"]
        assert (st["keys"], st["captures"], st["replays"]) == (1, 1, 2)
    np.testing.assert_allclose(got["nodes"][:N, :3, 3],
                               want["nodes"][:N, :3, 3], atol=5e-3)
    assert rot_deg(got["nodes"][:N], want["nodes"][:N]).max() < 1e-2
    Cg, Cw = got["C"], want["C"]
    assert np.abs(Cg - Cw).max() <= 2e-2 * np.abs(Cw).max()
    assert not Cg[N:].any() and not Cg[0].any()
    np.testing.assert_array_equal(np.isfinite(got["d"]),
                                  np.isfinite(want["d"]))
    f = np.isfinite(want["d"])
    np.testing.assert_allclose(got["d"][f], want["d"][f], rtol=2e-2,
                               atol=1e-2)
    for lg, lw in zip(got["logdets"], want["logdets"]):
        np.testing.assert_allclose(lg[1:N], lw[1:N], atol=5e-2)
