"""Kernel B6's plain version, and bundle adjustment's solves through it.

``cuda_kernels.cholesky_solve`` on CPU tensors runs its plain version
(``cholesky_ex`` + ``cholesky_solve``), which is held here against the
JAX package's Pallas kernel ``cholesky_solve_lanes`` in interpret mode and
against float64 numpy on SPD systems with the gauge rows, and against the
JAX package's ``_spd_solve`` on the real reduced systems of a rendered
scene's windows. The CUDA kernel itself is held against the plain version
by the ``cuda`` tests in ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import ba as jba
from slam_tpu.ops import pallas_kernels as pk
from slam_tpu_torch.models import bundle
from slam_tpu_torch.ops import ba
from slam_tpu_torch.ops import cuda_kernels as ck

from tests.test_torch_backend import CFG, jax_run  # noqa: F401 (fixture)
from tests.test_torch_kernels import spd_systems

torch.set_num_threads(2)

SWITCH = "SLAM_TPU_CHOL_LANES"


def rel_err(x, ref):
    """Error relative to max |ref|, per system, the largest over the
    batch."""
    ref = np.asarray(ref, np.float64)
    return float((np.abs(np.asarray(x, np.float64) - ref).max(-1)
                  / np.abs(ref).max(-1)).max())


@pytest.mark.parametrize("B, N", [(12, 48), (4, 144)])
def test_plain_matches_pallas_and_numpy(B, N):
    """The plain version, the Pallas kernel (interpret mode) and a float64
    numpy solve agree within 5e-4 of max |x| (test_pallas_parity.py's
    tolerance for the Pallas kernel against numpy)."""
    S, g = spd_systems(5, B, N)
    ref = np.linalg.solve(S.astype(np.float64),
                          g.astype(np.float64)[..., None])[..., 0]
    x = ck.cholesky_solve(torch.as_tensor(S), torch.as_tensor(g)).numpy()
    x_pk = np.asarray(pk.cholesky_solve_lanes(jnp.asarray(S), jnp.asarray(g),
                                              interpret=True))
    assert rel_err(x, ref) < 5e-4
    assert rel_err(x_pk, ref) < 5e-4
    assert rel_err(x, x_pk) < 5e-4


def failing_systems(case):
    """Eight SPD systems with the gauge rows, of which system 3 fails its
    factorization: at a decoupled pivot of -1 (row and column 20 zero
    elsewhere), or part way, with an eigenvalue of -1 below the gauge."""
    if case == "indefinite":
        return spd_systems(6, 8, 48, bad=(3,))
    S, g = spd_systems(6, 8, 48)
    S[3, 20, :] = 0.0
    S[3, :, 20] = 0.0
    S[3, 20, 20] = -1.0
    return S, g


@pytest.mark.parametrize("case", ["negative pivot", "indefinite"])
def test_failed_system_gives_a_nan_row(case):
    """A system that is not positive definite gets an all-NaN row and the
    others equal their solve without it. At a decoupled negative pivot the
    TPU kernel instead clamps the pivot to 1e-30 and returns a finite row
    (ROADMAP.md queue C)."""
    S, g = failing_systems(case)
    ck.reset_counters()
    x = ck.cholesky_solve(torch.as_tensor(S), torch.as_tensor(g))
    assert ck.PLAIN_CALLS["cholesky_solve"] == 1
    assert torch.isnan(x).all(-1).nonzero().flatten().tolist() == [3]
    keep = [0, 1, 2, 4, 5, 6, 7]
    x_keep = ck.cholesky_solve(torch.as_tensor(S[keep]),
                               torch.as_tensor(g[keep]))
    assert torch.equal(x[keep], x_keep)
    if case == "negative pivot":
        x_pk = np.asarray(pk.cholesky_solve_lanes(
            jnp.asarray(S), jnp.asarray(g), interpret=True))
        assert np.isfinite(x_pk[3]).all()


@pytest.fixture(scope="module")
def windows(jax_run):
    """The reference run's BA windows, built by the port's host code, as
    tensors: (poses0, points0, cam_idx, lm_idx, meas, w, calib)."""
    calib, res = jax_run
    db, T = res.db, res.frontend.T_w2c
    kfs = bundle.select_keyframes(db, T, CFG.keyframes)
    b = bundle.build_windows(db, T, kfs, CFG.bundle)
    bundle.init_landmarks(b, calib)
    return tuple(torch.as_tensor(a) for a in (
        b.poses0, b.points0, b.cam_idx.astype(np.int64),
        b.lm_idx.astype(np.int64), b.meas, b.w,
        np.array(calib, np.float32)))


def test_reduced_systems_solve_like_jax(windows):
    """LM's first reduced systems of the scene's windows (depth prune, one
    Schur setup at lam0 = 1e-4), solved by the port and by the JAX
    package's batched _spd_solve: against the float64 solve, the port's
    error is at most 4x the JAX package's + 1e-6."""
    poses, points, cam, lm, meas, w, calib = windows
    w = ba.prune_depth_weights(poses, points, cam, lm, w)
    J_pose, J_lm, r = ba._linearize(poses, points, cam, lm, meas, w, calib)
    blocks = ba._build_blocks(J_pose, J_lm, r, cam, lm, poses.shape[1],
                              points.shape[1])
    lam = torch.full((poses.shape[0],), 1e-4)
    S, g, _, _ = ba._damped_system(blocks, lam)
    assert S.shape == (poses.shape[0], 6 * CFG.bundle.max_poses,
                       6 * CFG.bundle.max_poses)
    x = ck.cholesky_solve(S, g).numpy()
    x_j = np.asarray(jax.vmap(jba._spd_solve)(jnp.asarray(S.numpy()),
                                              jnp.asarray(g.numpy())))
    ref = np.linalg.solve(S.double().numpy(),
                          g.double().numpy()[..., None])[..., 0]
    assert np.isfinite(x).all() and np.isfinite(x_j).all()
    assert rel_err(x, ref) <= 4.0 * rel_err(x_j, ref) + 1e-6


def test_switch_routes_optimize_bundle_through_b6(windows, monkeypatch):
    """optimize_bundle sends every reduced system through B6's wrapper
    (on the CPU its plain version, counted once per LM iteration), and
    the JAX package's switch SLAM_TPU_CHOL_LANES, set or not, changes
    nothing: the results are equal bit for bit."""
    poses, points, cam, lm, meas, w, calib = (a[:3] if a.dim() > 1 else a
                                              for a in windows)
    outs = []
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv(SWITCH, raising=False)
        else:
            monkeypatch.setenv(SWITCH, value)
        ck.reset_counters()
        outs.append(ba.optimize_bundle(poses, points, cam, lm, meas, w, calib,
                                       iters=3))
        assert ck.PLAIN_CALLS["cholesky_solve"] == 3
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)
    assert float(outs[0][2].sum()) < float(ba._cost(
        poses, points, cam, lm, meas, w, calib).sum())


# ---------------------------------------------------------------------------
# B6's blocked schedule (csrc/cholesky_solve.cu), written out in torch
# ---------------------------------------------------------------------------

def blocked_cholesky_solve(S, g, nb):
    """S x = g by the CUDA kernel's schedule, in float32 torch, batched:
    per block of nb columns, the diagonal block factored column by column,
    right-looking (one warp in the kernel), every pivot checked; the panel
    below it
    solved against the block row by row, 1 / L_jj first; the trailing
    lower triangle updated by one nb-long sum of products per entry. Then
    both substitutions block by block: the diagonal triangle step by step,
    the rest of the right-hand side by one nb-long sum per row. A system
    with a pivot that is not positive or not finite gets an all-NaN row."""
    y = g.clone()
    B, N = g.shape
    A = torch.tril(S)
    dinv = torch.zeros((B, N))
    failed = torch.zeros(B, dtype=torch.bool)
    blocks = [(kb, min(kb + nb, N)) for kb in range(0, N, nb)]
    for kb, e in blocks:
        for k in range(kb, e):
            d = A[:, k, k]
            failed |= ~((d > 0) & (d < float("inf")))
            dinv[:, k] = torch.rsqrt(d)
            A[:, k + 1:e, k] *= dinv[:, k, None]
            lk = A[:, k + 1:e, k]
            A[:, k + 1:e, k + 1:e] -= torch.tril(lk[:, :, None] * lk[:, None])
        if e == N:
            continue
        for j in range(kb, e):
            A[:, e:, j] *= dinv[:, j, None]
            A[:, e:, j + 1:e] -= A[:, e:, j, None] * A[:, None, j + 1:e, j]
        L21 = A[:, e:, kb:e]
        A[:, e:, e:] -= torch.tril(L21 @ L21.transpose(1, 2))
    for kb, e in blocks:
        for k in range(kb, e):
            y[:, k] *= dinv[:, k]
            y[:, k + 1:e] -= A[:, k + 1:e, k] * y[:, k, None]
        y[:, e:] -= (A[:, e:, kb:e] @ y[:, kb:e, None])[..., 0]
    for kb, e in reversed(blocks):
        for k in reversed(range(kb, e)):
            y[:, k] *= dinv[:, k]
            y[:, kb:k] -= A[:, k, kb:k] * y[:, k, None]
        y[:, :kb] -= (A[:, kb:e, :kb].transpose(1, 2)
                      @ y[:, kb:e, None])[..., 0]
    return torch.where(failed[:, None], float("nan"), y)


_PALLAS = {}


def pallas_solve(S, g):
    key = (S.shape, S.tobytes(), g.tobytes())
    if key not in _PALLAS:
        _PALLAS[key] = np.asarray(pk.cholesky_solve_lanes(
            jnp.asarray(S), jnp.asarray(g), interpret=True))
    return _PALLAS[key]


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("N", [12, 16, 17, 33, 144])
def test_blocked_schedule_matches_pallas_and_float64(N, nb):
    """The blocked schedule, with N a multiple of nb or not, against the
    float64 solve: its error relative to max |x| at most 4x the plain
    version's + 1e-6 (chip_smoke.py phase 2d's rule), and the same
    against the Pallas kernel's error."""
    S, g = spd_systems(11, 4, N)
    ref = np.linalg.solve(S.astype(np.float64),
                          g.astype(np.float64)[..., None])[..., 0]
    x = blocked_cholesky_solve(torch.as_tensor(S), torch.as_tensor(g), nb)
    x_plain = ck.cholesky_solve(torch.as_tensor(S), torch.as_tensor(g))
    e = rel_err(x.numpy(), ref)
    assert np.isfinite(x.numpy()).all()
    assert e <= 4.0 * rel_err(x_plain.numpy(), ref) + 1e-6
    assert e <= 4.0 * rel_err(pallas_solve(S, g), ref) + 1e-6


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("pivot", [10, 70, 140])
def test_blocked_schedule_fails_in_any_block(pivot, nb):
    """A decoupled pivot of -1 in the first, a middle or the last block
    of N = 144: that system's row is all NaN in the schedule and NaN in
    the plain version, and the other systems solve as they do alone."""
    S, g = spd_systems(12, 3, 144)
    S[1, pivot, :] = 0.0
    S[1, :, pivot] = 0.0
    S[1, pivot, pivot] = -1.0
    St, gt = torch.as_tensor(S), torch.as_tensor(g)
    x = blocked_cholesky_solve(St, gt, nb)
    assert torch.isnan(x).all(-1).tolist() == [False, True, False]
    assert torch.isnan(ck.cholesky_solve(St, gt)[1]).all()
    keep = [0, 2]
    assert torch.equal(x[keep], blocked_cholesky_solve(St[keep], gt[keep], nb))
