"""Kernel B7 (``cuda_kernels.schur_reduce`` / ``schur_back``): bundle
adjustment's reduced pose system built from each window's observations,
and the landmark steps.

On the CPU the wrappers run the plain version, ``ops.ba``'s dense blocks,
which is held here to the formulas ``ops.ba`` computed before B7, bit for
bit; ``_slot_table``, B7's index, is held to a numpy construction. The
tests marked ``cuda`` hold the kernel against the plain version on the
card, at the shapes of the main path, and skip without one. No JAX is
imported, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_schur_reduce.py
"""

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import ba, se3, stereo
from slam_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

CALIB = (718.856, 718.856, 607.1928, 185.2157, 0.5372)


def windows(B, P, L, M, seed=0, device="cpu", pad=0, pruned=(),
            short=None):
    """B seeded windows (chip_smoke.py's synthetic ones): P cameras 1 m
    apart along the optical axis, L landmarks 8-60 m ahead, each seen by
    M // L distinct cameras (the last ``pad`` lanes of a window are
    padding instead: zero weight at landmark 0 from camera 0), stereo
    measurements with 0.5 px noise, the state perturbed. Landmarks in
    ``pruned`` get zero weight on every lane; window 0 with ``short``
    keeps only its first ``short`` poses (the others' lanes at zero
    weight). Returns (poses, points, cam, lm, meas, w, calib)."""
    gen = torch.Generator().manual_seed(seed)
    calib = torch.tensor(CALIB)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    per = (M - pad) // L
    T = torch.eye(4).repeat(B, P, 1, 1)
    T[..., 2, 3] = -torch.arange(P, dtype=torch.float32)
    lo = torch.tensor([-12.0, -3.0, P + 8.0])
    hi = torch.tensor([12.0, 3.0, P + 60.0])
    X = lo + (hi - lo) * torch.rand((B, L, 3), generator=gen)
    cam = torch.argsort(torch.rand((B, L, P), generator=gen),
                        dim=-1)[..., :per].reshape(B, L * per)
    lm = torch.arange(L).repeat_interleave(per).repeat(B, 1)
    n_pad = M - L * per
    cam = torch.cat([cam, torch.zeros((B, n_pad), dtype=cam.dtype)], 1)
    lm = torch.cat([lm, torch.zeros((B, n_pad), dtype=lm.dtype)], 1)
    b = torch.arange(B)[:, None]
    Tc, Xo = T[b, cam], X[b, lm]
    Xc = se3.mv3(Tc[..., :3, :3], Xo) + Tc[..., :3, 3]
    meas = stereo.project(calib, Xc) + 0.5 * randn(B, M, 3)
    delta = torch.cat([0.005 * randn(B, P, 3), 0.05 * randn(B, P, 3)], -1)
    delta[:, 0] = 0.0
    poses0 = se3.retract(T, delta)
    points0 = X + 0.1 * randn(B, L, 3)
    w = torch.ones((B, M))
    w[:, L * per:] = 0.0
    for l in pruned:
        w[lm == l] = 0.0
    if short is not None:
        w[0][cam[0] >= short] = 0.0
    out = (poses0, points0, cam, lm, meas, w, calib)
    return tuple(x.to(device) for x in out)


SLOT, LAM = 7, 8  # where b7_args puts them


def b7_args(win, lam_scale=1e-4):
    """B7's arguments at the windows' state: (poses, points, cam, lm,
    meas, w, calib, slot, lam), lam different in every window."""
    poses, points, cam, lm, meas, w, calib = win
    slot = ba._slot_table(cam, lm, w, poses.shape[1], points.shape[1])
    B = poses.shape[0]
    lam = lam_scale * (1.0 + torch.arange(B, dtype=torch.float32,
                                          device=poses.device))
    return win + (slot, lam)


# ---------------------------------------------------------------------------
# on the CPU: the index and the plain path
# ---------------------------------------------------------------------------

def slot_table_numpy(cam, lm, w, P, L):
    out = np.full((cam.shape[0], L, P), -1, np.int64)
    for b in range(cam.shape[0]):
        for m in range(cam.shape[1]):
            if w[b, m] != 0:
                out[b, lm[b, m], cam[b, m]] = max(out[b, lm[b, m],
                                                      cam[b, m]], m)
    return out


@pytest.mark.parametrize("case", ["padded", "pair at the padding's slot",
                                  "seen once", "all padding"])
def test_slot_table_matches_numpy(case):
    """_slot_table against a loop in numpy: each pair's lane of nonzero
    weight, -1 elsewhere; padded lanes (zero weight at landmark 0 from
    camera 0) never hide that pair's own observation."""
    rng = np.random.default_rng(3)
    B, P, L, M = 3, 4, 6, 20
    cam = np.zeros((B, M), np.int64)
    lm = np.zeros((B, M), np.int64)
    w = np.zeros((B, M), np.float32)
    for b in range(B):
        pairs = rng.permutation(P * L)[:12]
        cam[b, :12], lm[b, :12] = pairs % P, pairs // P
        w[b, :12] = rng.uniform(0.5, 2.0, 12)
    if case == "pair at the padding's slot":
        cam[:, 0], lm[:, 0] = 0, 0
        cam[:, 1:12][(cam[:, 1:12] == 0) & (lm[:, 1:12] == 0)] = 1
    if case == "seen once":
        keep = (lm[:, :12] != 5)
        w[:, :12] *= keep
        cam[:, 2], lm[:, 2], w[:, 2] = 3, 5, 1.0
    if case == "all padding":
        w[1] = 0.0
    got = ba._slot_table(torch.from_numpy(cam), torch.from_numpy(lm),
                         torch.from_numpy(w), P, L)
    assert got.dtype == torch.int32 and got.shape == (B, L, P)
    want = slot_table_numpy(cam, lm, w, P, L)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "pair at the padding's slot":
        assert (got[:, 0, 0] == 0).all()
    if case == "seen once":
        assert ((got[:, 5] >= 0).sum(-1) == 1).all()
    if case == "all padding":
        assert (got[1] == -1).all()


def blocks_before_b7(args, huber_delta=0.0):
    """ops.ba's LM system as it was computed before B7, written out here:
    the linearization, (S, ghat, Bm, Hll_inv), and the covariances' S from
    the same terms."""
    poses, points, cam, lm, meas, w, calib, _, lam = args
    P, L = poses.shape[1], points.shape[1]
    J_pose, J_lm, r = ba._linearize(poses, points, cam, lm, meas, w, calib,
                                    huber_delta)
    g_p, g_l, Hpp, Hll, Wc = ba._build_blocks(J_pose, J_lm, r, cam, lm, P, L)
    eye6, eye3 = torch.eye(6), torch.eye(3)
    Hpp_d = Hpp + lam[:, None, None, None] * eye6
    Hll_inv = ba._inv3x3(Hll + lam[:, None, None, None] * eye3 + 1e-8 * eye3)
    S, ghat, Bm = ba._reduced_system(Hpp_d, Hll_inv, Wc, g_p, g_l)
    S_cov, _, _ = ba._reduced_system(Hpp, ba._inv3x3(Hll + 1e-6 * eye3), Wc,
                                     g_p, g_l)
    return S, ghat, Bm, Hll_inv, S_cov + 1e-8 * torch.eye(P * 6)


@pytest.mark.parametrize("case", ["full", "padded and pruned", "short",
                                  "huber"])
def test_cpu_wrapper_takes_the_plain_path_unchanged(case):
    """On CPU tensors schur_reduce and schur_back run the plain version
    (no launch), and give the blocks, landmark steps and covariance
    system of the formulas before B7 bit for bit."""
    kw = {"padded and pruned": {"pad": 12, "pruned": (1, 4)},
          "short": {"short": 3}}.get(case, {})
    huber = 2.0 if case == "huber" else 0.0
    args = b7_args(windows(2, 5, 10, 52, seed=1, **kw))
    S0, g0, Bm0, Hi0, Sc0 = blocks_before_b7(args, huber)
    ck.reset_counters()
    S, ghat, Hll_inv, g_l, cross = ck.schur_reduce(*args, huber_delta=huber)
    assert ck.PLAIN_CALLS["schur_reduce"] == 1
    assert ck.LAUNCHES["schur_reduce"] == 0
    for got, want in ((S, S0), (ghat, g0), (cross, Bm0), (Hll_inv, Hi0)):
        assert torch.equal(got, want)
    dp = torch.linspace(-1e-2, 1e-2, 6 * 5).repeat(2, 1)
    slot = args[SLOT]
    assert torch.equal(ck.schur_back(dp, slot, cross, Hll_inv, g_l),
                       ba._back_substitute(dp, Bm0, Hi0, g_l))
    S_cov = ck.schur_reduce(*args[:LAM], None, eps_l=1e-6, eps_s=1e-8,
                            huber_delta=huber)[0]
    assert torch.equal(S_cov, Sc0)
    if not huber:
        assert torch.equal(ba._covariance_system(*args[:SLOT]), Sc0)
    assert ck.PLAIN_CALLS["schur_reduce"] == 2 + (not huber)
    assert ck.LAUNCHES["schur_reduce"] == 0


def test_cpu_wrapper_checks_its_shapes():
    """The wrapper refuses arguments of the wrong shape before it
    dispatches."""
    args = b7_args(windows(1, 3, 4, 8))
    with pytest.raises(ValueError, match="poses"):
        ck.schur_reduce(args[0][..., :3], *args[1:])
    with pytest.raises(ValueError, match="do not match"):
        ck.schur_reduce(*args[:5], args[5][:, :4], *args[6:])
    with pytest.raises(ValueError, match="slot"):
        ck.schur_reduce(*args[:SLOT], args[SLOT][0], args[LAM])


# ---------------------------------------------------------------------------
# on the card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the window BA's slices (device_batch 64, and the loops' 16 windows) and
# the loop-closure pair refinement (one window of 2 poses)
SHAPES = [(16, 24, 512, 4096), (64, 24, 512, 4096), (1, 2, 512, 1024)]
CASES = {"full": {}, "padded, a pruned landmark, a short window":
         {"pad": 96, "pruned": (7, 300), "short": 17}}


def rel_err(x, ref):
    """Largest |x - ref| over each window's largest |ref|, the worst
    window's."""
    B = ref.shape[0]
    d = (x.double() - ref).abs().reshape(B, -1).amax(-1)
    return float((d / ref.abs().reshape(B, -1).amax(-1).clamp_min(1e-30))
                 .max())


def f64(args):
    """B7's arguments with the floating ones in float64 (the plain
    version's reference)."""
    return tuple(t.double() if t.is_floating_point() else t for t in args)


# float32 tolerance: the kernel's error against the float64 system, per
# window relative to its largest entry, at most 4x the plain version's
# (its sums in another order) + ATOL. What is built from the Jacobians
# alone (S, Hll_inv without Huber weights) takes ATOL 1e-6. What is built
# from the residuals (ghat, g_l, the landmark steps; everything under
# Huber weights) takes 1e-3: a residual of ~0.5 px is the difference of a
# projection of up to ~1241 px and its measurement, so the float32
# rounding of the projection alone leaves ~2^-24 * 1241 / 0.5 ~ 1.5e-4 of
# it, and the kernel (fused multiply-adds) and torch round it apart.
JAC_ONLY = ("S", "Hll_inv")


def within(x_k, x_p, x_64, label, from_jacobians=False):
    e_k, e_p = rel_err(x_k, x_64), rel_err(x_p, x_64)
    atol = 1e-6 if from_jacobians else 1e-3
    assert e_k <= 4.0 * e_p + atol, (label, e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_schur_reduce_matches_plain(cuda, shape, case):
    """S, ghat, Hll_inv, g_l and the landmark steps of B7 against the
    plain version on the card, both against float64, for the LM's damped
    system (also under Huber weights) and the covariances'; S exactly
    symmetric, the gauge rows identity."""
    B, P, L, M = shape
    kw = dict(CASES[case])
    if P < 3:
        kw.pop("short", None)
    args = b7_args(windows(*shape, seed=B + P, device=cuda, **kw))
    slot = args[SLOT]
    for lam_on, huber in ((True, 0.0), (True, 3.0), (False, 0.0)):
        eps = {"huber_delta": huber}
        if not lam_on:
            eps.update(eps_l=1e-6, eps_s=1e-8)
        lam = args[LAM] if lam_on else None
        k = ck.schur_reduce(*args[:LAM], lam, **eps)
        p = ck.schur_reduce_plain(*args[:LAM], lam, **eps)
        a64 = f64(args)
        r64 = ck.schur_reduce_plain(*a64[:LAM], a64[LAM] if lam_on else None,
                                    **eps)
        for name, i in (("S", 0), ("ghat", 1), ("Hll_inv", 2), ("g_l", 3)):
            within(k[i], p[i], r64[i], f"{name} lam={lam_on} huber={huber}",
                   name in JAC_ONLY and not huber)
        S = k[0]
        assert torch.equal(S, S.transpose(1, 2))
        assert torch.equal(S[:, :6, :6], torch.eye(6, device=cuda)
                           .expand(B, 6, 6))
        assert (S[:, :6, 6:] == 0).all() and (k[1][:, :6] == 0).all()
    # the landmark steps from one pose step (the float64 solve's)
    k = ck.schur_reduce(*args)
    p = ck.schur_reduce_plain(*args)
    r64 = ck.schur_reduce_plain(*f64(args))
    dp = -torch.linalg.solve(r64[0], r64[1])
    dl_k = ck.schur_back(dp.float(), slot, k[4], k[2], k[3])
    dl_p = ck.schur_back_plain(dp.float(), slot, p[4], p[2], p[3])
    dl_64 = ck.schur_back_plain(dp, slot, r64[4], r64[2], r64[3])
    within(dl_k, dl_p, dl_64, "dl")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 64])
def test_cuda_schur_reduce_repeats_and_ignores_its_batch(cuda, B):
    """Two launches give the same system and steps bit for bit, and window
    k alone gives what it gives inside a batch of B."""
    args = b7_args(windows(B, 24, 512, 4096, seed=5, device=cuda, pad=64,
                           pruned=(11,), short=20))
    slot = args[SLOT]
    dp = torch.linspace(-1e-3, 1e-3, 6 * 24, device=cuda).repeat(B, 1)
    runs = []
    for _ in range(2):
        out = ck.schur_reduce(*args)
        runs.append(out[:4] + (ck.schur_back(dp, slot, out[4], out[2],
                                             out[3]),))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for k in (0, 1, B - 1):
        one = tuple(t if t.dim() == 1 and t.shape[0] == 5 else t[k:k + 1]
                    for t in args[:LAM]) + (args[LAM][k:k + 1],)
        out = ck.schur_reduce(*one)
        dl = ck.schur_back(dp[k:k + 1], one[SLOT], out[4], out[2], out[3])
        for a, b in zip(out[:4] + (dl,), runs[0]):
            assert torch.equal(a[0], b[k])


@pytest.mark.cuda
def test_cuda_schur_reduce_refuses_what_it_cannot_take(cuda):
    """More pose rows than B7 or B6 takes raises; it never falls back."""
    args = b7_args(windows(1, 3, 8, 16, device=cuda))
    ck.build()
    P = min(ck.schur_max_poses, ck.cholesky_max_n // 6) + 1
    poses = torch.eye(4, device=cuda).repeat(1, P, 1, 1)
    slot = torch.full((1, 8, P), -1, dtype=torch.int32, device=cuda)
    ck.reset_counters()
    with pytest.raises(ValueError, match="pose rows"):
        ck.schur_reduce(poses, *args[1:SLOT], slot, args[LAM])
    with pytest.raises(ValueError, match="int32"):
        ck.schur_reduce(*args[:SLOT], args[SLOT].long(), args[LAM])
    assert ck.PLAIN_CALLS["schur_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape, iters", [((4, 24, 512, 4096), 20),
                                          ((1, 2, 512, 1024), 15)])
def test_cuda_solve_windows_matches_plain(cuda, shape, iters):
    """The whole solve_windows on the card (B7 and B6) against its plain
    path on the CPU; B7 launched once per assembly: B6's launches (one
    per LM iteration) plus one for the covariances."""
    from slam_tpu_torch.runtime import graphs

    B = shape[0]
    # the pair's every landmark seen by both poses (M = 2L), as in the
    # refinement, where each inlier is; the slices with padded lanes
    win = windows(*shape, seed=9, pad=0 if shape[1] == 2 else 32,
                  pruned=(3,))
    last = torch.full((B,), shape[1] - 1, dtype=torch.int64)
    args = win[:6] + (last, win[6])
    want = ba.solve_windows(*args, iters=iters)
    with graphs.eager():
        ck.reset_counters()
        got = ba.solve_windows(*(a.to(cuda) for a in args), iters=iters)
        launches = dict(ck.LAUNCHES)
    assert launches["cholesky_solve"] == 2 * iters
    assert launches["schur_reduce"] == launches["cholesky_solve"] + 1
    assert not any(ck.PLAIN_CALLS.values())
    got = [g.cpu() for g in got]
    # card_checks.py's SLICE_TOL: 2e-4 per pose entry, 1e-4 relative cost
    assert torch.allclose(got[0], want[0], atol=2e-4, rtol=0)
    assert torch.allclose(got[3], want[3], rtol=1e-4, atol=1e-6)
    assert torch.allclose(got[5], want[5], atol=2e-4, rtol=0)
    assert torch.equal(got[2], want[2])
    assert float((got[6] - want[6]).norm()) <= 1e-3 * float(want[6].norm())
