"""Parity of the port's ops (slam_tpu_torch.ops) with the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function on
the CPU and its torch counterpart; each comparison states its tolerance.
Float32 arithmetic in another order bounds most of them at ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import epnp as jepnp
from slam_tpu.ops import features as jfeat
from slam_tpu.ops import matching as jmatch
from slam_tpu.ops import ransac as jransac
from slam_tpu.ops import se3 as jse3
from slam_tpu.ops import stereo as jstereo
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.ops import (cuda_kernels, epnp, features, matching, ransac,
                                se3, stereo)

torch.set_num_threads(2)

CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def random_twists(rng, n):
    """Twists with generic, small (Taylor-branch) and near-pi rotations."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.05, 3.0, n - 6),
                          [1e-7, 1e-5, 3e-4, 0.02, np.pi - 1e-4, 0.0]])
    xi = np.concatenate([w * ang[:, None], rng.normal(size=(n, 3)) * 5], 1)
    return xi.astype(np.float32)


# ---------------------------------------------------------------------------
# rows 1-3: precision policy, SE(3), stereo
# ---------------------------------------------------------------------------

def test_precision_policy_disables_tf32():
    import slam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp", "hat"])
def test_se3_exp_family(name):
    rng = np.random.default_rng(0)
    xi = random_twists(rng, 64)
    arg = xi[:, :3] if name != "se3_exp" else xi
    close(getattr(se3, name)(t(arg)), getattr(jse3, name)(jnp.asarray(arg)),
          atol=2e-6)


@pytest.mark.parametrize("name", ["so3_log", "se3_log", "inverse",
                                  "rotation_angle_deg", "rotation_ypr",
                                  "project_to_so3"])
def test_se3_matrix_functions(name):
    # tolerance: float32 roundoff; the near-pi log amplifies it ~1e-4
    rng = np.random.default_rng(1)
    T = np.asarray(jse3.se3_exp(jnp.asarray(random_twists(rng, 64))))
    arg = T[:, :3, :3] if name in ("so3_log", "rotation_angle_deg",
                                   "rotation_ypr", "project_to_so3") else T
    close(getattr(se3, name)(t(arg)), getattr(jse3, name)(jnp.asarray(arg)),
          atol=2e-4 if name != "inverse" else 1e-5)


def test_se3_small_angle_log_is_finite_and_matches():
    # the Taylor branches that fixed a NaN at reference scale
    xi = np.array([[1e-7, 0, 0, 1, 2, 3], [0, 2e-4, 0, -1, 0, 5],
                   [0, 0, 0, 0, 0, 0]], np.float32)
    T = se3.se3_exp(t(xi))
    out = se3.se3_log(T)
    assert torch.isfinite(out).all()
    close(out, jse3.se3_log(jse3.se3_exp(jnp.asarray(xi))), atol=1e-6)


def test_transform_retract_between():
    rng = np.random.default_rng(2)
    A = np.asarray(jse3.se3_exp(jnp.asarray(random_twists(rng, 16))))
    B = np.asarray(jse3.se3_exp(jnp.asarray(random_twists(rng, 16))))
    pts = rng.normal(size=(16, 30, 3)).astype(np.float32) * 10
    d = random_twists(rng, 16) * 0.1
    close(se3.transform_points(t(A), t(pts)),
          jse3.transform_points(jnp.asarray(A), jnp.asarray(pts)), atol=1e-4)
    close(se3.retract(t(A), t(d)),
          jse3.retract(jnp.asarray(A), jnp.asarray(d)), atol=1e-5)
    close(se3.local(t(A), t(B)),
          jax.vmap(jse3.local)(jnp.asarray(A), jnp.asarray(B)), atol=2e-4)


def test_stereo_project_backproject():
    rng = np.random.default_rng(3)
    pc = rng.uniform([-10, -3, 2], [10, 3, 80], (200, 3)).astype(np.float32)
    meas = np.asarray(jstereo.project(jnp.asarray(CALIB), jnp.asarray(pc)))
    close(stereo.project(t(CALIB), t(pc)), meas, atol=1e-3)
    close(stereo.backproject(t(CALIB), t(meas)),
          jstereo.backproject(jnp.asarray(CALIB), jnp.asarray(meas)),
          atol=1e-4, rtol=1e-6)
    close(stereo.backproject_np(CALIB, meas),
          jstereo.backproject_np(CALIB, meas), atol=0)


# ---------------------------------------------------------------------------
# row 4: Harris path of features
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """Four rendered frames (two stereo pairs) of a JAX-package scene."""
    scene = jsynth.make_scene(jax.random.PRNGKey(5), num_frames=2,
                              num_landmarks=3000, trajectory="straight",
                              hw=(96, 160))
    L, R = jsynth.render_sequence(scene)
    return np.concatenate([L, R]).astype(np.float32)


def test_harris_response_and_nms(frames):
    # tolerance: 1e-5 of max |resp| (conv summation order)
    resp_j = np.asarray(jax.vmap(jfeat.harris_response)(jnp.asarray(frames)))
    resp_t = features.harris_response(t(frames))
    scale = np.abs(resp_j).max()
    close(resp_t, resp_j, atol=1e-5 * scale)
    # NMS on the SAME response: exact
    nms_j = np.asarray(jax.vmap(jfeat._nms)(jnp.asarray(resp_j)))
    np.testing.assert_array_equal(features.nms(t(resp_j)).numpy(), nms_j)


def test_orientation_cell_maps(frames):
    # tolerance: 1e-5 of max |maps| (float32 conv / atan2 rounding)
    maps_j = np.asarray(jax.vmap(jfeat.orientation_cell_maps)(
        jnp.asarray(frames)))
    maps_t = features.orientation_cell_maps(t(frames)).numpy()
    assert maps_t.shape == maps_j.shape
    close(maps_t, maps_j, atol=1e-5 * np.abs(maps_j).max())


def test_select_keypoints_same_set(frames):
    """Same response map in, same keypoint set out (compared as sets:
    tied ranking keys may order differently)."""
    resp = np.asarray(jax.vmap(jfeat.harris_response)(jnp.asarray(frames)))
    det_j = jax.vmap(lambda r: jfeat.select_keypoints(r, 256))(
        jnp.asarray(resp))
    rt = t(resp)
    det_t = features.select_keypoints(rt, features.nms(rt), 256)
    for f in range(frames.shape[0]):
        vj = np.asarray(det_j["valid"][f])
        vt = det_t["valid"][f].numpy()
        assert vj.sum() == vt.sum()
        xj = np.asarray(det_j["xy"][f])[vj]
        xt = det_t["xy"][f].numpy()[vt]
        key = lambda a: a[np.lexsort((a[:, 1], a[:, 0]))]
        close(key(xt), key(xj), atol=1e-5)


def test_describe_matches(frames):
    # same keypoints and maps in: descriptors within 1e-6
    maps = np.asarray(jax.vmap(jfeat.orientation_cell_maps)(
        jnp.asarray(frames)))
    rng = np.random.default_rng(4)
    xy = rng.uniform([0, 0], [160, 96], (frames.shape[0], 100, 2)
                     ).astype(np.float32)
    valid = rng.uniform(size=(frames.shape[0], 100)) > 0.2
    dj = jax.vmap(lambda im, x, v, m: jfeat.describe(im, x, v, maps=m))(
        jnp.asarray(frames), jnp.asarray(xy), jnp.asarray(valid),
        jnp.asarray(maps))
    close(features.describe(t(xy), t(valid), t(maps)), dj, atol=1e-6)


def test_detect_and_describe_batch(frames):
    """End to end on images: keypoint sets equal within 1e-3 px, and the
    descriptors of each keypoint within 1e-3 (the maps agree to 1e-5 of
    their max; a weak cell keeps that absolute error, which the two L2
    normalizations scale up by 1/|desc|)."""
    out_j = jfeat.detect_and_describe_batch(jnp.asarray(frames), max_kp=256,
                                            use_pallas=False)
    out_t = features.detect_and_describe_batch(t(frames), max_kp=256)
    for f in range(frames.shape[0]):
        vj = np.asarray(out_j["valid"][f])
        vt = out_t["valid"][f].numpy()
        assert abs(int(vj.sum()) - int(vt.sum())) <= 1
        xj = np.asarray(out_j["xy"][f])[vj]
        xt = out_t["xy"][f].numpy()[vt]
        dj = np.asarray(out_j["desc"][f])[vj]
        dt = out_t["desc"][f].numpy()[vt]
        d2 = ((xt[:, None] - xj[None]) ** 2).sum(-1)
        nn = d2.argmin(1)
        paired = d2[np.arange(len(xt)), nn] < 1e-6
        assert paired.mean() > 0.99
        close(dt[paired], dj[nn[paired]], atol=1e-3)


# ---------------------------------------------------------------------------
# row 6: matching (through kernel B2's plain version on the CPU)
# ---------------------------------------------------------------------------

def _desc_sets(seed, B=3, Ka=200, Kb=230, D=128):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ka, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    src = rng.integers(0, Ka, (B, Kb))
    b = np.take_along_axis(a, src[..., None], 1) + 0.1 * rng.normal(
        size=(B, Kb, D)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    xa = rng.uniform([0, 0], [320, 160], (B, Ka, 2)).astype(np.float32)
    xb = (np.take_along_axis(xa, src[..., None], 1) + rng.uniform(
        [-60, -3], [-2, 3], (B, Kb, 2))).astype(np.float32)
    va = rng.uniform(size=(B, Ka)) > 0.1
    vb = rng.uniform(size=(B, Kb)) > 0.1
    return a, b.astype(np.float32), va, vb, xa, xb


def test_distance_matrix_and_window_penalty():
    """The port's dense distances (``cuda_kernels.window_distances``, the
    core of B2's plain version) against the JAX package's
    ``distance_matrix`` (all rows valid; validity is held by the
    mutual-match tests) within 1e-6 (summation order), and its window
    penalty on exactly the pairs JAX's ``window_penalty`` penalises (the
    port adds 1e30 where JAX adds 1e9)."""
    a, b, _, _, xa, xb = _desc_sets(0, B=1)
    ones_a = jnp.ones(a.shape[1], bool)
    ones_b = jnp.ones(b.shape[1], bool)
    d_j = jmatch.distance_matrix(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                 ones_a, ones_b)
    d_t = cuda_kernels.window_distances(t(a), t(b))[0]
    close(d_t, d_j, atol=1e-6)
    win = (-50.0, -2.0, 2.0)
    pen_j = np.asarray(jmatch.window_penalty(jnp.asarray(xa[0]),
                                             jnp.asarray(xb[0]), win))
    d_win = cuda_kernels.window_distances(t(a), t(b), t(xa), t(xb), win)[0]
    np.testing.assert_array_equal(d_win.numpy() > 0.5 * cuda_kernels.BIG,
                                  pen_j > 0)
    assert 0 < (pen_j > 0).mean() < 1
    kept = pen_j == 0
    close(d_win.numpy()[kept], np.asarray(d_j)[kept], atol=1e-6)


@pytest.mark.parametrize("window", [None, (-50.0, -2.0, 2.0)])
def test_mutual_match_matches_jax(window):
    """Same descriptors in, the same cross-checked matches out (random
    descriptors do not tie); distances within 1e-6 (summation order)."""
    a, b, va, vb, xa, xb = _desc_sets(1)
    out_t = matching.mutual_match(t(a), t(b), t(va), t(vb), max_dist=1.2,
                                  xy_a=t(xa), xy_b=t(xb), window=window)
    for i in range(a.shape[0]):
        out_j = jmatch.mutual_match(
            jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(va[i]),
            jnp.asarray(vb[i]), max_dist=1.2, xy_a=jnp.asarray(xa[i]),
            xy_b=jnp.asarray(xb[i]), window=window)
        np.testing.assert_array_equal(out_t["matched"][i].numpy(),
                                      np.asarray(out_j["matched"]))
        np.testing.assert_array_equal(out_t["target_idx"][i].numpy(),
                                      np.asarray(out_j["target_idx"]))
        close(out_t["dist"][i], out_j["dist"], atol=1e-6)
        assert out_t["matched"][i].sum() > 20


def test_stereo_pair_batched_matches_jax():
    a, b, va, vb, xa, xb = _desc_sets(2)
    win = (-192.0, -2.0, 4.0)
    left = {"desc": t(a), "valid": t(va), "xy": t(xa)}
    right = {"desc": t(b), "valid": t(vb), "xy": t(xb)}
    out_t = matching.match_stereo_pair_batched(left, right, window=win,
                                               max_dist=0.6)
    out_j = jmatch.match_stereo_pair_batched(
        {k: jnp.asarray(v.numpy()) for k, v in left.items()},
        {k: jnp.asarray(v.numpy()) for k, v in right.items()},
        window=win, max_dist=0.6)
    for k in ("matched", "target_idx"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    close(out_t["links"], out_j["links"], atol=1e-5)


def test_mutual_match_ties_go_to_lowest_index():
    # duplicated descriptors tie exactly: the first index wins, as with
    # jnp.argmin
    a = np.eye(4, 128, dtype=np.float32)
    b = np.concatenate([a, a])
    v = np.ones(4, bool)
    out = matching.mutual_match(t(a[None]), t(b[None]), t(v[None]),
                                t(np.ones((1, 8), bool)))
    assert out["target_idx"][0].tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# rows 8-9: minimal-set alignment, GN refinement, RANSAC
# ---------------------------------------------------------------------------

def _stereo_pair_problem(seed, n=300, outliers=0.3, noise=0.3):
    """Correspondences of one frame pair: points in the previous camera,
    their stereo measurements in the current one (with noise and
    outliers), and the true relative pose."""
    rng = np.random.default_rng(seed)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(np.array(
        [0.01, -0.03, 0.005, 0.1, -0.05, 1.2], np.float32))))
    pw = rng.uniform([-15, -3, 4], [15, 3, 60], (n, 3)).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    meas = np.asarray(jstereo.project(jnp.asarray(CALIB), jnp.asarray(pc)))
    meas = meas + rng.normal(0, noise, meas.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    meas[bad] += rng.uniform(-40, 40, (bad.sum(), 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    return pw, meas.astype(np.float32), valid, T_true


def test_rigid_align_3pt_batched():
    rng = np.random.default_rng(5)
    pa = rng.normal(size=(64, 3, 3)).astype(np.float32) * 5
    pa[0] = [[0, 0, 0], [1, 1, 1], [2, 2, 2]]  # collinear: degenerate
    T = np.asarray(jse3.se3_exp(jnp.asarray(random_twists(rng, 64))))
    pb = np.einsum("nij,nkj->nki", T[:, :3, :3], pa) + T[:, None, :3, 3]
    Tt, okt = epnp.rigid_align_3pt(t(pa), t(pb))
    Tj, okj = jepnp.rigid_align_3pt_batched(jnp.asarray(pa), jnp.asarray(pb))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not okt[0]
    close(Tt, Tj, atol=2e-4)


def test_refine_pose_gn_matches_jax():
    pw, meas, valid, T_true = _stereo_pair_problem(6, outliers=0.0)
    T0 = np.asarray(jse3.retract(jnp.asarray(T_true), jnp.asarray(
        np.array([0.01, 0.0, -0.01, 0.05, 0.02, -0.1], np.float32))))
    w = valid.astype(np.float32)
    Tj = jepnp.refine_pose_gn(jnp.asarray(T0), jnp.asarray(pw),
                              jnp.asarray(meas), jnp.asarray(w),
                              jnp.asarray(CALIB), iters=5)
    Tt = epnp.refine_pose_gn(t(T0[None]), t(pw[None]), t(meas[None]),
                             t(w[None]), t(CALIB), iters=5)[0]
    # both converge to the same GN optimum: 1e-5 rotation, 1e-4 m
    close(Tt[:3, :3], np.asarray(Tj)[:3, :3], atol=1e-5)
    close(Tt[:3, 3], np.asarray(Tj)[:3, 3], atol=1e-4)


def test_stereo_agreement_matches_jax():
    pw, meas, valid, T_true = _stereo_pair_problem(7)
    out_t = ransac.stereo_agreement(t(T_true), t(pw), t(meas), t(valid),
                                    t(CALIB))
    out_j = jransac.stereo_agreement(jnp.asarray(T_true), jnp.asarray(pw),
                                     jnp.asarray(meas), jnp.asarray(valid),
                                     jnp.asarray(CALIB))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_ransac_with_jax_hypotheses_matches_jax():
    """RANSAC fed the JAX package's hypothesis indices: the same best
    hypothesis, inlier set and refined pose (1e-5 rad / 1e-4 m)."""
    B = 3
    probs = [_stereo_pair_problem(10 + i) for i in range(B)]
    pw = np.stack([p[0] for p in probs])
    meas = np.stack([p[1] for p in probs])
    valid = np.stack([p[2] for p in probs])
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    idx = np.stack([np.asarray(jransac._sample_hypotheses(
        keys[i], jnp.asarray(valid[i]), 128)) for i in range(B)])
    out_t = ransac.ransac_pnp(t(pw), t(meas), t(valid), t(CALIB),
                              num_hypotheses=128, refine_iters=3,
                              hyp_idx=t(idx))
    for i in range(B):
        out_j = jransac.ransac_pnp(keys[i], jnp.asarray(pw[i]),
                                   jnp.asarray(meas[i]),
                                   jnp.asarray(valid[i]), jnp.asarray(CALIB),
                                   num_hypotheses=128, refine_iters=3)
        assert bool(out_t["ok"][i]) == bool(out_j["ok"])
        np.testing.assert_array_equal(out_t["inliers"][i].numpy(),
                                      np.asarray(out_j["inliers"]))
        close(out_t["T_w2c"][i, :3, :3], np.asarray(out_j["T_w2c"])[:3, :3],
              atol=1e-5)
        close(out_t["T_w2c"][i, :3, 3], np.asarray(out_j["T_w2c"])[:3, 3],
              atol=1e-4)


def test_ransac_own_sampling_recovers_pose():
    """With the port's own Gumbel draws (statistical parity): the true
    pose within 1 cm / 0.05 deg and ~70% inliers at 30% outliers."""
    pw, meas, valid, T_true = _stereo_pair_problem(20)
    g = torch.Generator().manual_seed(0)
    out = ransac.ransac_pnp(t(pw[None]), t(meas[None]), t(valid[None]),
                            t(CALIB), num_hypotheses=256, generator=g)
    assert bool(out["ok"][0])
    T = out["T_w2c"][0].numpy()
    assert np.abs(T[:3, 3] - T_true[:3, 3]).max() < 0.01
    dR = T[:3, :3] @ T_true[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.05
    frac = int(out["num_inliers"][0]) / valid.sum()
    assert 0.6 < frac < 0.8


def test_sample_hypotheses_only_valid_and_distinct():
    valid = torch.zeros((2, 50), dtype=torch.bool)
    valid[:, ::3] = True
    idx = ransac.sample_hypotheses(valid, 200,
                                   torch.Generator().manual_seed(1))
    assert idx.shape == (2, 200, 3)
    assert valid.gather(1, idx.reshape(2, -1)).all()
    s = idx.sort(-1).values
    assert (s[..., 1:] != s[..., :-1]).all()
