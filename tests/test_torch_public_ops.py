"""The JAX package's remaining public functions in the port: the
single-card step ``entry()`` (slam_tpu_torch/entry.py), the per-image
detector and matcher forms, and the op functions of their own, each
against the JAX function on the CPU with its tolerance stated; and an
AST diff of the two packages' public top-level functions, which may lack
only the functions that are specific to JAX or the TPU.

Where the JAX function reaches a Pallas kernel (``nearest_neighbor``,
``mutual_match_pallas``) it runs in interpret mode, as the JAX package's
own tests run it.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import akaze as jakaze
from slam_tpu.ops import binary as jbinary
from slam_tpu.ops import features as jfeat
from slam_tpu.ops import matching as jmatch
from slam_tpu.ops import orb as jorb
from slam_tpu.ops import pallas_kernels as jpk
from slam_tpu.ops import pose_graph as jpg
from slam_tpu.ops import se3 as jse3
from slam_tpu.ops import sift as jsift
from slam_tpu.ops import stereo as jstereo
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.ops import (akaze, binary, cuda_kernels, features,
                                matching, orb, pose_graph, se3, sift, stereo)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# entry(): the single-card step
# ---------------------------------------------------------------------------

def test_entry_has_the_jax_steps_shapes_and_dtypes():
    """entry("cpu")'s step on its own inputs: T_rel and num_inliers with
    the shapes and dtypes ``jax.eval_shape`` gives for the JAX package's
    step (traced, not run), finite; the inputs are the JAX step's images
    bit for bit (the same numpy draws)."""
    from __graft_entry__ import entry as jentry

    from slam_tpu_torch.entry import entry

    j_step, j_args = jentry()
    want = jax.eval_shape(j_step, *j_args)
    step, (left, right, gen) = entry("cpu")
    np.testing.assert_array_equal(left.numpy(), np.asarray(j_args[0]))
    np.testing.assert_array_equal(right.numpy(), np.asarray(j_args[1]))
    T_rel, num_inliers = step(left, right, gen)
    for got, spec in zip((T_rel, num_inliers), want):
        assert tuple(got.shape) == tuple(spec.shape)
        assert got.numpy().dtype == np.dtype(spec.dtype)
        assert torch.isfinite(got.float()).all()
    assert tuple(T_rel.shape) == (4, 4, 4)


# ---------------------------------------------------------------------------
# per-image detector forms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    """One rendered 96x160 frame of a JAX-package scene."""
    scene = jsynth.make_scene(jax.random.PRNGKey(5), num_frames=2,
                              num_landmarks=3000, trajectory="straight",
                              hw=(96, 160))
    L, _ = jsynth.render_sequence(scene)
    return np.asarray(L[1], np.float32)


DETECTORS = {
    # name: (port function, JAX function, keyword arguments)
    "detect": (features.detect, jfeat.detect, {"max_kp": 256}),
    "detect_and_describe": (features.detect_and_describe,
                            jfeat.detect_and_describe, {"max_kp": 256}),
    "detect_and_describe_multiscale": (
        features.detect_and_describe_multiscale,
        jfeat.detect_and_describe_multiscale,
        {"max_kp": 256, "num_levels": 2}),
    "detect_and_describe_akaze": (akaze.detect_and_describe_akaze,
                                  jakaze.detect_and_describe_akaze,
                                  {"max_kp": 256, "octaves": 2}),
    "detect_and_describe_sift": (sift.detect_and_describe_sift,
                                 jsift.detect_and_describe_sift,
                                 {"max_kp": 256, "octaves": 3}),
    "detect_and_describe_orb": (orb.detect_and_describe_orb,
                                jorb.detect_and_describe_orb,
                                {"max_kp": 256}),
}


@pytest.mark.parametrize("name", list(DETECTORS))
def test_per_image_detector_matches_jax(name, frame):
    """Each per-image form on one frame against the JAX package's: the
    same keys and shapes; >= 99% of the JAX keypoints have a port keypoint
    within 1e-3 px, and the valid counts differ by at most 1% of the
    slots (test_torch_akaze.py's paired sets: keys tied in their last
    bits may trade slots); paired keypoints' scales within 1e-4 (SIFT's
    is continuous), descriptors within 1e-3 (test_torch_ops.py: the maps
    agree to 1e-5 of their max, and the two L2 normalizations scale a
    weak cell's error by 1/|desc|), or for ORB's bit signs equal on >=
    99% of the bits (near-ties of the rotated BRIEF tests,
    test_torch_orb.py)."""
    fn, jfn, kw = DETECTORS[name]
    out_t = fn(t(frame), **kw)
    out_j = {k: np.asarray(v) for k, v in jfn(jnp.asarray(frame),
                                              **kw).items()}
    assert set(out_t) == set(out_j)
    for k, v in out_j.items():
        assert tuple(out_t[k].shape) == v.shape, k
    vj, vt = out_j["valid"], out_t["valid"].numpy()
    assert abs(int(vj.sum()) - int(vt.sum())) <= 0.01 * vj.size
    xj, xt = out_j["xy"][vj], out_t["xy"].numpy()[vt]
    d2 = ((xj[:, None] - xt[None]) ** 2).sum(-1)
    nn = d2.argmin(1)
    paired = d2[np.arange(len(xj)), nn] < 1e-6
    print(f"{name}: {vj.sum()} JAX keypoints, {paired.mean():.4f} paired")
    assert paired.mean() >= 0.99 and vj.sum() > 20

    def at(out, v, k):
        return np.asarray(out[k])[v]

    if "scale" in out_j:
        close(at(out_t, vt, "scale")[nn[paired]],
              at(out_j, vj, "scale")[paired], 1e-4)
    if "desc" in out_j:
        dt = at(out_t, vt, "desc")[nn[paired]]
        dj = at(out_j, vj, "desc")[paired]
        if name.endswith("orb"):
            assert (np.sign(dt) == np.sign(dj)).mean() >= 0.99
        else:
            close(dt, dj, 1e-3)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def desc_sets(seed, B=3, Ka=200, Kb=230, D=128):
    """tests/test_torch_ops.py's descriptor sets: B pairs, B's rows noisy
    copies of A's, positions in a stereo-like band, some rows invalid."""
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


def test_distance_matrix_matches_jax():
    """One pair: distances within 1e-6 where both rows are valid (the
    summation order of 128 products), BIG exactly where either is not;
    a batch of pairs gives each pair's matrix."""
    a, b, va, vb, _, _ = desc_sets(0)
    d_t = matching.distance_matrix(t(a[0]), t(b[0]), t(va[0]), t(vb[0]))
    d_j = np.asarray(jmatch.distance_matrix(*(jnp.asarray(x[0]) for x in
                                              (a, b, va, vb))))
    ok = va[0][:, None] & vb[0][None, :]
    close(d_t.numpy()[ok], d_j[ok], atol=1e-6)
    np.testing.assert_array_equal(d_t.numpy()[~ok], d_j[~ok])
    d_b = matching.distance_matrix(t(a), t(b), t(va), t(vb))
    np.testing.assert_array_equal(d_b[0].numpy(), d_t.numpy())


@pytest.mark.parametrize("window", [None, (-50.0, -2.0, 2.0)])
def test_window_penalty_matches_jax(window):
    """The penalty equal to the JAX package's bit for bit (BIG outside the
    window, 0 inside; 0.0 with no window), per pair and batched."""
    _, _, _, _, xa, xb = desc_sets(1)
    p_t = matching.window_penalty(t(xa), t(xb), window)
    for i in range(xa.shape[0]):
        p_j = np.asarray(jmatch.window_penalty(jnp.asarray(xa[i]),
                                               jnp.asarray(xb[i]), window))
        got = p_t if window is None else p_t[i].numpy()
        np.testing.assert_array_equal(got, p_j)
    if window is not None:
        assert 0 < (p_t > 0).float().mean() < 1


@pytest.mark.parametrize("dup", [False, True])
def test_ratio_match_matches_jax(dup):
    """Lowe's ratio test: matched and target_idx equal, dist within 1e-6.
    With B's rows duplicated (dup), every best distance ties with its
    copy, so the second best equals the best; under a ratio above 1 such
    ties pass, and the match must be the lower of the two copies, as in
    ``jax.lax.top_k``."""
    a, b, va, vb, _, _ = desc_sets(2)
    ratio = 0.8
    if dup:
        b = np.concatenate([b, b], axis=1)
        vb = np.concatenate([vb, vb], axis=1)
        ratio = 1.5
    for i in range(a.shape[0]):
        out_t = matching.ratio_match(t(a[i]), t(b[i]), t(va[i]), t(vb[i]),
                                     ratio=ratio, max_dist=1.2)
        out_j = jmatch.ratio_match(*(jnp.asarray(x[i]) for x in
                                     (a, b, va, vb)), ratio=ratio,
                                   max_dist=1.2)
        for k in ("matched", "target_idx"):
            np.testing.assert_array_equal(out_t[k].numpy(),
                                          np.asarray(out_j[k]), err_msg=k)
        close(out_t["dist"], out_j["dist"], atol=1e-6)
        assert out_t["matched"].sum() > 20
        if dup:
            idx = out_t["target_idx"].numpy()
            assert (idx[idx >= 0] < b.shape[1] // 2).all()


def test_match_stereo_pair_matches_jax():
    """One frame pair: matched and target_idx equal, links within 1e-5,
    and row 0 of the batched form bit for bit."""
    a, b, va, vb, xa, xb = desc_sets(3)
    win = (-192.0, -2.0, 4.0)
    left = {"desc": a[0], "valid": va[0], "xy": xa[0]}
    right = {"desc": b[0], "valid": vb[0], "xy": xb[0]}
    out_t = matching.match_stereo_pair({k: t(v) for k, v in left.items()},
                                       {k: t(v) for k, v in right.items()},
                                       window=win, max_dist=0.6)
    out_j = jmatch.match_stereo_pair(
        {k: jnp.asarray(v) for k, v in left.items()},
        {k: jnp.asarray(v) for k, v in right.items()}, window=win,
        max_dist=0.6)
    for k in ("matched", "target_idx"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    close(out_t["links"], out_j["links"], atol=1e-5)
    assert out_t["matched"].sum() > 20
    batched = matching.match_stereo_pair_batched(
        {"desc": t(a), "valid": t(va), "xy": t(xa)},
        {"desc": t(b), "valid": t(vb), "xy": t(xb)}, window=win,
        max_dist=0.6)
    for k, v in out_t.items():
        np.testing.assert_array_equal(v.numpy(), batched[k][0].numpy())


@pytest.mark.parametrize("window", [None, (-50.0, -2.0, 2.0)])
def test_mutual_match_batched_matches_jax(window):
    """The JAX package's vmapped mutual matcher, under its argument order:
    matched and target_idx equal, dist within 1e-6."""
    a, b, va, vb, xa, xb = desc_sets(4)
    out_t = matching.mutual_match_batched(t(a), t(b), t(va), t(vb), t(xa),
                                          t(xb), window, max_dist=1.2)
    out_j = jmatch.mutual_match_batched(*(jnp.asarray(x) for x in
                                          (a, b, va, vb, xa, xb)),
                                        window=window, max_dist=1.2)
    for k in ("matched", "target_idx"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    close(out_t["dist"], out_j["dist"], atol=1e-6)
    assert out_t["matched"].sum() > 60


def sign_sets(seed, B=2, Ka=150, Kb=170, D=128):
    """+-1 signs: B's rows copies of A's with up to 6 bits flipped (many
    exact Hamming ties)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (B, Ka, D))
    src = rng.integers(0, Ka, (B, Kb))
    b = np.take_along_axis(a, src[..., None], 1).copy()
    flips = rng.integers(0, 7, (B, Kb))
    for i in range(B):
        for j in range(Kb):
            b[i, j, rng.choice(D, flips[i, j], replace=False)] ^= 1
    xa = rng.uniform([0, 0], [640, 240], (B, Ka, 2)).astype(np.float32)
    xb = (np.take_along_axis(xa, src[..., None], 1) + rng.uniform(
        [-150, -3], [-1, 3], (B, Kb, 2))).astype(np.float32)
    va = rng.uniform(size=(B, Ka)) > 0.05
    vb = rng.uniform(size=(B, Kb)) > 0.05
    return ((2 * a - 1).astype(np.float32), (2 * b - 1).astype(np.float32),
            va, vb, xa, xb)


@pytest.mark.parametrize("window", [None, (-192.0, -2.0, 4.0)])
def test_hamming_mutual_match_batched_matches_jax(window):
    """Matches, indices and distances in bits equal, ties included."""
    sa, sb, va, vb, xa, xb = sign_sets(5)
    out_t = binary.hamming_mutual_match_batched(
        t(sa), t(sb), t(va), t(vb), 40, t(xa), t(xb), window)
    out_j = jbinary.hamming_mutual_match_batched(
        *(jnp.asarray(x) for x in (sa, sb, va, vb)), max_hamming=40,
        xy_a=jnp.asarray(xa), xy_b=jnp.asarray(xb), window=window)
    for k in ("matched", "target_idx", "dist"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    assert out_t["matched"].sum() > 50


def test_hamming_distance_matrix_ref_matches_jax():
    """The host popcount reference equal to the JAX package's, and to
    the bit count of the signs' disagreements."""
    sa, sb, _, _, _, _ = sign_sets(6, B=1)
    got = binary.hamming_distance_matrix_ref(sa[0], sb[0])
    np.testing.assert_array_equal(
        got, jbinary.hamming_distance_matrix_ref(sa[0], sb[0]))
    np.testing.assert_array_equal(
        got, (sa[0][:, None] != sb[0][None]).sum(-1))
    assert got.dtype == np.int32


def test_nearest_neighbor_matches_pallas():
    """Row-wise nearest neighbours (B2's plain version here) against the
    Pallas kernel in interpret mode at its tile (1024 x 1024): indices
    equal, distances within 1e-5 (bf16 products summed in another
    order); a batch of one pair gives the same."""
    rng = np.random.default_rng(7)
    a, b = (rng.normal(size=(1024, 128)).astype(np.float32)
            for _ in range(2))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    vb = np.arange(1024) % 7 != 0
    d_j, i_j = jpk.nearest_neighbor(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(vb), interpret=True)
    d_t, i_t = cuda_kernels.nearest_neighbor(t(a), t(b), t(vb))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    close(d_t, d_j, atol=1e-5)
    d_b, i_b = cuda_kernels.nearest_neighbor(t(a[None]), t(b[None]),
                                             t(vb[None]))
    np.testing.assert_array_equal(i_b[0].numpy(), i_t.numpy())
    assert vb[i_t.numpy()].all()


def test_mutual_match_is_mutual_match_pallas():
    """``matching.mutual_match`` (the port's counterpart of
    ``mutual_match_pallas``) against the Pallas kernel in interpret mode
    with a guided window: matched and target_idx equal, dist within
    1e-5."""
    a, b, va, vb, xa, xb = desc_sets(8, B=1, Ka=1024, Kb=1024)
    win = (-50.0, -2.0, 2.0)
    out_j = jpk.mutual_match_pallas(*(jnp.asarray(x[0]) for x in
                                      (a, b, va, vb)), max_dist=1.2,
                                    interpret=True, xy_a=jnp.asarray(xa[0]),
                                    xy_b=jnp.asarray(xb[0]), window=win)
    out_t = matching.mutual_match(t(a), t(b), t(va), t(vb), max_dist=1.2,
                                  xy_a=t(xa), xy_b=t(xb), window=win)
    for k in ("matched", "target_idx"):
        np.testing.assert_array_equal(out_t[k][0].numpy(),
                                      np.asarray(out_j[k]))
    ok = out_t["matched"][0].numpy()
    close(out_t["dist"][0].numpy()[ok], np.asarray(out_j["dist"])[ok],
          atol=1e-5)
    assert ok.sum() > 100


# ---------------------------------------------------------------------------
# SE(3), stereo, the pose graph's gate
# ---------------------------------------------------------------------------

def poses(seed, n):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)) * 0.3,
                         rng.normal(size=(n, 3)) * 4], 1).astype(np.float32)
    return np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xi)))


def test_compose_matches_jax():
    """A @ B within 1e-5 (4x4 products summed in another order)."""
    A, B = poses(0, 8), poses(1, 8)
    close(se3.compose(t(A), t(B)), jse3.compose(jnp.asarray(A),
                                                jnp.asarray(B)), atol=1e-5)


def test_stereo_helpers_match_jax():
    """calib_from_K and K_from_calib equal and inverse to each other,
    project_world and monocular_project within 1e-6 relative (the same
    formula after a 4x4 transform summed in another order), the P and Q
    projection matrices within 1e-4 (entries up to ~1e3)."""
    K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]],
                 np.float32)
    c_t = stereo.calib_from_K(t(K), 0.5372)
    np.testing.assert_array_equal(
        c_t.numpy(), np.asarray(jstereo.calib_from_K(jnp.asarray(K), 0.5372)))
    assert c_t.dtype == torch.float32
    np.testing.assert_array_equal(
        stereo.K_from_calib(t(CALIB)).numpy(),
        np.asarray(jstereo.K_from_calib(jnp.asarray(CALIB))))
    np.testing.assert_array_equal(stereo.K_from_calib(c_t).numpy(), K)
    rng = np.random.default_rng(9)
    pts = rng.uniform([-10, -2, 5], [10, 2, 50], (300, 3)).astype(np.float32)
    T = poses(2, 1)[0]
    T[:3, 3] *= 0.1
    close(stereo.project_world(t(CALIB), t(T), t(pts)),
          jstereo.project_world(jnp.asarray(CALIB), jnp.asarray(T),
                                jnp.asarray(pts)), atol=0, rtol=1e-6)
    close(stereo.monocular_project(t(CALIB), t(pts)),
          jstereo.monocular_project(jnp.asarray(CALIB), jnp.asarray(pts)),
          atol=0, rtol=1e-6)
    for got, want in zip(stereo.projection_matrices(t(K), t(T), 0.5372),
                         jstereo.projection_matrices(jnp.asarray(K),
                                                     jnp.asarray(T), 0.5372)):
        close(got, want, atol=1e-4)


def test_mahalanobis_distance_matches_jax():
    """One pair's gate distance on a random SPD joint covariance within
    1e-4 relative of the JAX package's (a float32 6x6 solve), equal to
    mahalanobis_batched's entry for that pair."""
    N = 6
    rng = np.random.default_rng(11)
    A = rng.normal(size=(6 * N, 6 * N)).astype(np.float32) * 0.05
    C = (A @ A.T + 1e-3 * np.eye(6 * N, dtype=np.float32)).reshape(
        N, 6, N, 6)
    nodes = poses(3, N)
    for i, j in ((0, 3), (1, 5), (4, 2)):
        d_t = pose_graph.mahalanobis_distance(t(C), t(nodes), i, j)
        d_j = float(jpg.mahalanobis_distance(jnp.asarray(C),
                                             jnp.asarray(nodes), i, j))
        assert np.isfinite(d_j) and d_j > 0
        close(d_t, d_j, atol=0, rtol=1e-4)
        d_b = pose_graph.mahalanobis_batched(t(C), t(nodes), t([i]), t([j]))
        assert float(d_b[0]) == float(d_t)


# ---------------------------------------------------------------------------
# what is left of the JAX package's public functions
# ---------------------------------------------------------------------------

# the JAX package's public functions with no counterpart, each specific to
# JAX or to the TPU (the counterpart module's docstring says why)
NOT_PORTED = {
    "config.py": {"enable_compile_cache"},
    "ops/precision.py": {"full_precision"},
    "ops/ba.py": {"default_engine"},
    "parallel/mesh.py": {"shard_leading", "replicated"},
    "ops/features.py": {"build_shifted_cell_maps"},
    "utils/synthetic.py": {"render_frame", "host_scene"},
}
# pallas_kernels.py's functions and their counterparts in the port
PALLAS = {
    "detect_maps_batch": "ops/cuda_kernels.py:detect_maps",
    "mutual_nearest": "ops/cuda_kernels.py:mutual_nearest",
    "orientation_cell_maps_batch": "ops/cuda_kernels.py:orientation_maps",
    "harris_response_batch": "ops/cuda_kernels.py:harris_response",
    "akaze_octave_batch": "ops/cuda_kernels.py:akaze_octave",
    "cholesky_solve_lanes": "ops/cuda_kernels.py:cholesky_solve",
    "nearest_neighbor": "ops/cuda_kernels.py:nearest_neighbor",
    "mutual_match_pallas": "ops/matching.py:mutual_match",
}


def public_defs(root: Path) -> dict:
    """Module path -> its public top-level function names."""
    return {p.relative_to(root).as_posix(): {
        n.name for n in ast.parse(p.read_text()).body
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}
        for p in root.rglob("*.py")}


def test_every_public_function_has_a_counterpart():
    """An AST diff of the public top-level functions of slam_tpu/ and
    slam_tpu_torch/, module by module: what the port lacks is exactly
    NOT_PORTED, plus pallas_kernels.py, whose functions each have the
    counterpart PALLAS names."""
    jax_defs = public_defs(REPO / "slam_tpu")
    port_defs = public_defs(REPO / "slam_tpu_torch")
    missing = {m: names - port_defs.get(m, set())
               for m, names in jax_defs.items()}
    missing = {m: n for m, n in missing.items() if n}
    assert missing.pop("ops/pallas_kernels.py") == set(PALLAS)
    assert missing == NOT_PORTED
    for where in PALLAS.values():
        module, name = where.split(":")
        assert name in port_defs[module], where
