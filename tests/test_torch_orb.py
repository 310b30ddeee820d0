"""Parity of the port's ORB detector (``slam_tpu_torch/ops/orb.py``: FAST-9
and steered BRIEF) with the JAX package's.

The same numpy inputs (the JAX ORB tests' textured images, made from a
seed) go through the JAX function on the CPU and its torch counterpart;
each comparison states its tolerance. FAST's ``d > t``, BRIEF's ``a < b``
and the rounding of the rotated test points are exact decisions: a
last-bit difference upstream may flip them only at a near-tie, which the
comparisons below find and allow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import features as jfeat
from slam_tpu.ops import orb as jorb
from slam_tpu_torch.config import FeatureConfig, MatchConfig, SlamConfig
from slam_tpu_torch.models import frontend
from slam_tpu_torch.ops import binary, features, orb

from tests.test_features_matching import textured_image
from tests.test_torch_slice import jax_config

torch.set_num_threads(2)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def imgs():
    """Three 128x256 textured images (flat patches included)."""
    return np.stack([np.asarray(textured_image(jax.random.PRNGKey(i),
                                               h=128, w=256))
                     for i in range(3)]).astype(np.float32)


def jax_batch(imgs, **kw):
    out = jax.vmap(lambda im: jorb.detect_and_describe_orb(im, **kw))(
        jnp.asarray(imgs))
    return {k: np.asarray(v) for k, v in out.items()}


def test_constants_and_pattern_equal():
    """The ring, the run length, the patch radius and the BRIEF pattern
    (from the same seeded RandomState) equal the JAX package's bit for
    bit."""
    np.testing.assert_array_equal(orb._CIRCLE, jorb._CIRCLE)
    assert (orb._ARC, orb.PATCH_R, orb.DESC_BITS, orb._PATTERN_R) == (
        jorb._ARC, jorb.PATCH_R, jorb.DESC_BITS, jorb._PATTERN_R)
    assert orb._PATTERN.dtype == jorb._PATTERN.dtype == np.float32
    assert orb._PATTERN.tobytes() == jorb._PATTERN.tobytes()


@pytest.mark.parametrize("threshold", [0.04, 0.06])
def test_fast_response_matches_jax_and_bruteforce(imgs, threshold):
    """Dense FAST-9 against the JAX function over the whole image (the
    ring's d is one subtraction, so every decision is the same) and
    against the per-start-position host version away from the ring band,
    rtol 1e-5, atol 1e-6 (tests/test_orb.py's tolerance)."""
    small = imgs[:, :32, :48].copy()
    got = orb.fast_response(t(small), threshold).numpy()
    want_j = np.asarray(jax.vmap(lambda im: jorb.fast_response(
        im, threshold))(jnp.asarray(small)))
    np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-6)
    for g, im in zip(got, small):
        want = orb.fast_response_ref(im, threshold)
        np.testing.assert_allclose(g[4:-4, 4:-4], want[4:-4, 4:-4],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(want, jorb.fast_response_ref(
            im, threshold))
    assert (got > 0).any()


def test_fast_fires_on_corners_not_flats():
    img = np.zeros((1, 64, 64), np.float32)
    img[:, 20:44, 20:44] = 1.0
    resp = orb.fast_response(t(img), threshold=0.1).numpy()[0]
    assert resp[20, 20] > 0 and resp[20, 43] > 0 and resp[43, 43] > 0
    assert resp[32, 32] == 0 and resp[10, 10] == 0 and resp[20, 32] == 0


def test_moment_maps_match_jax(imgs):
    """m10 and m01 within 1e-4 of max |m| (31-tap sums in other orders)."""
    got = orb.orientation_moment_maps(t(imgs))
    want = jax.vmap(jorb.orientation_moment_maps)(jnp.asarray(imgs))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def rounding_ties(xy, angle, tol=1e-4):
    """(F, K, 128) bool: a test point of bit i (a_i or b_i) rotated to
    within ``tol`` of a half pixel, where round() may go either way."""
    c, s = np.cos(angle)[..., None], np.sin(angle)[..., None]
    P = jorb._PATTERN
    px = xy[..., 0:1] + c * P[:, 0] - s * P[:, 1]
    py = xy[..., 1:2] + s * P[:, 0] + c * P[:, 1]
    half = (np.abs(np.abs(px - np.floor(px)) - 0.5) < tol) | (
        np.abs(np.abs(py - np.floor(py)) - 0.5) < tol)
    return half[..., :128] | half[..., 128:]


def test_brief_bits_match_jax(imgs):
    """On the same blurred images, keypoints and angles, every bit equals
    the JAX package's but where a rotated test point rounds at a half
    pixel; invalid slots are zero."""
    det = jax_batch(imgs, max_kp=256)
    blur = np.asarray(jax.vmap(lambda im: jfeat.gaussian_blur(im, 2.0, 4))(
        jnp.asarray(imgs)))
    want = np.asarray(jax.vmap(jorb.describe_brief)(
        jnp.asarray(blur), jnp.asarray(det["xy"]), jnp.asarray(det["angle"]),
        jnp.asarray(det["valid"])))
    got = orb.describe_brief(t(blur), t(det["xy"]), t(det["angle"]),
                             t(det["valid"])).numpy()
    tie = rounding_ties(det["xy"], det["angle"])
    assert not ((got != want) & ~tie).any()
    assert (got[~det["valid"]] == 0).all()


def test_orb_batch_matches_jax(imgs):
    """detect_and_describe_orb_batch against the JAX package's: valid, xy
    and resp equal (FAST is exact, selection and subpixel fit follow),
    angle within 1e-4 rad where the moments are not degenerate (both
    below 1e-5 of max |m|: atan2 of rounding noise), and every bit equal
    but at near-ties: a half-pixel rounding, test values within 1e-6 of
    each other (flat patches), or a degenerate angle."""
    out_j = jax_batch(imgs, max_kp=512)
    out_t = {k: v.numpy() for k, v in orb.detect_and_describe_orb_batch(
        t(imgs), max_kp=512).items()}
    assert set(out_t) == set(out_j) == {"xy", "desc", "valid", "resp",
                                        "angle"}
    np.testing.assert_array_equal(out_t["valid"], out_j["valid"])
    np.testing.assert_array_equal(out_t["xy"], out_j["xy"])
    np.testing.assert_allclose(out_t["resp"], out_j["resp"], rtol=1e-5,
                               atol=1e-6)
    v = out_j["valid"]
    m10, m01 = (np.asarray(m) for m in jax.vmap(
        jorb.orientation_moment_maps)(jnp.asarray(imgs)))
    F, K = v.shape
    xi = np.clip(np.round(out_j["xy"][..., 0]).astype(int), 0, 255)
    yi = np.clip(np.round(out_j["xy"][..., 1]).astype(int), 0, 127)
    f = np.arange(F)[:, None]
    mag = np.maximum(np.abs(m10[f, yi, xi]), np.abs(m01[f, yi, xi]))
    degenerate = mag <= 1e-5 * np.abs(m10).max()
    ok = v & ~degenerate
    np.testing.assert_allclose(out_t["angle"][ok], out_j["angle"][ok],
                               atol=1e-4, rtol=0)
    blur = np.asarray(jax.vmap(lambda im: jfeat.gaussian_blur(im, 2.0, 4))(
        jnp.asarray(imgs)))
    c, s = np.cos(out_j["angle"])[..., None], np.sin(out_j["angle"])[..., None]
    P = jorb._PATTERN
    px = np.clip(np.round(out_j["xy"][..., 0:1] + c * P[:, 0] - s * P[:, 1]
                          ).astype(int), 0, 255)
    py = np.clip(np.round(out_j["xy"][..., 1:2] + s * P[:, 0] + c * P[:, 1]
                          ).astype(int), 0, 127)
    vals = blur[f[..., None], py, px]
    tie = (rounding_ties(out_j["xy"], out_j["angle"])
           | (np.abs(vals[..., :128] - vals[..., 128:]) <= 1e-6)
           | degenerate[..., None])
    differ = out_t["desc"] != out_j["desc"]
    assert not (differ & ~tie).any()
    assert differ.mean() < 0.01 and v.sum() > 100


def test_orb_contract(imgs):
    """(F, max_kp) slots; +-1/sqrt(128) bit signs, unit norm where valid
    and zero elsewhere; the Hamming binarization recovers the bits."""
    out = orb.detect_and_describe_orb_batch(t(imgs), max_kp=256)
    assert out["xy"].shape == (3, 256, 2)
    assert out["desc"].shape == (3, 256, 128)
    for k in ("valid", "resp", "angle"):
        assert out[k].shape == (3, 256)
    v = out["valid"]
    d = out["desc"]
    assert set(np.unique(np.abs(d[v].numpy()))) == {np.float32(
        1 / np.sqrt(128))}
    np.testing.assert_allclose(np.linalg.norm(d[v].numpy(), axis=-1), 1.0,
                               atol=1e-5)
    assert (d[~v] == 0).all() and int(v.sum()) > 50
    signs = binary.binarize_descriptors(d)[v]
    mixed = (d[v] > 0).any(-1) & (d[v] < 0).any(-1)
    assert torch.equal(signs[mixed] > 0, d[v][mixed] > 0)
    assert features.DEFAULT_MAX_KP == 2048


@pytest.mark.parametrize("norm", ["l2", "hamming"])
def test_frontend_orb_branch_matches_jax(imgs, norm):
    """The frontend's detection branch under detector="orb" (threshold
    fast_threshold) from uint8 images, as the JAX package's branch:
    valid and xy equal, descriptors equal but on a share of at most 1% of
    the values (near-ties; test_orb_batch_matches_jax bounds them); +-1
    signs under Hamming."""
    from slam_tpu.models import frontend as jfrontend

    cfg = SlamConfig(features=FeatureConfig(max_kp=256, detector="orb",
                                            fast_threshold=0.05),
                     matching=MatchConfig(norm=norm))
    u8 = (imgs[:2] * 255).astype(np.uint8)
    out_t = frontend._detect_describe(t(u8), cfg)
    out_j = jfrontend._detect_describe(jnp.asarray(u8), jax_config(cfg))
    np.testing.assert_array_equal(out_t["valid"].numpy(),
                                  np.asarray(out_j["valid"]))
    np.testing.assert_array_equal(out_t["xy"].numpy(),
                                  np.asarray(out_j["xy"]))
    differ = out_t["desc"].numpy() != np.asarray(out_j["desc"])
    assert differ.mean() < 0.01
    if norm == "hamming":
        assert set(np.unique(out_t["desc"].numpy())) == {-1.0, 1.0}
