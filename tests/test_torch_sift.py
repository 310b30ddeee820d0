"""Parity of the port's SIFT detector (``slam_tpu_torch/ops/sift.py``) with
the JAX package's, and of kernel B3's plain version on SIFT's octaves.

The same numpy inputs, made from a seed (or the JAX SIFT tests' blob
image), go through the JAX function on the CPU and its torch counterpart;
each comparison states its tolerance. On the CPU ``orientation_maps``
runs B3's plain version; the kernel itself is held against it by the
``cuda`` tests of ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import features as jfeat
from slam_tpu.ops import pallas_kernels as pk
from slam_tpu.ops import sift as jsift
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.config import FeatureConfig, MatchConfig, SlamConfig
from slam_tpu_torch.models import frontend
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import features, sift

from tests.test_sift import _blob_image
from tests.test_torch_slice import jax_config

torch.set_num_threads(2)


def t(x):
    return torch.as_tensor(np.array(x))


def noise(seed, F, H, W):
    return np.random.default_rng(seed).random((F, H, W)).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    """A rendered 96x160 stereo pair of a JAX-package scene."""
    scene = jsynth.make_scene(jax.random.PRNGKey(11), num_frames=1,
                              num_landmarks=2000, trajectory="straight",
                              hw=(96, 160))
    L, R = jsynth.render_sequence(scene)
    return np.concatenate([L, R]).astype(np.float32)


def jax_batch(imgs, **kw):
    out = jax.vmap(lambda im: jsift.detect_and_describe_sift(im, **kw))(
        jnp.asarray(imgs))
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# the building blocks, on the same inputs
# ---------------------------------------------------------------------------

def test_upsample2_equals_jax_resize():
    """``jax.image.resize(img, (2H, 2W), "linear")`` and bilinear
    ``F.interpolate`` (half-pixel centres, no antialias) agree within 1e-6
    everywhere, edge rows and columns included (both take the edge pixel
    alone there), at even and odd sizes."""
    for shape in ((3, 17, 31), (1, 40, 64)):
        imgs = noise(1, *shape)
        want = np.stack([np.asarray(jax.image.resize(
            jnp.asarray(im), (2 * shape[1], 2 * shape[2]), "linear"))
            for im in imgs])
        got = sift.upsample2(t(imgs)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[:, 0, 0], imgs[:, 0, 0], atol=1e-6)


def test_pyramid_octave_matches_jax():
    """Every level of one octave within 1e-6 (images in [0, 1]), and the
    blur radii equal."""
    imgs = noise(2, 2, 48, 80)
    want = [np.asarray(x) for x in jax.vmap(jsift.gaussian_pyramid_octave)(
        jnp.asarray(imgs))]
    got = sift.gaussian_pyramid_octave(t(imgs))
    assert len(got) == len(want) == sift.INTERVALS + 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    for s in (0.5, 1.2, 1.6, 2.5, 4.0):
        assert sift._blur_radius(s) == jsift._blur_radius(s)
    assert (sift.INTERVALS, sift.SIGMA0, sift.EDGE_R) == (
        jsift.INTERVALS, jsift.SIGMA0, jsift.EDGE_R)


def test_extrema_and_edge_masks_match_jax():
    """On the same DoG levels (of a noise octave, with a flat patch wide
    enough to stay flat through every blur, where the DoG ties at 0 and
    the non-strict comparisons keep the pixel), the 3x3x3 extremum mask
    is equal everywhere (max and min are exact) and the edge gate equal
    away from its decision margin (tr^2 within 1e-6 of (r + 1)^2 / r
    det)."""
    imgs = noise(3, 2, 112, 128)
    imgs[:, 8:104, 8:120] = 0.5
    gauss = jax.vmap(jsift.gaussian_pyramid_octave)(jnp.asarray(imgs))
    dogs = [np.asarray(b - a) for a, b in zip(gauss[:-1], gauss[1:])]
    found = []
    for i in range(1, len(dogs) - 1):
        want = np.asarray(jax.vmap(jsift._extrema_mask)(
            *(jnp.asarray(d) for d in dogs[i - 1:i + 2])))
        got = sift._extrema_mask(*(t(d) for d in dogs[i - 1:i + 2])).numpy()
        np.testing.assert_array_equal(got, want)
        found.append(want)
        d = dogs[i]
        e_want = np.asarray(jax.vmap(jsift._edge_ok)(jnp.asarray(d)))
        e_got = sift._edge_ok(t(d)).numpy()
        dxx = np.roll(d, -1, 2) - 2 * d + np.roll(d, 1, 2)
        dyy = np.roll(d, -1, 1) - 2 * d + np.roll(d, 1, 1)
        dxy = 0.25 * (np.roll(d, (-1, -1), (1, 2)) + np.roll(d, (1, 1), (1, 2))
                      - np.roll(d, (-1, 1), (1, 2))
                      - np.roll(d, (1, -1), (1, 2)))
        det = dxx * dyy - dxy * dxy
        margin = np.minimum(np.abs((dxx + dyy) ** 2 - 12.1 * det),
                            np.abs(det))
        tie = margin <= 1e-6 * np.abs(d).max() ** 2
        assert not ((e_got != e_want) & ~tie).any()
        assert e_want.any() and not e_want.all()
    found = np.stack(found)
    assert found[:, :, 56, 64].all()          # the tie at the flat centre
    assert found[:, :, :8].any() or found[:, :, -8:].any()


# ---------------------------------------------------------------------------
# the detector as a whole
# ---------------------------------------------------------------------------

def check_paired(out_t, out_j):
    """Slot by slot: valid equal on >= 99.9% of the slots; where both are
    valid, xy within 1e-3 px, scale within 1e-4 and desc within 1e-5;
    resp within 1e-6 (|DoG| of images in [0, 1])."""
    out_t = {k: v.numpy() for k, v in out_t.items()}
    assert set(out_t) == set(out_j) == {"xy", "desc", "valid", "resp",
                                        "scale"}
    for k, v in out_j.items():
        assert out_t[k].shape == v.shape, k
    assert (out_t["valid"] == out_j["valid"]).mean() >= 0.999
    both = out_t["valid"] & out_j["valid"]
    assert both.sum() > 0
    np.testing.assert_allclose(out_t["xy"][both], out_j["xy"][both],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_t["scale"][both], out_j["scale"][both],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_t["desc"][both], out_j["desc"][both],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_t["resp"][both], out_j["resp"][both],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["noise", "blobs", "rendered",
                                  "published"])
def test_sift_batch_matches_jax(case, frames):
    """detect_and_describe_sift_batch against the JAX package's vmapped
    detector (check_paired's tolerances), on seeded noise, on the JAX SIFT
    tests' blob image (with its upsampled and plain first octave), on a
    rendered stereo pair, and on that pair under the benchmark's
    kitti00_sift settings (cv2's SIFT_create(2500): K = 2500, 5 octaves,
    contrast 0.04 / 3)."""
    if case == "noise":
        imgs, kw = noise(4, 2, 80, 128), dict(max_kp=512, octaves=3)
    elif case == "blobs":
        imgs, kw = _blob_image()[None], dict(max_kp=1024, octaves=4)
    elif case == "published":
        imgs, kw = frames, dict(max_kp=2500, octaves=5, contrast=0.04 / 3)
    else:
        imgs, kw = frames, dict(max_kp=512, octaves=4)
    check_paired(sift.detect_and_describe_sift_batch(t(imgs), **kw),
                 jax_batch(imgs, **kw))
    if case == "blobs":
        kw.update(upsample=False)
        check_paired(sift.detect_and_describe_sift_batch(t(imgs), **kw),
                     jax_batch(imgs, **kw))


def test_sift_contract():
    """(F, max_kp) slots with the octave budgets of level_budgets (the
    first octave's slots first), unit-norm descriptors where valid, zero
    elsewhere, scale 0 on invalid slots, and a flat image yields none."""
    imgs = np.stack([_blob_image(), _blob_image()[::-1].copy(),
                     np.full((192, 256), 0.5, np.float32)])
    out = sift.detect_and_describe_sift_batch(t(imgs), max_kp=512,
                                              octaves=3)
    assert out["xy"].shape == (3, 512, 2)
    assert out["desc"].shape == (3, 512, 128)
    for k in ("valid", "resp", "scale"):
        assert out[k].shape == (3, 512)
    assert features.level_budgets(512, 3) == [256, 128, 128]
    v = out["valid"].numpy()
    n = np.linalg.norm(out["desc"].numpy(), axis=-1)
    np.testing.assert_allclose(n[v], 1.0, atol=1e-3)
    assert (n[~v] == 0).all() and (out["scale"].numpy()[~v] == 0).all()
    assert v[:2].sum() > 0 and v[2].sum() == 0
    # octave o (the first is the x2 one, o_eff = o - 1) holds sigmas
    # SIGMA0 2^(o_eff + (i + di) / 3), i in 1..3, |di| <= 1/2
    sc = out["scale"].numpy()
    for o, (lo, hi) in enumerate(((0, 256), (256, 384), (384, 512))):
        s_o = sc[:, lo:hi][v[:, lo:hi]] / (sift.SIGMA0 * 2.0 ** (o - 1))
        assert ((s_o >= 2 ** (1 / 6) - 1e-6) & (s_o <= 2 ** (7 / 6) + 1e-6)
                ).all()


def test_b3_plain_on_sift_octaves():
    """B3's plain version (the wrapper on the CPU) on SIFT's octave bases
    (the x2-upsampled, pre-blurred image and its decimated next octave)
    within 1e-5 of max |maps|: against the Pallas kernel in interpret mode
    in the interior (>= 8 px from the edge, where its zero canvas
    differs), against the jnp orientation_cell_maps everywhere."""
    imgs = np.concatenate([_blob_image(96, 128, [(40, 50, 2.5),
                                                 (60, 90, 5.0)])[None],
                           noise(5, 1, 96, 128)])
    pre = float((sift.SIGMA0 ** 2 - 1.0) ** 0.5)
    base = features.gaussian_blur(sift.upsample2(t(imgs)), pre,
                                  sift._blur_radius(pre))
    nxt = sift.gaussian_pyramid_octave(base)[sift.INTERVALS][..., ::2, ::2]
    for x in (base, nxt.contiguous()):
        xn = x.numpy()
        m_t = ck.orientation_maps(x).numpy()
        m_p = np.asarray(pk.orientation_cell_maps_batch(jnp.asarray(xn),
                                                        interpret=True))
        m_j = np.asarray(jax.vmap(jfeat.orientation_cell_maps)(
            jnp.asarray(xn)))
        assert m_t.shape == m_j.shape == (2, 8) + xn.shape[1:]
        tol = 1e-5 * np.abs(m_j).max()
        inner = (..., slice(8, -8), slice(8, -8))
        np.testing.assert_allclose(m_t[inner], m_p[inner], atol=tol, rtol=0)
        np.testing.assert_allclose(m_t, m_j, atol=tol, rtol=0)


@pytest.mark.parametrize("norm", ["l2", "hamming"])
def test_frontend_sift_branch_matches_jax(frames, norm):
    """The frontend's detection branch under detector="sift" (octaves
    max(num_levels, 3) + 1, contrast sift_contrast) from uint8 images, as
    the JAX package's branch; +-1 signs under Hamming."""
    from slam_tpu.models import frontend as jfrontend

    cfg = SlamConfig(features=FeatureConfig(max_kp=256, detector="sift",
                                            sift_contrast=0.02),
                     matching=MatchConfig(norm=norm))
    imgs = (frames * 255).astype(np.uint8)
    out_t = frontend._detect_describe(t(imgs), cfg)
    out_j = jfrontend._detect_describe(jnp.asarray(imgs), jax_config(cfg))
    if norm == "hamming":
        assert set(np.unique(out_t["desc"].numpy())) == {-1.0, 1.0}
    check_paired(out_t, {k: np.asarray(v) for k, v in out_j.items()})
