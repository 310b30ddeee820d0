"""Parity of the port's AKAZE, multiscale-Harris and Hamming paths with
the JAX package's, and of the plain versions of kernels B3, B4 and B5
with the JAX package's Pallas kernels (interpret mode).

The same numpy inputs, made from a seed, go through the JAX function on
the CPU and its torch counterpart; each comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import akaze as jakaze
from slam_tpu.ops import binary as jbinary
from slam_tpu.ops import features as jfeat
from slam_tpu.ops import pallas_kernels as pk
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch.config import FeatureConfig, MatchConfig, SlamConfig
from slam_tpu_torch.models import frontend
from slam_tpu_torch.ops import akaze, binary
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import features, matching

from tests.test_torch_slice import jax_config

torch.set_num_threads(2)


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def noise_images(seed, F, H, W):
    return np.random.default_rng(seed).random((F, H, W)).astype(np.float32)


def near_tie(resp):
    """Pixels whose response ties the runner-up of its 5x5 window within
    1e-6 of max |resp|: a last-bit difference may flip the NMS there."""
    r = torch.as_tensor(np.asarray(resp))
    pad = torch.nn.functional.pad(r[:, None], (2, 2, 2, 2),
                                  value=-float("inf"))
    win = pad.unfold(2, 5, 1).unfold(3, 5, 1).reshape(*r.shape, 25).clone()
    win[..., 12] = -float("inf")
    runner = win.max(dim=-1).values
    return ((r - runner).abs() <= 1e-6 * float(r.abs().max())).numpy()


@pytest.fixture(scope="module")
def frames():
    """Two rendered 128x256 images (a stereo pair) of a JAX-package
    scene."""
    scene = jsynth.make_scene(jax.random.PRNGKey(7), num_frames=1,
                              num_landmarks=3000, trajectory="straight",
                              hw=(128, 256))
    L, R = jsynth.render_sequence(scene)
    return np.concatenate([L, R]).astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions of B3, B4, B5 against the Pallas kernels and the jnp path
# ---------------------------------------------------------------------------

def test_b5_plain_matches_pallas_and_jnp():
    """L within 2e-6 and resp within 1e-5 over the full image (both wrap
    at the edge), against the Pallas kernel and the jnp diffuse /
    _hessian_response. NMS: the plain version's -inf pattern equals the
    jnp path's over the full image (away from near-ties, where the two
    responses' last bits may decide), and features.nms equals jnp _nms
    exactly on the same response; against Pallas only outside its 2-px
    band, where it wraps instead of reading -inf."""
    imgs = noise_images(5, 2, 130, 200)
    k = jax.vmap(jakaze._contrast_k)(jnp.asarray(imgs))
    L_p, r_p, n_p = (np.asarray(x) for x in pk.akaze_octave_batch(
        jnp.asarray(imgs), k, steps=6, sigma=1.6, interpret=True))
    L_j = jax.vmap(lambda im, kk: jakaze.diffuse(im, kk, 6))(
        jnp.asarray(imgs), k)
    r_j = jax.vmap(lambda l: jakaze._hessian_response(l, 1.6))(L_j)
    n_j = np.asarray(jax.vmap(jfeat._nms)(r_j))
    L_t, r_t, n_t = (x.numpy() for x in ck.akaze_octave(
        t(imgs), t(k), 6, sigma=1.6))
    for L_ref, r_ref in ((L_p, r_p), (L_j, r_j)):
        close(L_t, L_ref, 2e-6)
        close(r_t, r_ref, 1e-5)
    np.testing.assert_array_equal(features.nms(t(r_j)).numpy(), n_j)
    tie = near_tie(r_t)
    assert not ((np.isfinite(n_t) != np.isfinite(n_j)) & ~tie).any()
    band = (slice(None), slice(3, -3), slice(3, -3))
    assert not ((np.isfinite(n_t) != np.isfinite(n_p)) & ~tie)[band].any()
    kept = np.isfinite(n_t)
    np.testing.assert_array_equal(n_t[kept], r_t[kept])


def test_b3_plain_matches_pallas_and_jnp(frames):
    """Within 1e-5 of max |maps|: against the Pallas kernel in the interior
    (>= 8 px from the edge, where its zero canvas differs), against the
    jnp orientation_cell_maps everywhere."""
    imgs = np.concatenate([frames, noise_images(3, 1, 128, 256)])
    m_p = np.asarray(pk.orientation_cell_maps_batch(jnp.asarray(imgs),
                                                    interpret=True))
    m_j = np.asarray(jax.vmap(jfeat.orientation_cell_maps)(
        jnp.asarray(imgs)))
    m_t = ck.orientation_maps(t(imgs)).numpy()
    assert m_t.shape == m_j.shape == (3, 8, 128, 256)
    tol = 1e-5 * np.abs(m_j).max()
    close(m_t[..., 8:-8, 8:-8], m_p[..., 8:-8, 8:-8], tol)
    close(m_t, m_j, tol)


def test_b4_plain_matches_pallas_and_jnp(frames):
    """resp within 1e-5 of max |resp| and the same NMS pattern away from
    near-ties: against the Pallas kernel in the interior (>= 8 px), against
    the jnp harris_response / _nms everywhere."""
    imgs = np.concatenate([frames, noise_images(4, 1, 128, 256)])
    r_p, n_p = (np.asarray(x) for x in pk.harris_response_batch(
        jnp.asarray(imgs), interpret=True))
    r_j = np.asarray(jax.vmap(jfeat.harris_response)(jnp.asarray(imgs)))
    n_j = np.asarray(jax.vmap(jfeat._nms)(jnp.asarray(r_j)))
    r_t, n_t = (x.numpy() for x in ck.harris_response(t(imgs)))
    tol = 1e-5 * np.abs(r_j).max()
    inner = (slice(None), slice(8, -8), slice(8, -8))
    close(r_t[inner], r_p[inner], tol)
    close(r_t, r_j, tol)
    tie = near_tie(r_t)
    assert not ((np.isfinite(n_t) != np.isfinite(n_p)) & ~tie)[inner].any()
    assert not ((np.isfinite(n_t) != np.isfinite(n_j)) & ~tie).any()


# ---------------------------------------------------------------------------
# B5's schedule (csrc/akaze_octave.cu), written out in torch
# ---------------------------------------------------------------------------

def b5_schedule(imgs, k, steps, tau=0.2, sigma=1.6, TW=72, TH=64, NW=12):
    """B5 over (F, H, W) images in the kernel's order. Per TW x TH output
    tile: the halo'd region (2 steps + 3 behind, steps + 3 ahead) staged at
    ((y0 - back + i) mod H, (x0 - back + j) mod W); two buffers, A before a
    step and B after it (B starts as NaN: what a step does not write must
    never be read). Step n updates rows and columns [2n, R - 1 - n] in one
    fused pass, split as the kernel splits it over NW warps: column groups
    of 31 updated columns with a flux-only lane on their left (the flux on
    the left comes from the lane beside), row segments whose first row's
    upper flux is computed again; g = 1 / (1 + (hx^2 + hy^2) q) on the
    doubled gradients hx, hy with qk = 1 / (4 k^2), one reciprocal, the
    halves folded into qk and tau (exact). Then the Hessian response on
    the region (-inf outside the image) and the separable 5x5 NMS (row
    maxima, then their column maximum), each by column groups of 32 and
    row segments. Returns (L, resp, nms)."""
    F, H, W = imgs.shape
    RW, RH, back = TW + 3 * steps + 6, TH + 3 * steps + 6, 2 * steps + 3
    SW, SH = TW + 4, TH + 4
    qk = (0.25 / (k * k))[:, None, None]
    half_tau = 0.5 * tau
    lane = torch.arange(32)
    inf = float("inf")
    nan = float("nan")
    out = [torch.full((F, H, W), nan) for _ in range(3)]
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            yy = (y0 - back + torch.arange(RH)) % H
            xx = (x0 - back + torch.arange(RW)) % W
            A = imgs[:, yy][:, :, xx].clone()
            B = torch.full_like(A, nan)
            for n in range(1, steps + 1):
                lo, wn, hn = 2 * n, RW - 3 * n, RH - 3 * n
                ncg = (wn + 30) // 31
                nseg = NW // ncg
                assert nseg >= 1
                seg_rows = -(-hn // nseg)
                for warp in range(NW):
                    cg, seg = warp % ncg, warp // ncg
                    i0 = lo + seg * seg_rows
                    i1 = min(i0 + seg_rows, lo + hn)
                    if seg >= nseg or i1 <= i0:
                        continue
                    j = lo - 1 + 31 * cg + lane
                    stores = (lane > 0) & (j < lo + wn)
                    jc = torch.clamp(j, max=RW - 2)
                    i = torch.arange(i0 - 1, i1)
                    c = A[:, i][:, :, jc]
                    hx = A[:, i][:, :, jc + 1] - A[:, i][:, :, jc - 1]
                    hy = A[:, i + 1][:, :, jc] - A[:, i - 1][:, :, jc]
                    g = 1.0 / (1.0 + (hx * hx + hy * hy) * qk)
                    fx, fy = g * hx, g * hy
                    fx_left = torch.cat([fx[..., :1], fx[..., :-1]], -1)
                    div = (fx - fx_left)[:, 1:] + (fy[:, 1:] - fy[:, :-1])
                    new = c[:, 1:] + half_tau * div
                    B[:, i0:i1, j[stores]] = new[:, :, stores]
                A, B = B, A
            # Hessian response of region rows / columns back - 2 + (p, q)
            s_r = torch.full((F, SH, SW), nan)
            ncg = (SW + 31) // 32
            nseg = NW // ncg
            seg_rows = -(-SH // nseg)
            for warp in range(ncg * nseg):
                q = 32 * (warp % ncg) + lane
                q = q[q < SW]
                p = torch.arange((warp // ncg) * seg_rows,
                                 min((warp // ncg + 1) * seg_rows, SH))
                if not len(p) or not len(q):
                    continue
                def at(dp, dq):
                    return A[:, back - 2 + p + dp][:, :, back - 2 + q + dq]
                lxx = (at(0, 1) - 2.0 * at(0, 0)) + at(0, -1)
                lyy = (at(1, 0) - 2.0 * at(0, 0)) + at(-1, 0)
                lxy = 0.25 * (((at(1, 1) - at(1, -1)) - at(-1, 1))
                              + at(-1, -1))
                y, x = y0 - 2 + p, x0 - 2 + q
                inside = (((y >= 0) & (y < H))[:, None]
                          & ((x >= 0) & (x < W))[None, :])
                r = (sigma ** 4) * (lxx * lyy - lxy * lxy)
                s_r[:, p[:, None], q[None, :]] = torch.where(inside, r, -inf)
            # outputs: row maxima of 5, then their maximum over 5 rows
            ncg = (TW + 31) // 32
            nseg = NW // ncg
            seg_rows = -(-TH // nseg)
            for warp in range(ncg * nseg):
                b = 32 * (warp % ncg) + lane
                b = b[(b < TW) & (x0 + b < W)]
                a0 = (warp // ncg) * seg_rows
                a = torch.arange(a0, max(a0, min(a0 + seg_rows, TH, H - y0)))
                if not len(a) or not len(b):
                    continue
                rows = torch.arange(a0, int(a[-1]) + 5)
                row_max = torch.stack(
                    [s_r[:, rows][:, :, b + d] for d in range(5)]).amax(0)
                mm = torch.stack([row_max[:, u:u + len(a)]
                                  for u in range(5)]).amax(0)
                c = s_r[:, a + 2][:, :, b + 2]
                ya, xb = (y0 + a)[:, None], (x0 + b)[None, :]
                out[0][:, ya, xb] = A[:, back + a][:, :, back + b]
                out[1][:, ya, xb] = c
                out[2][:, ya, xb] = torch.where(c >= mm, c, -inf)
    return out


def check_b5_outputs(got, want, band=None):
    """L within 2e-6 of max |L| and resp within 2e-5 of max |resp| (the
    steps round in another order, g by one reciprocal instead of two
    divisions, and the second differences of L cancel up to ~10x of L's
    error); the NMS pattern equal away from near-ties; kept values are the
    response. ``band`` restricts the NMS comparison."""
    (L_g, r_g, n_g), (L_w, r_w, n_w) = (
        [np.asarray(v) for v in vs] for vs in (got, want))
    assert np.isfinite(L_g).all() and np.isfinite(r_g).all()
    close(L_g, L_w, 2e-6 * np.abs(L_w).max())
    close(r_g, r_w, 2e-5 * np.abs(r_w).max())
    mism = (np.isfinite(n_g) != np.isfinite(n_w)) & ~near_tie(r_w)
    assert not (mism[band] if band else mism).any()
    kept = np.isfinite(n_g)
    np.testing.assert_array_equal(n_g[kept], r_g[kept])


def test_b5_schedule_matches_pallas():
    """The kernel's schedule against the Pallas kernel in interpret mode
    at 6 steps, over the full image (both wrap at the edge); NMS outside
    the Pallas kernel's 2-px band, where it wraps instead of reading -inf."""
    imgs = noise_images(5, 2, 130, 200)
    k = jax.vmap(jakaze._contrast_k)(jnp.asarray(imgs))
    want = pk.akaze_octave_batch(jnp.asarray(imgs), k, steps=6, sigma=1.6,
                                 interpret=True)
    got = b5_schedule(t(imgs), t(k), 6)
    check_b5_outputs(got, want,
                     band=(slice(None), slice(3, -3), slice(3, -3)))


@pytest.mark.parametrize("tile", [(72, 64, 12), (40, 24, 8), (32, 32, 8)])
@pytest.mark.parametrize("steps", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", [(2, 130, 200), (1, 63, 71), (1, 64, 72),
                                   (1, 65, 73), (2, 47, 156), (1, 13, 9)])
def test_b5_schedule_matches_plain(shape, steps, tile):
    """The kernel's schedule against the plain version over the whole
    image: sizes one less, equal and one more than the 72 x 64 tile, KITTI's
    octave 3 and an image smaller than the halo (it wraps more than once),
    at the step counts of the compile-time path (6) and of the run-time
    one, for three tile shapes."""
    x = t(noise_images(16, *shape))
    k = torch.linspace(0.05, 0.2, shape[0])
    got = b5_schedule(x, k, steps, sigma=3.2, TW=tile[0], TH=tile[1],
                      NW=tile[2])
    check_b5_outputs(got, ck.akaze_octave_plain(x, k, steps, sigma=3.2))


def test_b5_rejects_bad_contrast():
    imgs = t(noise_images(6, 2, 20, 30))
    for k in (torch.ones(3), torch.ones(2, dtype=torch.float64)):
        with pytest.raises(ValueError):
            ck.akaze_octave(imgs, k)
    with pytest.raises(ValueError):
        ck.akaze_octave(imgs, torch.ones(2), steps=-1)


# ---------------------------------------------------------------------------
# AKAZE and multiscale Harris, detection + description
# ---------------------------------------------------------------------------

def test_contrast_k_and_budgets(frames):
    """The per-image contrast within 1e-6 relative (the 70th percentile by
    linear interpolation in both); the level budgets equal both JAX
    functions."""
    imgs = np.concatenate([frames, noise_images(8, 2, 128, 256)])
    k_j = np.asarray(jax.vmap(jakaze._contrast_k)(jnp.asarray(imgs)))
    np.testing.assert_allclose(akaze._contrast_k(t(imgs)).numpy(), k_j,
                               rtol=1e-6)
    for max_kp, n in ((256, 2), (256, 4), (1024, 4), (2048, 2), (2048, 3),
                      (512, 1), (300, 3)):
        assert features.level_budgets(max_kp, n) == jakaze._octave_budgets(
            max_kp, n) == jfeat._multiscale_budgets(max_kp, n)


def check_slots(out_t, out_j):
    """``valid`` equal on >= 99% of slots; on slots valid in both, xy within
    1e-3 px, desc within 1e-4 and the same scale."""
    vj = np.asarray(out_j["valid"])
    vt = out_t["valid"].numpy()
    assert vt.shape == vj.shape
    assert (vt == vj).mean() >= 0.99
    both = vt & vj
    assert both.sum() > 0.5 * vj.sum()
    close(out_t["xy"].numpy()[both], np.asarray(out_j["xy"])[both], 1e-3)
    close(out_t["desc"].numpy()[both], np.asarray(out_j["desc"])[both], 1e-4)
    np.testing.assert_array_equal(out_t["scale"].numpy(),
                                  np.asarray(out_j["scale"]))


@pytest.mark.parametrize("max_kp, octaves", [(256, 2), (1024, 4)])
def test_akaze_batch_matches_jax(frames, max_kp, octaves):
    out_j = jakaze.detect_and_describe_akaze_batch(
        jnp.asarray(frames), max_kp=max_kp, octaves=octaves,
        use_pallas=False)
    out_t = akaze.detect_and_describe_akaze_batch(t(frames), max_kp=max_kp,
                                                  octaves=octaves)
    check_slots(out_t, out_j)


def check_paired(out_t, out_j):
    """The same keypoints per frame and level, compared as paired sets:
    Harris responses sit on the unsaturated part of the ranking key's
    sigmoid, so two candidates whose keys differ by the responses' last
    bits may take each other's slot (1.5% of the slots at 2 levels).
    >= 99% of the JAX package's keypoints have a port keypoint of the same
    scale within 1e-3 px, with its descriptor within 1e-4, and the valid
    counts per frame differ by at most 1% of the slots."""
    scale_j = np.asarray(out_j.get("scale", np.ones(out_j["valid"].shape)))
    scale_t = out_t.get("scale", torch.ones(out_t["valid"].shape)).numpy()
    np.testing.assert_array_equal(scale_t, scale_j)
    for f in range(scale_j.shape[0]):
        vj = np.asarray(out_j["valid"][f])
        vt = out_t["valid"][f].numpy()
        assert abs(int(vj.sum()) - int(vt.sum())) <= 0.01 * vj.size
        xj = np.concatenate([np.asarray(out_j["xy"][f]),
                             1e4 * scale_j[f][:, None]], 1)[vj]
        xt = np.concatenate([out_t["xy"][f].numpy(),
                             1e4 * scale_t[f][:, None]], 1)[vt]
        d2 = ((xj[:, None] - xt[None]) ** 2).sum(-1)
        nn = d2.argmin(1)
        paired = d2[np.arange(len(xj)), nn] < 1e-6
        assert paired.mean() >= 0.99
        close(out_t["desc"][f].numpy()[vt][nn[paired]],
              np.asarray(out_j["desc"][f])[vj][paired], 1e-4)


@pytest.mark.parametrize("num_levels", [2, 3])
def test_multiscale_batch_matches_jax(frames, num_levels):
    out_j = jfeat.detect_and_describe_multiscale_batch(
        jnp.asarray(frames), max_kp=512, num_levels=num_levels,
        use_pallas=False)
    out_t = features.detect_and_describe_multiscale_batch(
        t(frames), max_kp=512, num_levels=num_levels)
    check_paired(out_t, out_j)


@pytest.mark.parametrize("detector, levels", [("harris", 1), ("harris", 2),
                                              ("akaze", 1)])
@pytest.mark.parametrize("norm", ["l2", "hamming"])
def test_detect_describe_dispatch(frames, detector, levels, norm):
    """The frontend's detection branch runs every ported detector under
    either norm, from uint8 images: (F, max_kp) slots, +-1 signs under
    Hamming, and the JAX package's branch's keypoints and descriptors."""
    from slam_tpu.models import frontend as jfrontend

    cfg = SlamConfig(features=FeatureConfig(max_kp=256, num_levels=levels,
                                            detector=detector),
                     matching=MatchConfig(norm=norm))
    imgs = (frames * 255).astype(np.uint8)
    out_t = frontend._detect_describe(t(imgs), cfg)
    out_j = jfrontend._detect_describe(jnp.asarray(imgs),
                                       jax_config(cfg))
    assert out_t["desc"].shape == (2, 256, 128)
    if norm == "hamming":
        assert set(np.unique(out_t["desc"].numpy())) == {-1.0, 1.0}
    check_paired(out_t, out_j)


# ---------------------------------------------------------------------------
# binary descriptors under the Hamming norm
# ---------------------------------------------------------------------------

def test_hamming_gate_and_inverse():
    """Gate and inverse equal the JAX package's exactly; the gate passes
    h <= max_hamming and fails h = max_hamming + 1 in the matcher's
    strict test."""
    for h, D in ((40, 128), (0, 128), (7.0, 64), (128, 128)):
        g = binary.base_gate_from_hamming(h, D)
        assert g == jbinary.base_gate_from_hamming(h, D)
        assert (2 - 2 * D) + 4 * h < g <= (2 - 2 * D) + 4 * (h + 1)
    dist = np.array([-254.0, -250.0, 2.0, 258.0, 1e9, 3e9], np.float32)
    np.testing.assert_array_equal(
        binary.hamming_from_base(t(dist)).numpy(),
        np.asarray(jbinary.hamming_from_base(jnp.asarray(dist))))


def test_binarize_matches_jax(frames):
    """Bits of the same float descriptors equal on >= 99.9% of valid dims
    (a dimension within rounding of its descriptor's mean may differ)."""
    out = jfeat.detect_and_describe_batch(jnp.asarray(frames), max_kp=512,
                                          use_pallas=False)
    desc, valid = np.asarray(out["desc"]), np.asarray(out["valid"])
    b_j = np.asarray(jbinary.binarize_descriptors(jnp.asarray(desc)))
    b_t = binary.binarize_descriptors(t(desc)).numpy()
    assert b_t.dtype == np.float32 and set(np.unique(b_t)) == {-1.0, 1.0}
    assert (b_t == b_j)[valid].mean() >= 0.999
    assert valid.sum() > 200


def hamming_sets(seed, B, Ka, Kb, D=128):
    """+-1 bit sets with many exact ties: B's rows are copies of A's rows
    with 0-6 bits flipped, A holds duplicated rows, positions shifted as a
    stereo pair."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (B, Ka, D))
    a[:, 1::4] = a[:, ::4][:, :a[:, 1::4].shape[1]]      # duplicates
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
def test_hamming_mutual_match_matches_jax_and_popcount(window):
    """Indices equal everywhere, ties included: the port's Hamming matches
    against the JAX package's hamming_mutual_match, and B2's (plain
    version's) row and column argmins against the lowest-index argmin of
    the popcount distances (hamming_distance_matrix_ref) with the same
    validity and window masks."""
    sa, sb, va, vb, xa, xb = hamming_sets(9, 2, 300, 340)
    out_t = binary.hamming_mutual_match(t(sa), t(sb), t(va), t(vb),
                                        max_hamming=40, xy_a=t(xa),
                                        xy_b=t(xb), window=window)
    rd, ri, cd, ci = ck.mutual_nearest(t(sa), t(sb), t(va), t(vb), t(xa),
                                       t(xb), window)
    for i in range(sa.shape[0]):
        out_j = jbinary.hamming_mutual_match(
            jnp.asarray(sa[i]), jnp.asarray(sb[i]), jnp.asarray(va[i]),
            jnp.asarray(vb[i]), max_hamming=40, xy_a=jnp.asarray(xa[i]),
            xy_b=jnp.asarray(xb[i]), window=window)
        for key in ("matched", "target_idx", "dist"):
            np.testing.assert_array_equal(out_t[key][i].numpy(),
                                          np.asarray(out_j[key]))
        ham = jbinary.hamming_distance_matrix_ref(sa[i], sb[i])
        big = np.zeros(ham.shape, np.float64)
        if window is not None:
            dx = xb[i][None, :, 0] - xa[i][:, None, 0]
            dy = np.abs(xb[i][None, :, 1] - xa[i][:, None, 1])
            big += (dx < window[0]) | (dx > window[1]) | (dy > window[2])
        # B2's penalties (1e30) absorb the distance: every penalized
        # candidate ties, and the lowest index wins among them too
        row = ham + 1e30 * (big + ~vb[i][None, :])
        col = ham + 1e30 * (big + ~va[i][:, None])
        np.testing.assert_array_equal(ri[i].numpy(), np.argmin(row, axis=1))
        np.testing.assert_array_equal(ci[i].numpy(), np.argmin(col, axis=0))
        ok = out_t["matched"][i].numpy()
        np.testing.assert_array_equal(
            out_t["dist"][i].numpy()[ok],
            ham[np.nonzero(ok)[0], out_t["target_idx"][i].numpy()[ok]])
    assert 100 < int(out_t["matched"].sum())
    assert matching.BIG in out_t["dist"]
