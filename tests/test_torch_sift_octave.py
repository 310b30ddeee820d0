"""Kernel B8 (``cuda_kernels.sift_octave``, csrc/sift_octave.cu): one SIFT
octave's scale space in one pass, and its plain version.

On the CPU the plain version is held, exactly, to the composition the
SIFT detector ran before B8: ``gaussian_pyramid_octave``, the DoGs,
``_octave_response``, ``features.nms`` and ``_scale_of``'s parabola, as
the benchmark's frozen reference ``slambench/reference/slamref`` still
holds them; and the detector through it to that reference's detector
(``test_torch_sift.py`` holds it to the JAX package). The ``cuda`` tests
hold the kernel to the plain version on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sift_octave.py

Both the card tests and ``chip_smoke.py``'s phase 2f hold B8 to the
plain version by ``tests/sift_octave_check.py``'s one rule (its
tolerances and their reasons are stated there): no decision, response
or interval value may differ at a pixel away from the plain version's
decision margin.

The module imports no JAX: the card tests run where JAX is absent.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from slam_tpu_torch.config import FeatureConfig, RansacConfig, RuntimeConfig
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.models import frontend
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import features, sift

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent / "slambench"
for _p in (str(HERE), str(BENCH), str(BENCH / "reference")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from sift_octave_check import LEVEL_TOL, compare  # noqa: E402
from slamref.ops import features as ref_features  # noqa: E402
from slamref.ops import sift as ref_sift  # noqa: E402

torch.set_num_threads(2)

CONTRAST = 0.04 / 3          # the benchmark's kitti00_sift


def noise(seed, F, H, W):
    return torch.from_numpy(
        np.random.default_rng(seed).random((F, H, W)).astype(np.float32))


def octave_base(x: torch.Tensor) -> torch.Tensor:
    """An octave's base as the detector makes it: the images doubled and
    pre-blurred to sigma0."""
    pre = float((sift.SIGMA0 ** 2 - 1.0) ** 0.5)
    return features.gaussian_blur(sift.upsample2(x), pre,
                                  sift._blur_radius(pre)).contiguous()


def old_composition(level, contrast, intervals):
    """The frozen reference's scale space of one octave: (resp, nms,
    best_i, dogs, next base)."""
    gauss = ref_sift.gaussian_pyramid_octave(level, intervals)
    dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
    resp, best_i = ref_sift._octave_response(dogs, contrast)
    return (resp, ref_features.nms(resp), best_i, dogs,
            gauss[intervals][..., ::2, ::2])


def every_pixel(F, H, W):
    """(F, H * W, 2) xy of every pixel, row by row."""
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1).float()
    return xy[None].expand(F, -1, -1)


# ---------------------------------------------------------------------------
# the plain version against the composition it replaced (CPU)
# ---------------------------------------------------------------------------

def flat_patch(seed, F, H, W):
    """Noise with a flat patch wide enough to stay flat through every blur
    (47 pixels from its centre to its edge, the radii sum to 31): its DoGs
    are constant there, the non-strict extremum tests tie, and the
    contrast gate decides."""
    x = noise(seed, F, H, W)
    x[:, 8:H - 8, 8:W - 8] = 0.5
    return x


@pytest.mark.parametrize("case,intervals,contrast", [
    ("noise", 3, CONTRAST), ("flat", 3, CONTRAST), ("base", 3, 0.015),
    ("noise", 2, CONTRAST), ("noise", 4, 0.0)])
def test_plain_equals_old_composition(case, intervals, contrast):
    """resp, nms and the next base equal the old composition's bit for
    bit, and _scale_of over the interval map equals the old _scale_of at
    every pixel (o_eff -1 and 2), on noise, on a flat patch and on a
    detector-made base, at 2 to 4 intervals and contrast 0."""
    if case == "noise":
        x = noise(1, 2, 56, 88)
    elif case == "flat":
        x = flat_patch(2, 1, 112, 128)
    else:
        x = octave_base(noise(3, 1, 30, 44))
    resp, nms, s, nxt = ck.sift_octave_plain(x, contrast, intervals)
    o_resp, o_nms, best_i, dogs, o_next = old_composition(x, contrast,
                                                          intervals)
    assert torch.equal(resp, o_resp) and torch.equal(nms, o_nms)
    assert torch.equal(nxt, o_next) and nxt.is_contiguous()
    xy = every_pixel(*x.shape)
    for o_eff in (-1, 2):
        assert torch.equal(
            sift._scale_of(s, xy, o_eff, intervals),
            ref_sift._scale_of(dogs, best_i, xy, o_eff, intervals))
    assert (resp > 0).any()
    if case == "flat":
        # inside the patch every DoG is constant (below the contrast): no
        # interval passes, the response is 0 and the interval map's
        # parabola runs through DoGs 0, 0 and 1
        c = (slice(None), slice(55, 58), slice(63, 66))
        for d in dogs:
            assert (d[c] == d[0, 56, 64]).all()
        assert (resp[c] == 0).all() and (best_i[c] == 0).all()


def test_plain_last_octave_has_no_next_base():
    x = noise(4, 1, 40, 52)
    out = ck.sift_octave_plain(x, CONTRAST, last=True)
    assert out[3] is None
    for a, b in zip(out[:3], ck.sift_octave_plain(x, CONTRAST)[:3]):
        assert torch.equal(a, b)


def bump(H, W, cy, cx, sigma):
    yy, xx = torch.meshgrid(torch.arange(H).float(), torch.arange(W).float(),
                            indexing="ij")
    return torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def test_first_interval_wins_a_tie():
    """DoGs where intervals 1 and 2 pass with the same |DoG| (a bump up in
    DoG 1, the same bump down in DoG 2): interval 1 wins, as the old
    composition has it, and the interval map's parabola is the old
    _scale_of's."""
    H = W = 24
    b = bump(H, W, 12, 12, 2.0)[None] * 0.1
    z = torch.zeros_like(b)
    dogs = [z, b, -b, z, z]
    resp, best_i = sift._octave_response(dogs, CONTRAST)
    o_resp, o_best = ref_sift._octave_response(dogs, CONTRAST)
    assert torch.equal(resp, o_resp) and torch.equal(best_i, o_best)
    assert int(best_i[0, 12, 12]) == 1
    assert float(resp[0, 12, 12]) == pytest.approx(0.1)
    s = sift._interval_map(dogs, best_i)
    xy = every_pixel(1, H, W)
    assert torch.equal(sift._scale_of(s, xy, 0, 3),
                       ref_sift._scale_of(dogs, best_i, xy, 0, 3))


def zero_padded_edge_ok(d, r=sift.EDGE_R):
    """Lowe's edge test with the DoG read as 0 outside the image (B8's
    rule) where the plain version wraps."""
    p = Fn.pad(d, (1, 1, 1, 1))
    H, W = d.shape[-2:]

    def at(dy, dx):
        return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    dxx = at(0, 1) - 2.0 * d + at(0, -1)
    dyy = at(1, 0) - 2.0 * d + at(-1, 0)
    dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    return (det > 0) & (tr * tr < (r + 1.0) ** 2 / r * det)


def test_plain_edge_test_wraps_at_the_border():
    """The plain version's edge test wraps at the image edge (torch.roll):
    on the outer 1-pixel frame it decides otherwise than a zero-padded
    one somewhere, inside the frame never, and the response follows the
    wrap."""
    x = noise(5, 2, 64, 80)
    gauss = sift.gaussian_pyramid_octave(x)
    dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
    frame = torch.ones(64, 80, dtype=torch.bool)
    frame[1:-1, 1:-1] = False
    differ = torch.zeros_like(dogs[0], dtype=torch.bool)
    for d in dogs[1:-1]:
        diff = sift._edge_ok(d) != zero_padded_edge_ok(d)
        assert not diff[:, ~frame].any()
        differ |= diff
    assert differ[:, frame].any()
    resp = ck.sift_octave_plain(x, CONTRAST)[0]
    assert torch.equal(resp, ref_sift._octave_response(dogs, CONTRAST)[0])


@pytest.mark.parametrize("fault", ["none", "lost", "gained", "resp", "s",
                                   "nms", "next"])
def test_b8_comparison_catches_each_fault(fault):
    """sift_octave_check.compare, the rule the card tests and chip_smoke's
    phase 2f hold B8 to, passes the plain version's own outputs and fails
    each fault of a handful of pixels: responses lost or gained, a
    response or an interval value moved, an NMS map that is not the
    response's, a next base moved."""
    x = octave_base(noise(10, 1, 40, 64))
    resp, nms, s, nxt = ck.sift_octave_plain(x, CONTRAST)
    resp, s, nxt = resp.clone(), s.clone(), nxt.clone()
    inner = torch.zeros_like(resp, dtype=torch.bool)
    inner[:, 4:-4, 4:-4] = True
    hits = (inner & (resp > 0)).nonzero()[:3].unbind(1)
    assert len(hits[0]) == 3
    if fault == "lost":
        resp[hits] = 0.0
    elif fault == "gained":
        resp[(inner & (resp == 0)).nonzero()[:3].unbind(1)] = 0.5
    elif fault == "resp":
        resp[hits] += 1e-3
    elif fault == "s":
        s[hits] += 0.01
    elif fault == "next":
        nxt[0, 5, 5] += 1e-4
    if fault != "nms":
        nms = features.nms(resp)
    else:
        nms = nms.clone()
        nms[0, 20, 30] = 1.0
    got = compare(x, (resp, nms, s, nxt), CONTRAST)
    assert bool(got["problems"]) == (fault != "none"), got["problems"]
    assert got["respond"] > 0 and got["next_plain"].shape == nxt.shape


def test_plain_call_is_counted():
    ck.reset_counters()
    ck.sift_octave(noise(6, 1, 24, 30), CONTRAST)
    assert ck.PLAIN_CALLS["sift_octave"] == 1
    assert ck.LAUNCHES["sift_octave"] == 0


@pytest.mark.parametrize("case", ["ndim", "dtype", "device"])
def test_sift_octave_rejects_bad_input(case):
    bad = {"ndim": torch.zeros((4, 5)),
           "dtype": torch.zeros((1, 8, 8), dtype=torch.float64),
           "device": torch.zeros((1, 8, 8), device="meta")}[case]
    with pytest.raises(ValueError, match="sift_octave"):
        ck.sift_octave(bad, CONTRAST)


def test_blur_ladder_is_the_pyramid_s():
    """The ladder B8's wrapper hands over is the one the plain pyramid
    blurs with: cv2's radii 4, 5, 6, 7, 9 at 3 intervals (134 taps a
    pixel over both passes), and the same taps."""
    ladder = sift.blur_ladder()
    assert [r for _, r in ladder] == [4, 5, 6, 7, 9]
    assert sum(2 * (2 * r + 1) for _, r in ladder) == 134
    x = noise(7, 1, 30, 40)
    level = x
    for (sig, r), want in zip(ladder, sift.gaussian_pyramid_octave(x)[1:]):
        level = features.gaussian_blur(level, sig, r)
        assert torch.equal(level, want)
    assert [len(sift.blur_ladder(i)) for i in (2, 4, 5)] == [4, 6, 7]


def test_detector_through_plain_equals_old_detector():
    """detect_and_describe_sift_batch, now one sift_octave call an
    octave, equals the frozen reference's detector bit for bit on the
    CPU, at the benchmark's settings (K = 2500, 5 octaves) and at the
    per-image default (3 octaves)."""
    x = features.gaussian_blur(noise(8, 2, 96, 160), 1.5, 4)
    for kw in (dict(max_kp=2500, octaves=5, contrast=CONTRAST),
               dict(max_kp=512, octaves=3)):
        ck.reset_counters()
        got = sift.detect_and_describe_sift_batch(x, **kw)
        assert ck.PLAIN_CALLS["sift_octave"] == kw["octaves"]
        want = ref_sift.detect_and_describe_sift_batch(x, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert got["valid"].any()


def test_sift_frontend_chunk_calls_b8_once_per_octave():
    """The SIFT frontend's detection over a chunk's 2F images calls
    sift_octave once per octave (frontend.detector_levels), on the plain
    version here."""
    cfg = SlamConfig(features=FeatureConfig(detector="sift", max_kp=1024,
                                            num_levels=3,
                                            sift_contrast=CONTRAST),
                     ransac=RansacConfig(num_hypotheses=16),
                     runtime=RuntimeConfig(chunk_frames=2))
    ck.reset_counters()
    frontend._detect_describe(noise(9, 4, 64, 96), cfg)
    assert ck.PLAIN_CALLS["sift_octave"] == frontend.detector_levels(
        cfg.features) == 4
    assert ck.LAUNCHES["sift_octave"] == 0


def test_roofline_b8_against_chip_smoke():
    """The benchmark's roofline_pct.b8_sift_octave counts a chunk's five
    octaves of sift.loop80 (752x2482 halving with ceil) by chip_smoke.py's
    bytes and operations, and reads nothing from launches that are not
    whole chunks' octaves."""
    import chip_smoke
    from harness import runner, spec
    from harness.trace import DeviceEvent, Trace

    name = "void sift_octave_kernel<5>(...)"
    ev = [DeviceEvent(name, 100 * i, 100 * i + 50) for i in range(10)]

    def ctx(events):
        return runner.MetricContext(spec.load_cell("sift.loop80"), [],
                                    Trace(events, [], 0, 1000))

    want = 0.0
    H, W = 752, 2482
    for o in range(5):
        b_ms, _ = chip_smoke.b8_bound(64, H, W, last=o == 4)
        want += b_ms * 1e-3
        H, W = math.ceil(H / 2), math.ceil(W / 2)
    metric = runner.load_metric("roofline_pct.b8_sift_octave")
    assert metric.read(ctx(ev)) == pytest.approx(100 * 2 * want / 500e-6)
    assert metric.read(ctx(ev[:9])) is None
    assert metric.read(ctx([])) is None
    assert metric.read(runner.MetricContext(spec.load_cell("sift.loop80"),
                                            [], None)) is None


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (B8 is CUDA C++, with no CPU mode)")
    return torch.device("cuda")


def check_b8(level, contrast=CONTRAST, intervals=sift.INTERVALS,
             last=False, label=""):
    """B8 against its plain version on ``level`` (sift_octave_check's
    rule); the kernel's launch counted and no plain call. Returns
    sift_octave_check.compare's readings."""
    ck.reset_counters()
    out = ck.sift_octave(level, contrast, intervals, last)
    assert ck.LAUNCHES["sift_octave"] == 1
    assert ck.PLAIN_CALLS["sift_octave"] == 0
    got = compare(level, out, contrast, intervals, last)
    assert not got["problems"], f"{label}: {got['problems']}"
    return got


# the frontend's five octave shapes at sift.loop80's chunk (2 x 32
# images of 376x1241, doubled)
MAIN_SHAPES = ((64, 752, 2482), (64, 376, 1241), (64, 188, 621),
               (64, 94, 311), (64, 47, 156))


@pytest.mark.cuda
def test_cuda_sift_octave_main_path_octaves(cuda):
    """The five octaves of a chunk of smooth images, each octave's base
    the plain version's next base of the one before: (64, 752, 2482) down
    to (64, 47, 156)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((64, 376, 1241), generator=gen, device=cuda)
    level = octave_base(features.gaussian_blur(x, 1.5, 4))
    for o, shape in enumerate(MAIN_SHAPES):
        assert tuple(level.shape) == shape
        last = o == len(MAIN_SHAPES) - 1
        got = check_b8(level, last=last, label=f"octave {o}")
        print(f"[B8] octave {o} {shape}: {got['pixels']} pixels, "
              f"{got['respond']} respond, {got['near_differ']} differ at "
              f"the margins, next base err {got['next_err']:.3e}")
        assert got["respond"] > 0
        level = got["next_plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 47, 156), (1, 33, 63), (3, 65, 129),
                                   (1, 13, 9), (2, 101, 333), (1, 64, 64),
                                   (1, 2, 3), (2, 40, 317), (1, 71, 700)])
def test_cuda_sift_octave_ragged_shapes(cuda, shape):
    """Raw noise at odd sizes, narrower than one block's output columns,
    smaller than the blurs' halo, and wider than one block (316 output
    columns at 3 intervals); where the plain version has no response
    inside the frame, the kernel must have none either."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.rand(shape, generator=gen, device=cuda)
    if min(shape[1:]) >= 8:
        check_b8(x, label=str(shape))
    else:  # no pixel inside the frame: the NMS map and the next base
        resp, nms, s, nxt = ck.sift_octave(x, CONTRAST)
        assert torch.equal(nms, features.nms(resp))
        want = sift.gaussian_pyramid_octave(x)[3][..., ::2, ::2]
        assert float((nxt - want).abs().max()) <= LEVEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("intervals,contrast", [(2, CONTRAST), (4, 0.015),
                                                (5, 0.0), (3, 0.015)])
def test_cuda_sift_octave_other_ladders(cuda, intervals, contrast):
    gen = torch.Generator(device=cuda).manual_seed(intervals)
    x = features.gaussian_blur(
        torch.rand((2, 120, 200), generator=gen, device=cuda), 1.2, 4)
    assert check_b8(x.contiguous(), contrast, intervals,
                    label=f"intervals {intervals}")["respond"] > 0


@pytest.mark.cuda
def test_cuda_sift_octave_last_octave(cuda):
    """The last octave gives no next base and the same response, NMS map
    and interval map; a second launch gives the same outputs bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.rand((3, 301, 400), generator=gen, device=cuda)
    a = ck.sift_octave(x, CONTRAST)
    for u, v in zip(a, ck.sift_octave(x, CONTRAST)):
        assert torch.equal(u, v)
    c = ck.sift_octave(x, CONTRAST, last=True)
    assert c[3] is None
    for u, v in zip(a[:3], c[:3]):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_cuda_sift_octave_rejects(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((1, 40, 60), generator=gen, device=cuda)
    for intervals in (1, 6):
        with pytest.raises(ValueError, match="intervals"):
            ck.sift_octave(x, CONTRAST, intervals=intervals)
