"""ORB-family detection: FAST-9 corners and steered BRIEF bits, batched
over images.

Counterpart of ``slam_tpu/ops/orb.py``, the third detector of the
reference's feature factory (``cv2.ORB_create``):

  * FAST-9 for every pixel at once: the 16 ring neighbours are
    ``torch.roll`` shifts of the image (they wrap at the edge, inside the
    detection border), and ">= 9 contiguous brighter (darker) than the
    centre by the threshold" is a log-doubling AND over circular
    rotations of the 16 comparison masks; the response is the sum of the
    arc excesses |d| - t on the polarity that qualifies;
  * the gridded top-K of ``features.select_keypoints``;
  * orientation by the intensity centroid of a 31x31 square patch, as two
    separable convolutions (box then ramp) per moment;
  * 128 BRIEF pair tests on the sigma 2 blurred image, the fixed pattern
    rotated by each keypoint's angle, one gather for all keypoints; bits
    stored as +-1/sqrt(128), so the L2 matcher's distance is an affine
    map of the Hamming distance (and ``binary.binarize_descriptors``
    recovers the bits under ``norm="hamming"``).

Every stage is torch ops on (F, H, W) images; matching the descriptors
goes through kernel B2. The constants below are copies of the JAX
package's (the pattern from the same seeded ``np.random.RandomState``).

Images are (F, H, W) float32 in [0, 1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import features

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock, as
# (dy, dx) pairs: the FAST ring
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

_ARC = 9           # FAST-9: the contiguous run length required
PATCH_R = 15       # orientation patch radius (31x31 square)
DESC_BITS = 128    # one bit per descriptor dimension
_PATTERN_R = 13.0  # BRIEF pattern radius (px)


def _brief_pattern() -> np.ndarray:
    """Static (256, 2) float32 test points (pairs i / i + 128): Gaussian
    offsets of std _PATTERN_R / 2 from a fixed seed, clipped to
    _PATTERN_R."""
    rs = np.random.RandomState(0xB51EF)
    pts = rs.randn(2 * DESC_BITS, 2) * (_PATTERN_R / 2.0)
    return np.clip(pts, -_PATTERN_R, _PATTERN_R).astype(np.float32)


_PATTERN = _brief_pattern()


@functools.lru_cache(maxsize=None)
def _pattern_on(device: torch.device) -> torch.Tensor:
    """The pattern on ``device``, copied there once."""
    return torch.from_numpy(_PATTERN).to(device)


def _circle_shifts(imgs: torch.Tensor) -> torch.Tensor:
    """(F, 16, H, W): each pixel's ring neighbours (wrapping at the edge)."""
    return torch.stack([torch.roll(imgs, (-int(dy), -int(dx)),
                                   dims=(-2, -1)) for dy, dx in _CIRCLE],
                       dim=1)


def _contiguous_run(mask: torch.Tensor, n: int = _ARC) -> torch.Tensor:
    """(F, 16, H, W) bool -> (F, H, W): any circular run of >= n Trues,
    by run(a + b)[s] = run(a)[s] & run(b)[s + a]: three doublings to 8,
    then one step to 9."""
    run = mask
    length = 1
    while length * 2 <= n:
        run = run & torch.roll(run, -length, dims=1)
        length *= 2
    if length < n:
        run = run & torch.roll(mask, -length, dims=1)
    return torch.any(run, dim=1)


def fast_response(imgs: torch.Tensor, threshold: float = 0.06
                  ) -> torch.Tensor:
    """Dense FAST-9 score (F, H, W): 0 off corners, else
    sum(max(|d| - t, 0)) over the ring on the qualifying polarity."""
    d = _circle_shifts(imgs) - imgs[:, None]
    bright = _contiguous_run(d > threshold)
    dark = _contiguous_run(d < -threshold)
    sb = torch.sum(torch.clamp(d - threshold, min=0.0), dim=1)
    sd = torch.sum(torch.clamp(-d - threshold, min=0.0), dim=1)
    return torch.where(bright, sb, 0.0) + torch.where(dark, sd, 0.0)


def orientation_moment_maps(imgs: torch.Tensor):
    """Intensity-centroid first moments (m10, m01) of the 31x31 square
    around every pixel: a column (row) box sum, then a ramp along the
    other axis."""
    dev = imgs.device
    ones = torch.ones((2 * PATCH_R + 1, 1), device=dev)
    ramp = torch.arange(-PATCH_R, PATCH_R + 1, dtype=torch.float32,
                        device=dev)
    m10 = features._conv2d_same(features._conv2d_same(imgs, ones),
                                ramp[None, :])
    m01 = features._conv2d_same(features._conv2d_same(imgs, ones.T),
                                ramp[:, None])
    return m10, m01


def _pixel_at(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(F, H, W) maps sampled at the rounded, clipped (F, K) keypoints."""
    Fb, H, W = maps.shape
    xi = torch.clamp(torch.round(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).long(), 0, H - 1)
    return torch.gather(maps.reshape(Fb, H * W), 1, yi * W + xi)


def describe_brief(img_blur: torch.Tensor, xy: torch.Tensor,
                   angle: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF (F, K, 128) in +-1/sqrt(128): bit i is set iff the
    blurred image at rotated test point a_i is below that at b_i."""
    Fb, H, W = img_blur.shape
    K = xy.shape[1]
    pat = _pattern_on(img_blur.device)
    c = torch.cos(angle)[..., None]                       # (F, K, 1)
    s = torch.sin(angle)[..., None]
    ax, ay = pat[:, 0], pat[:, 1]                          # (256,)
    px = xy[..., 0:1] + c * ax - s * ay                    # (F, K, 256)
    py = xy[..., 1:2] + s * ax + c * ay
    xi = torch.clamp(torch.round(px).long(), 0, W - 1)
    yi = torch.clamp(torch.round(py).long(), 0, H - 1)
    vals = torch.gather(img_blur.reshape(Fb, H * W), 1,
                        (yi * W + xi).reshape(Fb, K * 2 * DESC_BITS))
    vals = vals.reshape(Fb, K, 2 * DESC_BITS)
    bits = vals[..., :DESC_BITS] < vals[..., DESC_BITS:]
    scale = 1.0 / np.sqrt(DESC_BITS)
    desc = torch.where(bits, scale, -scale)
    return torch.where(valid[..., None], desc, 0.0)


def detect_and_describe_orb_batch(imgs: torch.Tensor,
                                  max_kp: int = features.DEFAULT_MAX_KP,
                                  threshold: float = 0.06) -> dict:
    """ORB detect + describe over (F, H, W) images. Returns xy, desc
    (+-1/sqrt(128) bit signs), valid, resp and ``angle``, each
    (F, max_kp, ...)."""
    resp = fast_response(imgs, threshold)
    det = features.select_keypoints(resp, features.nms(resp), max_kp,
                                    min_response=1e-9)
    m10, m01 = orientation_moment_maps(imgs)
    angle = torch.atan2(_pixel_at(m01, det["xy"]), _pixel_at(m10, det["xy"]))
    blur = features.gaussian_blur(imgs, 2.0, 4)
    desc = describe_brief(blur, det["xy"], angle, det["valid"])
    return {"xy": det["xy"], "desc": desc, "valid": det["valid"],
            "resp": det["resp"], "angle": angle}


def detect_and_describe_orb(img: torch.Tensor,
                            max_kp: int = features.DEFAULT_MAX_KP,
                            threshold: float = 0.06) -> dict:
    """:func:`detect_and_describe_orb_batch` on one (H, W) image."""
    return features.per_image(detect_and_describe_orb_batch, img,
                              max_kp=max_kp, threshold=threshold)


def fast_response_ref(img: np.ndarray, threshold: float = 0.06
                      ) -> np.ndarray:
    """Brute-force FAST-9 of one (H, W) image on the host, per start
    position of the run (the tests' reference)."""
    img = np.asarray(img, np.float64)
    H, W = img.shape
    out = np.zeros((H, W))
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            d = np.array([img[y + dy, x + dx] for dy, dx in _CIRCLE]
                         ) - img[y, x]
            for sign in (1.0, -1.0):
                m = sign * d > threshold
                if any(all(m[(s + i) % 16] for i in range(_ARC))
                       for s in range(16)):
                    out[y, x] += np.maximum(sign * d - threshold, 0.0).sum()
    return out
