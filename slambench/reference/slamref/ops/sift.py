"""DoG scale-space (SIFT-style) detection, batched over images.

Counterpart of ``slam_tpu/ops/sift.py``, the reference's active detector
family (``cv2.SIFT_create``): per octave, ``intervals + 3`` Gaussian
images by incremental blurs, their differences, the 3x3x3 extremum test
with the contrast and edge gates, one response per octave (the largest
gated |DoG| over the intervals), the gridded top-K of
``features.select_keypoints``, a parabola along the scale axis for each
keypoint's continuous sigma, and the SIFT-style descriptor on the
octave's base Gaussian image. The first octave is cv2's '-1' octave: the
image doubled bilinearly. Octaves after the first decimate
``gauss[intervals]`` (sigma = 2 sigma0) by 2, with no extra blur.

On the card each octave's descriptor maps come from kernel B3
(``cuda_kernels.orientation_maps``), on the whole batch; everything else
is torch ops over (F, H, W) images. Differences wrap at the image edge
(``torch.roll`` for ``jnp.roll``), window maxima read -inf outside it.

Images are (F, H, W) float32 in [0, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from . import features

# cv2.SIFT defaults: 3 intervals per octave, sigma0 = 1.6, edge ratio 10
INTERVALS = 3
SIGMA0 = 1.6
EDGE_R = 10.0


def _blur_radius(sigma: float) -> int:
    return max(2, int(3.0 * sigma + 0.5))


def upsample2(imgs: torch.Tensor) -> torch.Tensor:
    """(F, H, W) -> (F, 2H, 2W) bilinear, half-pixel centres, edge samples
    from the edge pixel alone: ``jax.image.resize(..., "linear")``."""
    F, H, W = imgs.shape
    return Fn.interpolate(imgs[:, None], size=(2 * H, 2 * W),
                          mode="bilinear", align_corners=False,
                          antialias=False)[:, 0]


def gaussian_pyramid_octave(imgs: torch.Tensor, intervals: int = INTERVALS,
                            sigma0: float = SIGMA0) -> list:
    """The ``intervals + 3`` Gaussian images of one octave: level i has
    total sigma ``sigma0 * 2^(i / intervals)``, each blur applying only the
    increment over the level before."""
    k = 2.0 ** (1.0 / intervals)
    levels = [imgs]
    sig_prev = sigma0
    for _ in range(intervals + 2):
        sig_next = sig_prev * k
        sig_inc = float((sig_next ** 2 - sig_prev ** 2) ** 0.5)
        levels.append(features.gaussian_blur(levels[-1], sig_inc,
                                             _blur_radius(sig_inc)))
        sig_prev = sig_next
    return levels


def _max3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window maximum, -inf outside the image: the maximum of shifted
    copies along each axis (max is exact, so any order gives the same
    values)."""
    p = Fn.pad(x, (1, 1, 1, 1), value=-math.inf)
    r = torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]), p[..., 2:])
    return torch.maximum(torch.maximum(r[..., :-2, :], r[..., 1:-1, :]),
                         r[..., 2:, :])


def _extrema_mask(d_prev, d_cur, d_next) -> torch.Tensor:
    """3x3x3 extremum mask of the middle DoG level: at least the 3x3
    maximum (or at most the minimum) of its own level, whose window holds
    the pixel itself, and of both neighbouring levels."""
    is_max = ((d_cur >= _max3(d_cur)) & (d_cur >= _max3(d_prev))
              & (d_cur >= _max3(d_next)))
    is_min = ((d_cur <= -_max3(-d_cur)) & (d_cur <= -_max3(-d_prev))
              & (d_cur <= -_max3(-d_next)))
    return is_max | is_min


def _edge_ok(d: torch.Tensor, r: float = EDGE_R) -> torch.Tensor:
    """Lowe's edge test on a DoG map: tr^2 / det < (r + 1)^2 / r."""
    dxx = (torch.roll(d, -1, dims=-1) - 2.0 * d + torch.roll(d, 1, dims=-1))
    dyy = (torch.roll(d, -1, dims=-2) - 2.0 * d + torch.roll(d, 1, dims=-2))
    dxy = 0.25 * (torch.roll(d, (-1, -1), dims=(-2, -1))
                  + torch.roll(d, (1, 1), dims=(-2, -1))
                  - torch.roll(d, (-1, 1), dims=(-2, -1))
                  - torch.roll(d, (1, -1), dims=(-2, -1)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    thr = (r + 1.0) ** 2 / r
    return (det > 0) & (tr * tr < thr * det)


def _octave_response(dogs: list, contrast: float):
    """(F, H, W) response (largest gated |DoG| over the middle intervals,
    0 where none passes) and the interval it came from."""
    resp = torch.full_like(dogs[0], -math.inf)
    best_i = torch.zeros(dogs[0].shape, dtype=torch.int64,
                         device=dogs[0].device)
    for i in range(1, len(dogs) - 1):
        mask = (_extrema_mask(dogs[i - 1], dogs[i], dogs[i + 1])
                & (torch.abs(dogs[i]) > contrast) & _edge_ok(dogs[i]))
        r = torch.where(mask, torch.abs(dogs[i]), -math.inf)
        best_i = torch.where(r > resp, i, best_i)
        resp = torch.maximum(resp, r)
    return torch.where(torch.isfinite(resp), resp, 0.0), best_i


def _scale_of(dogs: list, best_i, xy, o_eff: int, intervals: int):
    """Continuous sigma (level-0 px) of the selected keypoints: the
    winning interval plus a parabola through the DoG along the scale
    axis, clipped to half an interval."""
    Fb, H, W = dogs[0].shape
    xi = torch.clamp(torch.round(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).long(), 0, H - 1)
    pix = yi * W + xi                                           # (F, K)
    ii = torch.gather(best_i.reshape(Fb, H * W), 1, pix)
    # every DoG level at the keypoints (F, levels, K), then by level
    vals = torch.stack([torch.gather(d.reshape(Fb, H * W), 1, pix)
                        for d in dogs], dim=1)

    def at(level):
        return torch.gather(vals, 1, level[:, None])[:, 0]

    d_c = at(ii)
    d_p = at(torch.clamp(ii - 1, min=0))
    d_n = at(torch.clamp(ii + 1, max=len(dogs) - 1))
    denom = d_n - 2.0 * d_c + d_p
    ok = torch.abs(denom) > 1e-12
    di = torch.where(ok, -0.5 * (d_n - d_p) / torch.where(
        ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    di = torch.clamp(di, -0.5, 0.5)
    return SIGMA0 * torch.pow(2.0, o_eff + (ii.float() + di) / float(
        intervals))


def detect_and_describe_sift_batch(imgs: torch.Tensor,
                                   max_kp: int = features.DEFAULT_MAX_KP,
                                   octaves: int = 4,
                                   intervals: int = INTERVALS,
                                   contrast: float = 0.015,
                                   upsample: bool = True) -> dict:
    """DoG detection + description over (F, H, W) images, the whole batch
    at once: kernel B3 once per octave. Returns xy (level-0 px), desc,
    valid, resp and ``scale`` (continuous sigma in level-0 px, 0 on
    invalid slots), each (F, max_kp, ...), the first octave's slots
    first."""
    from .cuda_kernels import orientation_maps

    if upsample:
        # the doubled image carries sigma ~1.0 (2 x the camera's ~0.5)
        level = upsample2(imgs)
        pre = float((SIGMA0 ** 2 - 1.0 ** 2) ** 0.5)
    else:
        level = imgs
        pre = float((SIGMA0 ** 2 - 0.5 ** 2) ** 0.5)
    level = features.gaussian_blur(level, pre, _blur_radius(pre))
    out = {key: [] for key in ("xy", "desc", "valid", "resp", "scale")}
    budgets = features.level_budgets(max_kp, octaves)
    for o, k in enumerate(budgets):
        gauss = gaussian_pyramid_octave(level, intervals)
        dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
        resp, best_i = _octave_response(dogs, contrast)
        det = features.select_keypoints(
            resp, features.nms(resp), k, cell=16,
            border=features.level_border(o), min_response=contrast * 0.5)
        o_eff = o - 1 if upsample else o
        sigma = _scale_of(dogs, best_i, det["xy"], o_eff, intervals)
        desc = features.describe(det["xy"], det["valid"],
                                 orientation_maps(gauss[0].contiguous()))
        out["xy"].append(det["xy"] * float(2.0 ** o_eff))
        out["desc"].append(desc)
        out["valid"].append(det["valid"])
        out["resp"].append(det["resp"])
        out["scale"].append(torch.where(det["valid"], sigma, 0.0))
        if o + 1 < octaves:
            # gauss[intervals] has sigma 2 sigma0: decimation alone keeps
            # the ladder exact (sigma0 at half resolution)
            level = gauss[intervals][..., ::2, ::2].contiguous()
        del gauss, dogs
    return {key: torch.cat(parts, dim=1) for key, parts in out.items()}


def detect_and_describe_sift(img: torch.Tensor,
                             max_kp: int = features.DEFAULT_MAX_KP,
                             octaves: int = 3, intervals: int = INTERVALS,
                             contrast: float = 0.015,
                             upsample: bool = True) -> dict:
    """:func:`detect_and_describe_sift_batch` on one (H, W) image (the JAX
    package's per-image default of 3 octaves)."""
    return features.per_image(detect_and_describe_sift_batch, img,
                              max_kp=max_kp, octaves=octaves,
                              intervals=intervals, contrast=contrast,
                              upsample=upsample)
