"""AKAZE-style nonlinear scale-space detection, batched over images.

Counterpart of ``slam_tpu/ops/akaze.py`` (the jnp path): per octave,
explicit Perona-Malik (g2) diffusion steps with a per-image contrast
``k``, the scale-normalized determinant of the Hessian, 5x5 NMS, the
gridded top-K of ``features.select_keypoints`` and the SIFT-style
descriptor on the octave's diffused image; a 2x downsample between
octaves. Differences, like the JAX package's, wrap at the image edge
(``torch.roll`` for ``jnp.roll``).

On the card each octave is one launch of kernel B5
(``cuda_kernels.akaze_octave``: diffusion, response and NMS) and one of
B3 (``cuda_kernels.orientation_maps``: the descriptor maps of the
diffused image), on the whole batch; the functions below are B5's plain
version. The contrast ``k`` stays on the device.

Images are (F, H, W) float32 in [0, 1].
"""

from __future__ import annotations

import torch

from . import features


def _gradients_centered(L: torch.Tensor):
    gx = 0.5 * (torch.roll(L, -1, dims=-1) - torch.roll(L, 1, dims=-1))
    gy = 0.5 * (torch.roll(L, -1, dims=-2) - torch.roll(L, 1, dims=-2))
    return gx, gy


def _pm_g2(gx, gy, k):
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def diffuse(L: torch.Tensor, k: torch.Tensor, steps: int,
            tau: float = 0.2) -> torch.Tensor:
    """``steps`` explicit PM-g2 diffusion steps of (F, H, W) images with
    their (F,) contrasts (stable for tau <= 0.25)."""
    k = k[:, None, None]
    for _ in range(steps):
        gx, gy = _gradients_centered(L)
        g = _pm_g2(gx, gy, k)
        fx = g * gx
        fy = g * gy
        div = ((fx - torch.roll(fx, 1, dims=-1))
               + (fy - torch.roll(fy, 1, dims=-2)))
        L = L + tau * div
    return L


def _hessian_response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized det(Hessian) of (F, H, W) images."""
    xp, xm = torch.roll(L, -1, dims=-1), torch.roll(L, 1, dims=-1)
    yp, ym = torch.roll(L, -1, dims=-2), torch.roll(L, 1, dims=-2)
    Lxx = xp - 2 * L + xm
    Lyy = yp - 2 * L + ym
    Lxy = 0.25 * (torch.roll(yp, -1, dims=-1) - torch.roll(yp, 1, dims=-1)
                  - torch.roll(ym, -1, dims=-1) + torch.roll(ym, 1, dims=-1))
    return (sigma ** 4) * (Lxx * Lyy - Lxy * Lxy)


def _contrast_k(imgs: torch.Tensor) -> torch.Tensor:
    """(F,) PM contrasts: 3x the 70th percentile (linear interpolation, as
    jnp.percentile) of each image's smoothed gradient magnitude, at least
    1e-4. Computed on the images' device, with no host sync."""
    gx, gy = _gradients_centered(features.gaussian_blur(imgs, 1.0, 2))
    mag = torch.sqrt(gx * gx + gy * gy).reshape(imgs.shape[0], -1)
    return torch.clamp(3.0 * torch.quantile(mag, 0.7, dim=1), min=1e-4)


def detect_and_describe_akaze_batch(imgs: torch.Tensor,
                                    max_kp: int = features.DEFAULT_MAX_KP,
                                    octaves: int = 2, steps: int = 6,
                                    threshold: float = 8e-4) -> dict:
    """Nonlinear scale-space detect + describe over (F, H, W) images:
    kernels B5 and B3 once per octave on the whole batch. Returns xy
    (level-0 pixels), desc, valid, resp and ``scale`` (2^octave), each
    (F, max_kp, ...), octave 0's slots first."""
    from .cuda_kernels import akaze_octave, orientation_maps

    k = _contrast_k(imgs)
    L = features.gaussian_blur(imgs, 1.0, 2)
    levels = []
    for o, budget in enumerate(features.level_budgets(max_kp, octaves)):
        sigma = 1.6 * (2.0 ** o)
        L, resp, resp_nms = akaze_octave(L, k, steps, sigma=sigma)
        det = features.select_keypoints(
            resp, resp_nms, budget, border=features.level_border(o),
            min_response=threshold * (sigma ** 4) * 1e-3)
        levels.append((det, features.describe(det["xy"], det["valid"],
                                              orientation_maps(L))))
        if o + 1 < octaves:
            L = features.downsample2(L)
    return features.stack_levels(levels)


def detect_and_describe_akaze(img: torch.Tensor,
                              max_kp: int = features.DEFAULT_MAX_KP,
                              octaves: int = 2, steps: int = 6,
                              threshold: float = 8e-4) -> dict:
    """:func:`detect_and_describe_akaze_batch` on one (H, W) image."""
    return features.per_image(detect_and_describe_akaze_batch, img,
                              max_kp=max_kp, octaves=octaves, steps=steps,
                              threshold=threshold)
