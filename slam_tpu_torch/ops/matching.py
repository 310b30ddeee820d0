"""Batched descriptor matching: cross-checked nearest neighbours and the
rectified-stereo gate.

Counterpart of ``slam_tpu/ops/matching.py``. Descriptors are unit-norm,
so the squared distance is ``2 - 2 a.b``, with the products in bf16 as in
the JAX package. Every matching runs through kernel B2
(``cuda_kernels.mutual_nearest``), which takes any K; on the CPU its
plain version runs. The dense distance matrix with the window penalty
(the JAX package's ``distance_matrix`` + ``window_penalty``) is
``cuda_kernels.window_distances``, the plain version's core. Matches are SoA: ``target_idx[i]`` is the matched
row of B (or -1), ``dist[i]`` its distance.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

BIG = 1e9

# rectified stereo gate: |dy| < 2 px and x_left > x_right + 2
STEREO_DY = 2.0
STEREO_MIN_DISP = 2.0


def mutual_match(desc_a, desc_b, valid_a, valid_b, max_dist: float = 1e8,
                 xy_a=None, xy_b=None, window=None) -> dict:
    """Cross-checked nearest-neighbour matching A -> B, batched over a
    leading pair dimension: (i, j) is a match iff j is i's nearest valid
    neighbour in B, i is j's nearest valid neighbour in A, and the
    distance is below ``max_dist``; optionally within a guided ``window``.

    Returns target_idx (B, Ka) int64 (-1 unmatched), dist (B, Ka) float32
    (BIG unmatched) and matched (B, Ka) bool.
    """
    rdist, ridx, _, cidx = cuda_kernels.mutual_nearest(
        desc_a, desc_b, valid_a, valid_b, xy_a, xy_b, window)
    ar = torch.arange(desc_a.shape[1], device=ridx.device)
    mutual = torch.gather(cidx, 1, ridx) == ar
    matched = mutual & valid_a & (rdist < max_dist)
    return {
        "target_idx": torch.where(matched, ridx, -1),
        "dist": torch.where(matched, rdist, BIG),
        "matched": matched,
    }


def stereo_gate(xy_left, xy_right, match: dict, dy_thresh: float = STEREO_DY,
                min_disp: float = STEREO_MIN_DISP) -> dict:
    """Rectified-stereo consistency gate on batched L->R matches: keeps
    |y_l - y_r| < dy_thresh and x_l > x_r + min_disp, and adds ``links``
    (B, K, 3) = (x_left, x_right, (y_l + y_r) / 2)."""
    tgt = torch.clamp(match["target_idx"], 0, xy_right.shape[1] - 1)
    xr = torch.gather(xy_right, 1, tgt[..., None].expand(-1, -1, 2))
    xl = xy_left
    ok = (match["matched"]
          & (torch.abs(xl[..., 1] - xr[..., 1]) < dy_thresh)
          & (xl[..., 0] > xr[..., 0] + min_disp))
    y = 0.5 * (xl[..., 1] + xr[..., 1])
    links = torch.stack([xl[..., 0], xr[..., 0], y], dim=-1)
    return {
        "target_idx": torch.where(ok, match["target_idx"], -1),
        "dist": torch.where(ok, match["dist"], BIG),
        "matched": ok,
        "links": links,
    }


def match_stereo_pair_batched(left: dict, right: dict, window=None,
                              max_dist: float = 1e8) -> dict:
    """Stereo association of F frame pairs: mutual NN (disparity-band
    guided when ``window`` is given) then the rectified gate."""
    m = mutual_match(left["desc"], right["desc"], left["valid"],
                     right["valid"], max_dist=max_dist, xy_a=left["xy"],
                     xy_b=right["xy"], window=window)
    return stereo_gate(left["xy"], right["xy"], m)

