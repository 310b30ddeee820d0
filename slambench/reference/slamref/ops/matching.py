"""Batched descriptor matching: cross-checked nearest neighbours and the
rectified-stereo gate.

Counterpart of ``slam_tpu/ops/matching.py``. Descriptors are unit-norm,
so the squared distance is ``2 - 2 a.b``, with the products in bf16 as in
the JAX package. Every matching runs through kernel B2
(``cuda_kernels.mutual_nearest``), which takes any K; on the CPU its
plain version runs. The dense distance matrix with the window penalty
is ``cuda_kernels.window_distances``, the plain version's core; the JAX
package's two halves of it are :func:`distance_matrix` and
:func:`window_penalty`, and :func:`ratio_match` (Lowe's ratio test)
reads the first. Those three take one pair of descriptor sets (K, D) or
a batch of pairs (B, K, D). ``mutual_match`` is batched over pairs, and
``mutual_match_batched`` is it under the JAX package's name and argument
order; ``match_stereo_pair`` takes one frame pair. Matches are SoA:
``target_idx[i]`` is the matched row of B (or -1), ``dist[i]`` its
distance.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

BIG = 1e9

# rectified stereo gate: |dy| < 2 px and x_left > x_right + 2
STEREO_DY = 2.0
STEREO_MIN_DISP = 2.0


def window_penalty(xy_a, xy_b, window, big: float = BIG):
    """(..., Ka, Kb) additive penalty of a guided search window
    ``(dx_min, dx_max, dy_max)``: ``big`` where candidate j is not
    admissible for query i (x_b[j] - x_a[i] outside [dx_min, dx_max], or
    |y_b[j] - y_a[i]| > dy_max), else 0; 0.0 with no window."""
    if window is None:
        return 0.0
    dx_min, dx_max, dy_max = (float(v) for v in window)
    dx = xy_b[..., None, :, 0] - xy_a[..., :, None, 0]
    dy = torch.abs(xy_b[..., None, :, 1] - xy_a[..., :, None, 1])
    bad = (dx < dx_min) | (dx > dx_max) | (dy > dy_max)
    return torch.where(bad, big, 0.0)


def distance_matrix(desc_a, desc_b, valid_a, valid_b) -> torch.Tensor:
    """(..., Ka, Kb) squared-L2 distances ``2 - 2 a.b`` of unit-norm
    descriptors, BIG where either side is invalid: the descriptors
    rounded to bf16 and multiplied in float32 (exact products; the JAX
    package's bf16 matmul with float32 accumulation sums in another
    order), as B2 and its plain version compute them."""
    single = desc_a.dim() == 2
    if single:
        desc_a, desc_b = desc_a[None], desc_b[None]
    d = cuda_kernels.window_distances(desc_a, desc_b)
    d = d[0] if single else d
    return torch.where(valid_a[..., :, None] & valid_b[..., None, :], d, BIG)


def ratio_match(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.8,
                max_dist: float = 1e8) -> dict:
    """Lowe's ratio test on :func:`distance_matrix`: row i matches its
    nearest column when best < ratio^2 * second best (squared distances)
    and best < ``max_dist``. The two smallest distances are ``torch.topk``
    over -d; the match is the lowest index among columns tied at the
    best, as ``jax.lax.top_k`` orders them."""
    d = distance_matrix(desc_a, desc_b, valid_a, valid_b)
    top2 = -torch.topk(-d, 2, dim=-1).values
    best, second = top2[..., 0], top2[..., 1]
    passed = (best < ratio * ratio * second) & valid_a & (best < max_dist)
    return {"target_idx": torch.where(passed, torch.argmin(d, dim=-1), -1),
            "dist": torch.where(passed, best, BIG), "matched": passed}


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


def match_stereo_pair(left: dict, right: dict, window=None,
                      max_dist: float = 1e8) -> dict:
    """:func:`match_stereo_pair_batched` on one frame pair (feature dicts
    of one image each)."""
    out = match_stereo_pair_batched({k: v[None] for k, v in left.items()},
                                    {k: v[None] for k, v in right.items()},
                                    window, max_dist)
    return {k: v[0] for k, v in out.items()}


def mutual_match_batched(desc_a, desc_b, valid_a, valid_b, xy_a=None,
                         xy_b=None, window=None,
                         max_dist: float = 1e8) -> dict:
    """:func:`mutual_match` (already batched over pairs) under the JAX
    package's argument order."""
    return mutual_match(desc_a, desc_b, valid_a, valid_b, max_dist=max_dist,
                        xy_a=xy_a, xy_b=xy_b, window=window)
