"""The kernels' plain versions, under the kernels' names.

Frozen from the port's ``ops/cuda_kernels.py`` for the benchmark's
reference: every function computes with elementwise PyTorch, the
library's Cholesky and one float32 matmul, on whatever device its inputs
are on. Nothing is compiled and nothing is launched by hand.
"""

from __future__ import annotations

import torch

from . import akaze, features

BIG = 1e30
KERNELS = ("detect_maps", "mutual_nearest", "orientation_maps",
           "harris_response", "akaze_octave", "cholesky_solve")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)


def resolve_device(device) -> torch.device:
    """The device a stage runs on. The stage entry points default to
    "cuda", where the kernels run; the CPU (plain versions) only when the
    caller names it. Asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; pass "
            f"device='cpu' to run the plain PyTorch versions")
    return device


def detect_maps_plain(imgs: torch.Tensor, k: float = 0.05):
    """Plain version of B1: (resp, nms, maps) from the jnp-path
    semantics (features.harris_response / nms / orientation_cell_maps)."""
    PLAIN_CALLS["detect_maps"] += 1
    resp = features.harris_response(imgs, k)
    return resp, features.nms(resp), features.orientation_cell_maps(imgs)


def harris_response_plain(imgs: torch.Tensor, k: float = 0.05):
    """Plain version of B4: (resp, nms) (features.harris_response +
    features.nms)."""
    PLAIN_CALLS["harris_response"] += 1
    resp = features.harris_response(imgs, k)
    return resp, features.nms(resp)


def orientation_maps_plain(imgs: torch.Tensor):
    """Plain version of B3: features.orientation_cell_maps."""
    PLAIN_CALLS["orientation_maps"] += 1
    return features.orientation_cell_maps(imgs)


def akaze_octave_plain(imgs: torch.Tensor, k: torch.Tensor, steps: int = 6,
                       tau: float = 0.2, sigma: float = 1.6):
    """Plain version of B5: (L, resp, nms) = akaze.diffuse,
    akaze._hessian_response and features.nms."""
    PLAIN_CALLS["akaze_octave"] += 1
    L = akaze.diffuse(imgs, k, steps, tau)
    resp = akaze._hessian_response(L, sigma)
    return L, resp, features.nms(resp)


def window_distances(desc_a, desc_b, xy_a=None, xy_b=None, window=None):
    """(B, Ka, Kb) distances ``2 - 2 a.b`` of bf16-rounded descriptors,
    +BIG for pairs outside the guided window ``(dx_min, dx_max, dy_max)``
    (candidate j is admissible for query i iff x_b[j] - x_a[i] is in
    [dx_min, dx_max] and |y_b[j] - y_a[i]| <= dy_max): the matrix both
    reductions of B2 read, before the validity penalties."""
    from .matching import window_penalty

    a = desc_a.to(torch.bfloat16).float()
    b = desc_b.to(torch.bfloat16).float()
    base = 2.0 - 2.0 * torch.matmul(a, b.transpose(1, 2))
    return base + window_penalty(xy_a, xy_b, window, big=BIG)


def mutual_nearest_plain(desc_a, desc_b, valid_a, valid_b, xy_a=None,
                         xy_b=None, window=None):
    """Plain version of B2. Inputs are rounded to bf16 and multiplied in
    float32 (those products are exact), so it matches the kernel up to the
    order of the summation. Returns (row_dist (B, Ka), row_idx (B, Ka),
    col_dist (B, Kb), col_idx (B, Kb)); ties go to the lowest index."""
    PLAIN_CALLS["mutual_nearest"] += 1
    base = window_distances(desc_a, desc_b, xy_a, xy_b, window)
    pen_a = torch.where(valid_a, 0.0, BIG)
    pen_b = torch.where(valid_b, 0.0, BIG)
    rdist, ridx = torch.min(base + pen_b[:, None, :], dim=2)
    cdist, cidx = torch.min(base + pen_a[:, :, None], dim=1)
    return rdist, ridx, cdist, cidx


def nearest_neighbor(desc_a, desc_b, valid_b):
    """Row-wise nearest neighbours (dist, idx) of A in the valid rows of B
    (the JAX package's ``nearest_neighbor``): kernel B2 with every row of
    A valid, its column reduction dropped. One pair (K, D) or a batch of
    pairs (B, K, D)."""
    single = desc_a.dim() == 2
    if single:
        desc_a, desc_b, valid_b = desc_a[None], desc_b[None], valid_b[None]
    valid_a = torch.ones(desc_a.shape[:2], dtype=torch.bool,
                         device=desc_a.device)
    rdist, ridx, _, _ = mutual_nearest(desc_a, desc_b, valid_a, valid_b)
    return (rdist[0], ridx[0]) if single else (rdist, ridx)


def cholesky_solve_plain(S: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: S x = g by ``torch.linalg.cholesky_ex`` +
    ``cholesky_solve``, with a NaN row wherever the factorization fails."""
    PLAIN_CALLS["cholesky_solve"] += 1
    Lc, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(g[..., None], Lc)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.full_like(x, float("nan")))


detect_maps = detect_maps_plain
harris_response = harris_response_plain
orientation_maps = orientation_maps_plain
akaze_octave = akaze_octave_plain
mutual_nearest = mutual_nearest_plain
cholesky_solve = cholesky_solve_plain
