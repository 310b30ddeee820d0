"""Harris detection and SIFT-style description, batched over images.

Counterpart of the Harris paths of ``slam_tpu/ops/features.py``, single
octave and pyramid (``detect_and_describe_multiscale_batch``):

  * detection: Harris response (Sobel, Gaussian sigma 1.5 r 2 structure
    tensor, ``det - 0.05 tr^2``), 5x5 non-max suppression, then a gridded
    top-K: the top 3 of every ``cell`` x ``cell`` tile, ranked by per-cell
    rank first and response second, with a parabola subpixel fit;
  * description: 8 soft orientation bins of the gradient of a sigma 1.0
    blur, box-summed over 4x4 px cells (``orientation_cell_maps``), sampled
    at the 16 cell centers around each keypoint and normalized
    L2 -> clip 0.2 -> L2 (128-d).

The per-pixel maps (response, NMS map, orientation maps) come from kernel
B1 (``cuda_kernels.detect_maps``) on the card, at every pyramid level;
the functions below are its plain version and the reference for its edge
semantics: every convolution stage treats its own input as zero outside
the image, as XLA's SAME convolution does, and NMS treats outside as
-inf.

Images are (F, H, W) float32 in [0, 1]. The JAX package's per-image
forms (``detect``, ``detect_and_describe``,
``detect_and_describe_multiscale``), which it vmaps, are thin calls into
the batched forms on a batch of one; ``detect`` takes its response from
kernel B4 (``cuda_kernels.harris_response``). ``build_shifted_cell_maps``
is not ported: it builds the Pallas B1's bf16 stack of x-shifted cell
maps, a layout for the TPU's lanes; B1 here gathers the unshifted maps
(ROADMAP.md, B-redesign 3).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as Fn

DEFAULT_MAX_KP = 2048
PATCH = 16
CELL = PATCH // 4
DESC_DIM = 128


# ---------------------------------------------------------------------------
# small separable convolutions with XLA SAME padding
# ---------------------------------------------------------------------------

def _conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(N, H, W) cross-correlated with a small (kh, kw) kernel, zero
    padded as XLA's SAME does (low = (k - 1) // 2, high = the rest: an
    even kernel reads one more sample after the center than before)."""
    kh, kw = kernel.shape
    pt, pl = (kh - 1) // 2, (kw - 1) // 2
    x = Fn.pad(img[:, None], (pl, kw - 1 - pl, pt, kh - 1 - pt))
    return Fn.conv2d(x, kernel[None, None].to(img))[:, 0]


def gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """Normalized float32 Gaussian taps, computed on the host: kernel B1
    receives these exact values from its wrapper, so the kernel and the
    plain version on any device blur with the same weights."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


@functools.lru_cache(maxsize=None)
def _device_taps(sigma: float, radius: int, device: torch.device):
    """gaussian_kernel1d's taps on ``device``, copied there once: a copy
    from pageable host memory per call makes the host wait for the
    stream."""
    return gaussian_kernel1d(sigma, radius).to(device)


@functools.lru_cache(maxsize=None)
def _sobel_taps(device: torch.device):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
                      ) / 8.0
    return kx.to(device), kx.T.contiguous().to(device)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int = 3):
    k = _device_taps(float(sigma), int(radius), img.device)
    return _conv2d_same(_conv2d_same(img, k[None, :]), k[:, None])


def _sobel(img: torch.Tensor):
    kx, ky = _sobel_taps(img.device)
    return _conv2d_same(img, kx), _conv2d_same(img, ky)


# ---------------------------------------------------------------------------
# Harris detection with gridded top-K
# ---------------------------------------------------------------------------

def harris_response(imgs: torch.Tensor, k: float = 0.05) -> torch.Tensor:
    """Harris corner response (F, H, W)."""
    gx, gy = _sobel(imgs)
    gxx = gaussian_blur(gx * gx, 1.5, 2)
    gyy = gaussian_blur(gy * gy, 1.5, 2)
    gxy = gaussian_blur(gx * gy, 1.5, 2)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def nms(resp: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """-inf at every pixel below the max of its (2r+1)^2 window (the
    window's outside counts as -inf)."""
    m = Fn.max_pool2d(resp[:, None], 2 * radius + 1, stride=1,
                      padding=radius)[:, 0]
    return torch.where(resp >= m, resp, torch.full_like(resp, -math.inf))


def select_keypoints(resp: torch.Tensor, resp_nms: torch.Tensor,
                     max_kp: int, cell: int = 16, border: int = 12,
                     min_response: float = 1e-7) -> dict:
    """Gridded top-K selection with a quadratic subpixel fit, batched over
    (F, H, W) response maps and their NMS maps.

    The ranking key ``-rank + sigmoid(1e4 v) * 0.9`` saturates, so ties
    are common; ``jax.lax.top_k`` keeps the lower index first among
    ties, and a stable descending sort does the same, so the selected
    set and its slot order follow the JAX package.
    """
    Fb, H, W = resp.shape
    dev = resp.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border) & (yy < H - border))
    r = torch.where(in_border & (resp_nms > min_response), resp_nms,
                    torch.full_like(resp_nms, -math.inf))

    Hc = (H + cell - 1) // cell
    Wc = (W + cell - 1) // cell
    rp = Fn.pad(r, (0, Wc * cell - W, 0, Hc * cell - H), value=-math.inf)
    tiles = rp.reshape(Fb, Hc, cell, Wc, cell).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(Fb, Hc * Wc, cell * cell)

    # top-3 per cell by masked argmax passes (first index on ties)
    cand_val, cand_pos = [], []
    t = tiles
    lanes = torch.arange(cell * cell, device=dev)
    for i in range(3):
        v = torch.amax(t, dim=2)
        a = torch.argmax(t, dim=2)
        cand_val.append(v)
        cand_pos.append(a)
        if i < 2:
            t = torch.where(lanes == a[..., None],
                            torch.full_like(t, -math.inf), t)
    n_cells = Hc * Wc
    vals = torch.cat(cand_val, dim=1)                  # (F, 3 n_cells)
    pos = torch.cat(cand_pos, dim=1)
    cell_id = torch.arange(n_cells, device=dev).repeat(3)
    rank = torch.arange(3, device=dev).repeat_interleave(n_cells).float()
    score = torch.where(torch.isfinite(vals),
                        -rank + torch.sigmoid(vals * 1e4) * 0.9,
                        torch.full_like(vals, -math.inf))
    k = min(max_kp, score.shape[1])
    top_s, top_i = torch.sort(score, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    if k < max_kp:  # tiny images: pad slots
        pad = max_kp - k
        top_s = Fn.pad(top_s, (0, pad), value=-math.inf)
        top_i = Fn.pad(top_i, (0, pad), value=0)

    sel_cell = cell_id[top_i]
    sel_pos = torch.gather(pos, 1, top_i)
    ys = (sel_cell // Wc) * cell + sel_pos // cell
    xs = (sel_cell % Wc) * cell + sel_pos % cell
    valid = torch.isfinite(top_s)

    # quadratic subpixel refinement on the raw response
    xc = torch.clamp(xs, 1, W - 2)
    yc = torch.clamp(ys, 1, H - 2)
    flat = resp.reshape(Fb, H * W)

    def at(y, x):
        return torch.gather(flat, 1, y * W + x)

    r0 = at(yc, xc)

    def para(p, m, c):
        denom = p - 2.0 * c + m
        ok = torch.abs(denom) > 1e-12
        off = torch.where(ok, -0.5 * (p - m) / torch.where(
            ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dx = para(at(yc, xc + 1), at(yc, xc - 1), r0)
    dy = para(at(yc + 1, xc), at(yc - 1, xc), r0)
    xs_f = torch.clamp(xc.float() + dx, border, W - 1 - border)
    ys_f = torch.clamp(yc.float() + dy, border, H - 1 - border)
    sel_val = torch.gather(vals, 1, top_i)
    return {
        "xy": torch.stack([xs_f, ys_f], dim=-1),
        "resp": torch.where(valid, sel_val, torch.zeros_like(sel_val)),
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# SIFT-style descriptor (upright, single scale)
# ---------------------------------------------------------------------------

def orientation_cell_maps(imgs: torch.Tensor) -> torch.Tensor:
    """(F, H, W) -> (F, 8, H, W): channel o at pixel p holds the 4x4 box
    sum (SAME padding (1, 2)) of the gradient magnitude softly binned into
    orientation o, around p."""
    blur = gaussian_blur(imgs, 1.0, 2)
    gx, gy = _sobel(blur)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)
    bin_f = (ang + math.pi) / (2.0 * math.pi) * 8.0
    fl = torch.floor(bin_f)
    b0 = fl.to(torch.int64) % 8
    w1 = bin_f - fl
    w0 = 1.0 - w1
    o = torch.arange(8, device=imgs.device)[None, :, None, None]
    maps = (torch.where(b0[:, None] == o, (mag * w0)[:, None], 0.0)
            + torch.where((b0[:, None] + 1) % 8 == o, (mag * w1)[:, None],
                          0.0))
    Fb, _, H, W = maps.shape
    flat = maps.reshape(Fb * 8, H, W)
    ones_v = torch.ones((CELL, 1), device=imgs.device)
    ones_h = torch.ones((1, CELL), device=imgs.device)
    flat = _conv2d_same(_conv2d_same(flat, ones_v), ones_h)
    return flat.reshape(Fb, 8, H, W)


def describe(xy: torch.Tensor, valid: torch.Tensor,
             maps: torch.Tensor) -> torch.Tensor:
    """(F, K, 128) descriptors from (F, 8, H, W) orientation-cell maps:
    the 16 cell centers at offsets (-6, -2, 2, 6) px around each keypoint,
    each clipped into the image, then L2 -> clip 0.2 -> L2."""
    Fb, K, _ = xy.shape
    _, C, H, W = maps.shape
    offs = (torch.arange(4, dtype=torch.float32, device=xy.device)
            - 1.5) * CELL
    oy = offs[:, None].expand(4, 4).reshape(-1)
    ox = offs[None, :].expand(4, 4).reshape(-1)
    px = torch.clamp(torch.round(xy[..., 0:1] + ox).long(), 0, W - 1)
    py = torch.clamp(torch.round(xy[..., 1:2] + oy).long(), 0, H - 1)
    idx = (py * W + px).reshape(Fb, 1, K * 16).expand(Fb, C, K * 16)
    cells = torch.gather(maps.reshape(Fb, C, H * W), 2, idx)  # (F, 8, K*16)
    desc = cells.reshape(Fb, C, K, 16).permute(0, 2, 3, 1).reshape(
        Fb, K, DESC_DIM)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
                   + 1e-8)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
                   + 1e-8)
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def detect(img: torch.Tensor, max_kp: int = DEFAULT_MAX_KP, cell: int = 16,
           border: int = 12, min_response: float = 1e-7,
           resp: torch.Tensor | None = None,
           resp_nms: torch.Tensor | None = None) -> dict:
    """Gridded Harris detection on one (H, W) image: xy (max_kp, 2), resp
    (max_kp,), valid (max_kp,). Without ``resp`` the response and its NMS
    map come from kernel B4 on a batch of one (on the CPU its plain
    version, ``harris_response`` + ``nms``); a ``resp`` given without its
    NMS map gets ``nms(resp)``."""
    from .cuda_kernels import harris_response as b4

    if resp is None:
        resp, resp_nms = b4(img[None].contiguous())
    else:
        resp = resp[None]
        resp_nms = nms(resp) if resp_nms is None else resp_nms[None]
    det = select_keypoints(resp, resp_nms, max_kp, cell, border,
                           min_response)
    return {k: v[0] for k, v in det.items()}


def detect_and_describe(img: torch.Tensor,
                        max_kp: int = DEFAULT_MAX_KP) -> dict:
    """:func:`detect_and_describe_batch` on one (H, W) image."""
    return per_image(detect_and_describe_batch, img, max_kp=max_kp)


def per_image(batched, img: torch.Tensor, **kw) -> dict:
    """A batched detector on one (H, W) image, as a batch of one: every
    output without its leading axis."""
    return {k: v[0] for k, v in batched(img[None].contiguous(),
                                        **kw).items()}


def detect_and_describe_batch(imgs: torch.Tensor,
                              max_kp: int = DEFAULT_MAX_KP) -> dict:
    """Single-octave detect + describe over (F, H, W) images: kernel B1
    for the per-pixel maps, then selection and description.
    Returns xy (F, K, 2), desc (F, K, 128), valid (F, K), resp (F, K)."""
    from .cuda_kernels import detect_maps

    resp, resp_nms, maps = detect_maps(imgs)
    det = select_keypoints(resp, resp_nms, max_kp)
    desc = describe(det["xy"], det["valid"], maps)
    return {"xy": det["xy"], "desc": desc, "valid": det["valid"],
            "resp": det["resp"]}


# ---------------------------------------------------------------------------
# pyramids (multiscale Harris here, AKAZE's octaves in ops/akaze.py)
# ---------------------------------------------------------------------------

def downsample2(imgs: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample of (F, H, W) images (one octave)."""
    return gaussian_blur(imgs, 1.0, 2)[..., ::2, ::2].contiguous()


def level_budgets(max_kp: int, num_levels: int) -> list[int]:
    """Per-level keypoint budgets: full resolution keeps half at every
    split, in multiples of 128 (the JAX package's _multiscale_budgets and
    akaze._octave_budgets, which are the same function)."""
    budgets = []
    remaining = max_kp
    for lvl in range(num_levels):
        k = remaining // 2 if lvl < num_levels - 1 else remaining
        k = max(128, (k // 128) * 128)
        k = min(k, remaining)
        budgets.append(k)
        remaining -= k
    budgets[0] += remaining
    return budgets


def level_border(lvl: int) -> int:
    """Detection border of pyramid level ``lvl`` (the jnp paths' rule: the
    port's kernels have no edge band to keep descriptor samples out of)."""
    return max(4, 12 >> lvl)


def stack_levels(levels: list[tuple[dict, torch.Tensor]]) -> dict:
    """Per-level (detections, descriptors), level 0 first -> one
    (F, sum of budgets) set of slots: xy mapped back to level-0 pixels,
    plus ``scale`` = 2^level."""
    out = {key: [] for key in ("xy", "desc", "valid", "resp", "scale")}
    for lvl, (det, desc) in enumerate(levels):
        factor = float(1 << lvl)
        out["xy"].append(det["xy"] * factor)
        out["desc"].append(desc)
        out["valid"].append(det["valid"])
        out["resp"].append(det["resp"])
        out["scale"].append(torch.full(det["valid"].shape, factor,
                                       device=desc.device))
    return {key: torch.cat(parts, dim=1) for key, parts in out.items()}


def detect_and_describe_multiscale_batch(imgs: torch.Tensor,
                                         max_kp: int = DEFAULT_MAX_KP,
                                         num_levels: int = 2) -> dict:
    """Pyramid Harris over (F, H, W) images: kernel B1 at every level on
    the whole batch, each level's budget of keypoints described at its own
    level, coordinates mapped back to level-0 pixels. Returns the
    single-octave dict plus ``scale`` (F, K)."""
    from .cuda_kernels import detect_maps

    levels = []
    level = imgs
    for lvl, k in enumerate(level_budgets(max_kp, num_levels)):
        resp, resp_nms, maps = detect_maps(level)
        det = select_keypoints(resp, resp_nms, k, border=level_border(lvl))
        levels.append((det, describe(det["xy"], det["valid"], maps)))
        if lvl + 1 < num_levels:
            level = downsample2(level)
    return stack_levels(levels)


def detect_and_describe_multiscale(img: torch.Tensor,
                                   max_kp: int = DEFAULT_MAX_KP,
                                   num_levels: int = 2) -> dict:
    """:func:`detect_and_describe_multiscale_batch` on one (H, W) image."""
    return per_image(detect_and_describe_multiscale_batch, img,
                     max_kp=max_kp, num_levels=num_levels)
