"""Kernel B8 (``cuda_kernels.sift_octave``) held to its plain version: the
one comparison that ``tests/test_torch_sift_octave.py``'s card tests and
``chip_smoke.py``'s phase 2f both make.

Tolerances: the Gaussian levels within ``LEVEL_TOL`` (images in [0, 1];
each of up to fourteen 1-D passes sums at most 29 products, perhaps in
another order than cuDNN's and with fused multiply-adds: under 2e-6 a
pass at worst, and averaging does not amplify it), so a DoG within
``DOG_TOL``. Every decision (the 3x3x3 extremum, the contrast gate, the
edge test, the winning interval) is held equal except at pixels where the
plain version's own margin is within what that error can move, and the
response, the interval and the next base within the error propagated to
them. B8's extremum and edge tests read the DoG outside the image as 0
where the plain version reads -inf and wraps (``torch.roll``), so the
response and the interval are compared inside the outer 1-pixel frame;
nothing downstream reads that frame (``select_keypoints`` keeps keypoints
>= 4 pixels inside). The NMS map is held, exactly, to ``features.nms`` of
the kernel's own response.

The module imports no JAX: it runs on the card, where JAX is absent.
"""

import math

import torch
import torch.nn.functional as Fn

from slam_tpu_torch.ops import features, sift

LEVEL_TOL = 2e-5
DOG_TOL = 2 * LEVEL_TOL


def _ring_max(x):
    """3x3 window maximum without the centre, -inf outside the image."""
    H, W = x.shape[-2:]
    p = Fn.pad(x, (1, 1, 1, 1), value=-math.inf)
    out = torch.full_like(x, -math.inf)
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                out = torch.maximum(out, p[..., dy:dy + H, dx:dx + W])
    return out


def near_margin(dogs, contrast, tol=DOG_TOL):
    """(F, H, W) bool: pixels where a decision of the plain version (the
    extremum test against the 26 neighbours, the contrast gate, the edge
    test, the choice among passing intervals) lies within what an error
    of ``tol`` in each DoG can move."""
    near = torch.zeros_like(dogs[0], dtype=torch.bool)
    thr = (sift.EDGE_R + 1.0) ** 2 / sift.EDGE_R
    passing = []
    for i in range(1, len(dogs) - 1):
        d = dogs[i]
        hi = torch.maximum(
            torch.maximum(_ring_max(d), sift._max3(dogs[i - 1])),
            sift._max3(dogs[i + 1]))
        lo = -torch.maximum(torch.maximum(_ring_max(-d),
                                          sift._max3(-dogs[i - 1])),
                            sift._max3(-dogs[i + 1]))
        near |= ((d - hi).abs() <= 2 * tol) | ((d - lo).abs() <= 2 * tol)
        near |= (d.abs() - contrast).abs() <= tol
        dxx = torch.roll(d, -1, -1) - 2.0 * d + torch.roll(d, 1, -1)
        dyy = torch.roll(d, -1, -2) - 2.0 * d + torch.roll(d, 1, -2)
        dxy = 0.25 * (torch.roll(d, (-1, -1), (-2, -1))
                      + torch.roll(d, (1, 1), (-2, -1))
                      - torch.roll(d, (-1, 1), (-2, -1))
                      - torch.roll(d, (1, -1), (-2, -1)))
        tr, det = dxx + dyy, dxx * dyy - dxy * dxy
        e_det = 4 * tol * (dxx.abs() + dyy.abs()) + 2 * tol * dxy.abs() \
            + 20 * tol * tol
        e_tr = 8 * tol
        near |= det.abs() <= e_det
        near |= (tr * tr - thr * det).abs() <= 2 * tr.abs() * e_tr \
            + e_tr * e_tr + thr * e_det
        mask = (sift._extrema_mask(dogs[i - 1], d, dogs[i + 1])
                & (d.abs() > contrast) & sift._edge_ok(d))
        passing.append(torch.where(mask, d.abs(), -math.inf))
    for a in range(len(passing)):
        for b in range(a + 1, len(passing)):
            both = torch.isfinite(passing[a]) & torch.isfinite(passing[b])
            near |= both & ((passing[a] - passing[b]).abs() <= 2 * tol)
    return near


def compare(level, out, contrast, intervals=sift.INTERVALS, last=False):
    """B8's outputs ``out`` = (resp, nms, s, next) on the base ``level``
    against the plain version's (the module docstring's rule). Returns a
    dict: ``problems`` (a message for each check that fails; empty when
    B8 holds), ``pixels`` compared, ``respond`` (the plain version's
    responding pixels among them), ``near_differ`` (pixels that differ at
    the plain version's margin, which the rule allows), ``resp_err`` (the
    largest response error where both respond), ``next_err`` (the next
    base's largest error) and ``next_plain`` (the plain version's next
    base, None when ``last``)."""
    resp, nms, s, nxt = out
    gauss = sift.gaussian_pyramid_octave(level, intervals)
    dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
    r_p, best_p = sift._octave_response(dogs, contrast)
    s_p = sift._interval_map(dogs, best_p)
    problems = [f"non-finite {name}" for name, x in (("resp", resp),
                                                     ("s", s))
                if not bool(torch.isfinite(x).all())]
    if not torch.equal(nms, features.nms(resp)):
        problems.append("nms is not features.nms of the response")
    # the next base: level `intervals` at even rows and columns
    next_plain, next_err = None, 0.0
    if last:
        if nxt is not None:
            problems.append("a next base from the last octave")
    else:
        next_plain = gauss[intervals][..., ::2, ::2].contiguous()
        if nxt.shape != next_plain.shape:
            problems.append(f"next base shape {tuple(nxt.shape)}")
        else:
            next_err = float((nxt - next_plain).abs().max())
            if next_err > LEVEL_TOL:
                problems.append(f"next base err {next_err}")
    del gauss
    # resp and s inside the outer 1-pixel frame, away from the margins
    F, H, W = level.shape
    inner = torch.zeros((H, W), dtype=torch.bool, device=level.device)
    inner[1:-1, 1:-1] = True
    near = near_margin(dogs, contrast)
    pass_k, pass_p = resp > 0, r_p > 0
    d_p, d_c, d_n = dogs[0], dogs[0], dogs[1]
    for i in range(1, len(dogs) - 1):
        at_i = best_p == i
        d_p = torch.where(at_i, dogs[i - 1], d_p)
        d_c = torch.where(at_i, dogs[i], d_c)
        d_n = torch.where(at_i, dogs[i + 1], d_n)
    # the parabola's vertex moves by at most ~3 DoG errors over |denom|
    s_tol = 1e-6 + 3 * DOG_TOL / (d_n - 2.0 * d_c + d_p).abs().clamp(
        min=1e-30)
    del dogs, d_p, d_c, d_n
    r_diff = (resp - r_p).abs()
    differ = ((pass_k != pass_p) | (pass_p & (r_diff > 2 * DOG_TOL))
              | ((s - s_p).abs() > s_tol))
    bad = differ & inner & ~near
    if bool(bad.any()):
        problems.append(f"{int(bad.sum())} pixels differ away from the "
                        f"margins, e.g. {bad.nonzero()[:5].tolist()}")
    both = pass_k & pass_p & inner & ~near
    return {"problems": problems, "pixels": int(inner.sum()) * F,
            "respond": int(pass_p[:, inner].sum()),
            "near_differ": int((differ & inner & near).sum()),
            "resp_err": float(r_diff[both].max()) if bool(both.any())
            else 0.0,
            "next_err": next_err, "next_plain": next_plain}
