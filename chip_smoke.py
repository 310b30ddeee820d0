"""Kernel bench of slam_tpu_torch on one CUDA card: each hand-written
kernel (B1-B9) against its plain version at the shapes the paths use,
with stated tolerances, then its time, the plain version's and the least
time the card could take.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device: a CUDA card is required; prints the card's name and power
     limit, builds the kernels from csrc/ with nvcc and times the build;
  2. kernel B1 (detect_maps) against its plain version on the card, at
     the frontend's shape (64 rendered images of 376x1241), on 4 of them,
     at an odd size and at sizes around its blocks' edges (widths one less,
     equal and one more than one and two blocks of 246 columns, heights
     around one and two chunks of 32 rows, an image narrower than a
     warp), with stated tolerances, then the median time of 20 runs of
     each at the frontend's shape and the wrapper's host microseconds per
     call at (1, 40, 60);
  2b. kernels B4 (harris_response) and B3 (orientation_maps), B1's phases
     alone, against their plain versions with B1's tolerances: B4 at the
     frontend's shape, B3 at both AKAZE octave shapes, (64, 376, 1241) and
     (64, 188, 621), at (2, 100, 333), and at SIFT's first and last
     octave bases of the frontend chunk, (64, 752, 2482) (the x2-upsampled
     '-1' octave) and (64, 94, 311); median times, and the bound at SIFT's
     shapes;
  2c. kernel B5 (akaze_octave) against its plain version at both octave
     shapes, on the AKAZE path's own inputs (blurred rendered frames,
     their per-frame contrast k), and at (2, 47, 156), KITTI's octave 3,
     where the halo is a large share of the image and the wrap matters;
     at sizes around its 72 x 64 tile's edges (one less, equal and one
     more than one and two tiles), narrower than a tile and smaller than
     the halo; at 4 steps on the full octave shape (6 steps take the
     kernel's compile-time path, every other count its run-time path: the
     log names the path); median times, and the wrapper's host
     microseconds per call at (1, 40, 60);
  2f. kernel B8 (sift_octave) against its plain version at SIFT's five
     octaves of the frontend chunk at sift.loop80's settings (contrast
     0.04 / 3): the 64 rendered frames doubled and pre-blurred,
     (64, 752, 2482), then each octave's next base, down to (64, 47,
     156), by the card tests' rule (tests/sift_octave_check.py): the
     next base within 2e-5, the NMS map equal to features.nms of the
     kernel's own response, and no decision, response or interval value
     different inside the outer 1-pixel frame away from the plain
     version's decision margin; median times of the kernel and the plain
     version, and the bound (roofline_pct.b8_sift_octave's bytes and
     operations);
  2d. kernel B6 (cholesky_solve) against its plain version on the card:
     the real reduced pose systems of the scene's windows (frontend on the
     card, keyframes, build_windows + init_landmarks, the first depth
     prune, one Schur setup at LM's lam0: (windows, 144, 144) with the
     gauge rows), random SPD systems with gauge rows at (64, 144, 144)
     (BA's device_batch), (1, 12, 12) (the loop-closure mini-bundle), and
     a batch of 8 in which one system is not positive definite. Tolerance:
     with the float64 solution of the same systems on the card as the
     reference, the kernel's error relative to max |x| (per system, the
     largest over the batch) is at most 4x the plain version's + 1e-6,
     and the failed system's row is all NaN in both; median times of the
     kernel, the plain version (cholesky_ex + cholesky_solve, cuSOLVER)
     and torch.linalg.solve_ex at (64, 144, 144), the scene's batch and
     (1, 12, 12), and the wrapper's host microseconds per call at
     (1, 12, 12) (mean of 1000 calls, no synchronisation between);
  2e. kernel B7 (schur_reduce, and its landmark steps schur_back) against
     its plain version (ops.ba's _linearize and dense blocks) on the card,
     both against the float64 plain version: on the scene's windows at
     LM's first iteration, on seeded windows at (64, 24, 512, 4096) and
     (16, 24, 512, 4096), and at the pair refinement's (1, 2, 512, 1024);
     LM's damped system and the covariances' (S, ghat, Hll_inv, g_l, and
     the landmark steps of one pose step). Tolerance: the kernel's error
     per window relative to its largest entry at most 4x the plain
     version's + 1e-6 (S, Hll_inv), + 1e-3 (what the residuals build:
     ghat, g_l, the landmark steps); S exactly symmetric with the gauge
     rows identity; a second launch equal bit for bit. Median times of
     the kernel and the plain version (the reduction, and the reduction
     with the landmark steps), the bound, and the wrapper's host
     microseconds per call at the pair's shape;
  2g. kernel B9 (pg_system, and its step pg_step) against its plain
     version on the card at the dense pose graph's node buckets: a
     17-keyframe loop at 64 nodes, a 68-keyframe one at 128 and KITTI
     00's 652 keyframes at 704, by the card tests' rule
     (tests/pg_system_check.py): A and rhs within 1e-4 of their largest
     entry and the cost within 1e-5 relative of the plain version's on
     float64 copies, A exactly symmetric, the step's decision and damping
     equal; median times of the system, the step and their plain
     versions, of the LU solve between them, and the bound (the record's
     max_abs_err is A's and rhs's error over their largest entry, A's
     ~1 after the Jacobi scaling);
  3. kernel B2 (mutual_nearest) against its plain version on the card at
     every call the main path makes: (32, 2048, 128) with the stereo and
     the temporal window of SlamConfig().matching, and loop verification's
     (SPEC_Q * max_candidates = 60, 2048, 128) float16 batch without a
     window; also without a window at (32, 2048, 128) and a ragged
     (3, 1500, 128) x (3, 1777, 128); then median times;
  3b. kernel B2 on the Hamming calls: +-1 signs of binarized descriptors
     under the stereo and the temporal window; every index equal to the
     lowest-index argmin, ties included; median times;
  4. the paths: run_pipeline on the 80-frame loop scene under each
     detector's configuration (Harris, multiscale Harris, AKAZE +
     Hamming, SIFT, ORB + Hamming: tests/card_checks.py's DETECTORS),
     from CUDA graphs, through card_checks.run_path: the launch counters
     zeroed just before the counted pass, every kernel the path needs
     launched, no plain version run, >= 1 closure and every ATE under
     1 m. No times.
The second line from the end is the kernels' JSON record: per kernel
its max abs error against its plain version, its time, the plain
version's, the least time the card could take (bytes over 3.35 TB/s or
operations over the peak rate of their type, the larger), one PyTorch
call computing the same function where there is one, and its launches
in phase 4's counted pass of each path that runs it; B4's launches in
phase 2b (it has no caller on the batched paths), B3's times at SIFT's
octave shapes, B8's at each octave, B9's at each bucket. The last line
is the device record.
Nothing here imports JAX or any module of the JAX package.

The card tests (``-m cuda``, the card-test files the README lists) hold
the paths to the rest of what they must do; their speed is the
benchmark's, ``slambench/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# the card tests' helpers (tests/card_checks.py, tests/sift_octave_check.py)
if str(REPO / "tests") not in sys.path:
    sys.path.insert(0, str(REPO / "tests"))

import card_checks  # noqa: E402
from card_checks import HW, SEED  # noqa: E402

TIMING_RUNS = 20
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
# arithmetic per pixel of the image kernels' plain versions, counted
# roughly (each stays 10x or more below its bytes bound): B4 gradients,
# products, three 5-tap separable blurs, response, 5x5 NMS; B3 gradients,
# magnitude, atan2, 8-bin soft assignment, eight 5-tap separable blurs;
# B1 both; B5 six PM-g2 steps of ~20, the Hessian and the NMS
OPS_PER_PIXEL = {"harris_response": 100, "orientation_maps": 200,
                 "detect_maps": 300, "akaze_octave": 155}
# B8: the five blurs' 134 multiply-adds a pixel (radii 4, 5, 6, 7, 9, both
# passes) and the 5 DoG subtractions, what any implementation must do
OPS_PER_PIXEL["sift_octave"] = 273
# B9's float64 arithmetic per edge, counted roughly: the edge's transform
# and log (~150), Jr^-1 (~650), Ad and J = S Jr^-1 Ad (~650), P = J^T J
# and q (~300); the H100 SXM's float64 rate outside the tensor cores
B9_OPS_PER_EDGE = 1750
PEAK_OPS_PER_S["f64"] = 34e12


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median of ``runs`` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


HOST_CALLS = 1000


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Mean host microseconds of ``calls`` calls of fn() with no
    synchronisation between them (after one warm-up): what a caller's
    thread spends to enqueue the work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float, kind: str = "f32"):
    """The least time in ms the card could take: bytes over the memory
    rate or operations over the peak rate of their type, the larger;
    and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_mismatches(n_k, n_p, r_p, r_scale, label: str) -> int:
    """Pixels where the kernel's and the plain version's NMS keep/suppress
    decisions differ; fails unless each is a near-tie (the response within
    1e-6 of max |resp| of its 5x5 window's runner-up, the center itself
    excluded), and unless the kept values agree within 1e-5 of it."""
    keep_k, keep_p = torch.isfinite(n_k), torch.isfinite(n_p)
    mism = keep_k != keep_p
    if mism.any():
        pad = torch.nn.functional.pad(r_p[:, None], (2, 2, 2, 2),
                                      value=-float("inf"))
        win = pad.unfold(2, 5, 1).unfold(3, 5, 1).reshape(*r_p.shape, 25)
        win = win.clone()
        win[..., 12] = -float("inf")
        runner = win.max(dim=-1).values
        tie = (r_p - runner).abs() <= 1e-6 * r_scale
        if (mism & ~tie).any():
            fail(f"{label}: {int((mism & ~tie).sum())} NMS decisions "
                 f"differ away from ties")
    both = keep_k & keep_p
    if float((n_k[both] - n_p[both]).abs().max()) > 1e-5 * r_scale:
        fail(f"{label}: nms values differ")
    return int(mism.sum())


def check_b1(ck, frames: torch.Tensor, label: str) -> float:
    """Kernel B1 vs its plain version on ``frames``; returns max abs err.

    Tolerances: resp and maps within 1e-5 of max |value| (summation order
    and FMA contraction differ); at most 0.1% of map values outside that
    (pixels on an 8-bin boundary, where atan2f and torch.atan2 may round
    to different bins); the NMS -inf pattern equal except where the
    response ties its window's runner-up within 1e-6 of max |resp|."""
    r_k, n_k, m_k = ck.detect_maps(frames)
    r_p, n_p, m_p = ck.detect_maps_plain(frames)
    sync(frames)
    for name, t in (("resp", r_k), ("maps", m_k)):
        if not torch.isfinite(t).all():
            fail(f"B1 {label}: non-finite {name}")
    r_scale = float(r_p.abs().max())
    m_scale = float(m_p.abs().max())
    r_err = float((r_k - r_p).abs().max())
    m_diff = (m_k - m_p).abs()
    m_bad = float((m_diff > 1e-5 * m_scale).float().mean())
    if r_err > 1e-5 * r_scale:
        fail(f"B1 {label}: resp err {r_err} > 1e-5 * {r_scale}")
    if m_bad > 1e-3:
        fail(f"B1 {label}: {m_bad:.2e} of maps beyond 1e-5 * {m_scale}")
    n_mism = nms_mismatches(n_k, n_p, r_p, r_scale, f"B1 {label}")
    log(f"[B1] {label} {tuple(frames.shape)}: resp err {r_err:.3e} "
        f"(scale {r_scale:.3e}), maps max err {float(m_diff.max()):.3e} "
        f"(scale {m_scale:.3e}, share beyond tol {m_bad:.2e}), "
        f"nms mismatches {n_mism}")
    return max(r_err, float(m_diff.max()))


def check_b4(ck, frames: torch.Tensor, label: str) -> float:
    """Kernel B4 (B1's Harris phase) vs its plain version, with B1's
    tolerances: resp within 1e-5 of max |resp|, the NMS -inf pattern equal
    except at near-ties. Returns max abs err."""
    r_k, n_k = ck.harris_response(frames)
    r_p, n_p = ck.harris_response_plain(frames)
    sync(frames)
    if not torch.isfinite(r_k).all():
        fail(f"B4 {label}: non-finite resp")
    r_scale = float(r_p.abs().max())
    r_err = float((r_k - r_p).abs().max())
    if r_err > 1e-5 * r_scale:
        fail(f"B4 {label}: resp err {r_err} > 1e-5 * {r_scale}")
    n_mism = nms_mismatches(n_k, n_p, r_p, r_scale, f"B4 {label}")
    log(f"[B4] {label} {tuple(frames.shape)}: resp err {r_err:.3e} "
        f"(scale {r_scale:.3e}), nms mismatches {n_mism}")
    return r_err


def check_b3(ck, frames: torch.Tensor, label: str) -> float:
    """Kernel B3 (B1's orientation phase) vs its plain version, with B1's
    tolerances: maps within 1e-5 of max |maps| for all but 0.1% of values
    (8-bin boundary flips). Returns max abs err."""
    m_k = ck.orientation_maps(frames)
    m_p = ck.orientation_maps_plain(frames)
    sync(frames)
    if not torch.isfinite(m_k).all():
        fail(f"B3 {label}: non-finite maps")
    m_scale = float(m_p.abs().max())
    m_diff = (m_k - m_p).abs()
    m_bad = float((m_diff > 1e-5 * m_scale).float().mean())
    if m_bad > 1e-3:
        fail(f"B3 {label}: {m_bad:.2e} of maps beyond 1e-5 * {m_scale}")
    log(f"[B3] {label} {tuple(frames.shape)}: maps max err "
        f"{float(m_diff.max()):.3e} (scale {m_scale:.3e}, share beyond tol "
        f"{m_bad:.2e})")
    return float(m_diff.max())


def check_b5(ck, imgs: torch.Tensor, k: torch.Tensor, sigma: float,
             label: str, steps: int = 6):
    """Kernel B5 vs its plain version on the same images and contrasts.

    Tolerances: L within 1e-5 of max |L| (six diffusion steps, each
    rounding in another order, with FMA contraction); resp within 1e-4 of
    max |resp| (second differences of L cancel up to ~10x of L's error);
    the NMS -inf pattern equal except at near-ties. Returns (max abs err,
    the plain version's L, for the next octave)."""
    L_k, r_k, n_k = ck.akaze_octave(imgs, k, steps, sigma=sigma)
    L_p, r_p, n_p = ck.akaze_octave_plain(imgs, k, steps, sigma=sigma)
    sync(imgs)
    for name, t_ in (("L", L_k), ("resp", r_k)):
        if not torch.isfinite(t_).all():
            fail(f"B5 {label}: non-finite {name}")
    L_scale, r_scale = float(L_p.abs().max()), float(r_p.abs().max())
    L_err = float((L_k - L_p).abs().max())
    r_err = float((r_k - r_p).abs().max())
    if L_err > 1e-5 * L_scale:
        fail(f"B5 {label}: L err {L_err} > 1e-5 * {L_scale}")
    if r_err > 1e-4 * r_scale:
        fail(f"B5 {label}: resp err {r_err} > 1e-4 * {r_scale}")
    n_mism = nms_mismatches(n_k, n_p, r_p, r_scale, f"B5 {label}")
    path = ("compile-time" if ck.build().slam_akaze_static_path(steps)
            else "run-time")
    log(f"[B5] {label} {tuple(imgs.shape)}, {steps} steps ({path} path): L "
        f"err {L_err:.3e} (scale {L_scale:.3e}), resp err {r_err:.3e} (scale "
        f"{r_scale:.3e}), nms mismatches {n_mism}")
    return max(L_err, r_err), L_p


def b8_bound(B: int, H: int, W: int, last: bool):
    """The least time in ms of one B8 launch on (B, H, W) images, and
    which bound it is: the base read, resp, nms and the interval map
    written and, unless ``last``, the next base (ceil(H/2), ceil(W/2));
    the blurs' multiply-adds and the DoG subtractions
    (roofline_pct.b8_sift_octave's count)."""
    px = B * H * W
    n_bytes = 4 * px * 4 + (0 if last else 4 * B * ((H + 1) // 2)
                            * ((W + 1) // 2))
    return bound(n_bytes, OPS_PER_PIXEL["sift_octave"] * px)


def check_b8(ck, level: torch.Tensor, contrast: float, last: bool,
             label: str):
    """Kernel B8 vs its plain version on one octave's base, by
    tests/sift_octave_check.py's rule, which the card tests hold it to
    too: the next base within 2e-5, the NMS map equal to features.nms of
    the kernel's own response, and no decision, response or interval
    value different at a pixel inside the outer 1-pixel frame away from
    the plain version's decision margin. Returns (max abs resp err where
    both respond, the plain version's next base)."""
    from sift_octave_check import compare

    got = compare(level, ck.sift_octave(level, contrast, last=last),
                  contrast, last=last)
    if got["problems"]:
        fail(f"B8 {label}: {'; '.join(got['problems'])}")
    log(f"[B8] {label} {tuple(level.shape)}: {got['respond']} pixels "
        f"respond, {got['near_differ']} differ at the margins, resp err "
        f"{got['resp_err']:.3e}, next base err {got['next_err']:.3e}")
    return got["resp_err"], got["next_plain"]


def b8_phase(ck, sift, features, frames: torch.Tensor, card: str,
             contrast: float = 0.04 / 3, octaves: int = 5):
    """Phase 2f on a chunk's (2F, H, W) frames: returns (max resp err,
    {shape: (kernel ms, plain ms, bound ms, bound by)})."""
    pre = float((sift.SIGMA0 ** 2 - 1.0) ** 0.5)
    level = features.gaussian_blur(sift.upsample2(frames), pre,
                                   sift._blur_radius(pre)).contiguous()
    err, times = 0.0, {}
    for o in range(octaves):
        last = o + 1 == octaves
        e, nxt = check_b8(ck, level, contrast, last, f"octave {o}")
        err = max(err, e)
        t_k = median_ms(lambda: ck.sift_octave(level, contrast, last=last))
        t_p = median_ms(lambda: ck.sift_octave_plain(level, contrast,
                                                     last=last))
        b_ms, b_by = b8_bound(*level.shape, last)
        times[str(tuple(level.shape))] = (t_k, t_p, b_ms, b_by)
        log(f"[B8] octave {o} {tuple(level.shape)} median of {TIMING_RUNS}: "
            f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}, {100 * b_ms / t_k:.1f} % of it) ({card})")
        level = nxt
    total = sum(t[0] for t in times.values())
    log(f"[B8] a chunk's {octaves} octaves: kernel {total:.3f} ms, plain "
        f"{sum(t[1] for t in times.values()):.3f} ms, bound "
        f"{sum(t[2] for t in times.values()):.3f} ms ({card})")
    return err, times


def sift_octave_bases(sift, features, frames):
    """(label, images) of SIFT's first and last octave bases of ``frames``
    at the frontend's four octaves: the x2-upsampled, pre-blurred image,
    and the third decimation of gauss[intervals] below it."""
    pre = float((sift.SIGMA0 ** 2 - 1.0) ** 0.5)
    level = features.gaussian_blur(sift.upsample2(frames), pre,
                                   sift._blur_radius(pre))
    yield "SIFT octave -1", level
    for _ in range(3):
        level = sift.gaussian_pyramid_octave(level)[sift.INTERVALS][
            ..., ::2, ::2].contiguous()
    yield "SIFT octave 2", level


STEREO_SHIFT = ((-100.0, -2.0), (-1.5, 1.5))
TEMPORAL_SHIFT = ((-60.0, 60.0), (-20.0, 20.0))


def b2_inputs(gen, B, Ka, Kb, D=128, shift=STEREO_SHIFT,
              dtype=torch.float32):
    """Descriptor sets with genuine matches: B's rows are noisy copies of
    a permutation of A's (plus distractors), positions shifted by
    ``shift`` ((dx_lo, dx_hi), (dy_lo, dy_hi)): a stereo pair's disparity
    by default, ego motion with TEMPORAL_SHIFT."""
    dev = gen.device
    a = torch.randn((B, Ka, D), generator=gen, device=dev)
    a = a / a.norm(dim=-1, keepdim=True)
    src = torch.randint(0, Ka, (B, Kb), generator=gen, device=dev)
    b = torch.gather(a, 1, src[..., None].expand(-1, -1, D))
    b = b + 0.35 * torch.randn((B, Kb, D), generator=gen, device=dev)
    b = b / b.norm(dim=-1, keepdim=True)
    scale = torch.tensor([HW[1], HW[0]], device=dev, dtype=torch.float32)
    xy_a = torch.rand((B, Ka, 2), generator=gen, device=dev) * scale
    lo = torch.tensor([shift[0][0], shift[1][0]], device=dev)
    hi = torch.tensor([shift[0][1], shift[1][1]], device=dev)
    off = lo + (hi - lo) * torch.rand((B, Kb, 2), generator=gen, device=dev)
    xy_b = torch.gather(xy_a, 1, src[..., None].expand(-1, -1, 2)) + off
    va = torch.rand((B, Ka), generator=gen, device=dev) > 0.05
    vb = torch.rand((B, Kb), generator=gen, device=dev) > 0.05
    return a.to(dtype).contiguous(), b.to(dtype).contiguous(), va, vb, \
        xy_a.contiguous(), xy_b.contiguous()


def check_b2(ck, inputs, window, label: str) -> float:
    """Kernel B2 vs its plain version; returns max abs distance err.

    Tolerances: distances within 1e-5 (bf16 products are exact in f32;
    only the summation order differs); indices equal wherever the plain
    version's best and second-best differ by more than 1e-5."""
    a, b, va, vb, xa, xb = inputs
    out_k = ck.mutual_nearest(a, b, va, vb, xa, xb, window)
    out_p = ck.mutual_nearest_plain(a, b, va, vb, xa, xb, window)
    sync(a)
    rd_k, ri_k, cd_k, ci_k = out_k
    rd_p, ri_p, cd_p, ci_p = out_p
    err = max(float((rd_k - rd_p).abs().max()),
              float((cd_k - cd_p).abs().max()))
    if err > 1e-5:
        fail(f"B2 {label}: distance err {err} > 1e-5")
    # second-best margins from the plain distance matrix
    base = ck.window_distances(a, b, xa, xb, window)
    d_row = base + torch.where(vb, 0.0, ck.BIG)[:, None, :]
    d_col = base + torch.where(va, 0.0, ck.BIG)[:, :, None]
    n_checked = 0
    for d, ik, ip, dim in ((d_row, ri_k, ri_p, 2), (d_col, ci_k, ci_p, 1)):
        top2 = torch.topk(d, 2, dim=dim, largest=False).values
        first, second = top2.select(dim, 0), top2.select(dim, 1)
        decided = (second - first) > 1e-5
        n_checked += int(decided.sum())
        if (decided & (ik != ip)).any():
            fail(f"B2 {label}: {int((decided & (ik != ip)).sum())} "
                 f"indices differ away from ties")
    log(f"[B2] {label} {tuple(a.shape)} x {tuple(b.shape)}: dist err "
        f"{err:.3e}, {n_checked} decided indices equal")
    return err


def lowest_argmin(d: torch.Tensor, dim: int) -> torch.Tensor:
    """The lowest index attaining the minimum along ``dim``, computed
    explicitly (whatever torch.min returns on ties)."""
    m = d.min(dim=dim, keepdim=True).values
    idx = torch.arange(d.shape[dim], device=d.device)
    shape = [1] * d.dim()
    shape[dim] = -1
    return torch.where(d == m, idx.view(shape), d.shape[dim]).min(dim=dim)[0]


def check_b2_hamming(ck, binary, inputs, window, label: str):
    """Kernel B2 on +-1 signs vs its plain distance matrix: distances are
    exact integers in both, so distances equal exactly and every row and
    column index equals the lowest-index argmin, ties included. Returns
    (max abs distance err, tied rows and columns)."""
    a, b, va, vb, xa, xb = inputs
    rd, ri, cd, ci = ck.mutual_nearest(a, b, va, vb, xa, xb, window)
    sync(a)
    base = ck.window_distances(a, b, xa, xb, window)
    d_row = base + torch.where(vb, 0.0, ck.BIG)[:, None, :]
    d_col = base + torch.where(va, 0.0, ck.BIG)[:, :, None]
    err = max(float((rd - d_row.min(dim=2).values).abs().max()),
              float((cd - d_col.min(dim=1).values).abs().max()))
    if err != 0.0:
        fail(f"B2 hamming {label}: distance err {err} != 0")
    n_tied = 0
    for d, got, dim in ((d_row, ri, 2), (d_col, ci, 1)):
        want = lowest_argmin(d, dim)
        if not torch.equal(got, want):
            fail(f"B2 hamming {label}: {int((got != want).sum())} indices "
                 f"differ from the lowest-index argmin")
        m = d.min(dim=dim, keepdim=True).values
        n_tied += int(((d == m).sum(dim=dim) > 1).sum())
    D = a.shape[-1]
    m = binary.hamming_mutual_match(a, b, va, vb, max_hamming=40, xy_a=xa,
                                    xy_b=xb, window=window)
    sync(a)
    log(f"[B2] hamming {label} {tuple(a.shape)} x {tuple(b.shape)}: "
        f"distances exact, all {ri.numel() + ci.numel()} indices equal to "
        f"the lowest-index argmin ({n_tied} tied rows and columns); "
        f"{int(m['matched'].sum())} matches under the gate "
        f"{binary.base_gate_from_hamming(40, D)} (40 bits)")
    return err, n_tied


def spd_systems(gen, B, N, bad=()):
    """Random SPD systems with the gauge rows (the frozen pose 0's six
    identity rows and columns), as tests/test_pallas_parity.py builds
    them, and right-hand sides zero on the gauge. The systems in ``bad``
    get one eigenvalue of -1 below the gauge block, so their factorization
    fails part way."""
    dev = gen.device
    A = torch.randn((B, N, N), generator=gen, device=dev)
    S = A @ A.transpose(1, 2) + 3.0 * torch.eye(N, device=dev)
    for b in bad:
        low = float(torch.linalg.eigvalsh(S[b, 6:, 6:].double()).min())
        S[b, 6:, 6:] -= (low + 1.0) * torch.eye(N - 6, device=dev)
    S[:, :6, :] = 0.0
    S[:, :, :6] = 0.0
    S[:, torch.arange(6), torch.arange(6)] = 1.0
    g = torch.randn((B, N), generator=gen, device=dev)
    g[:, :6] = 0.0
    return S.contiguous(), g


def b6_bound(S, g):
    """B6's bound: S's lower triangle (all a Cholesky solve reads) and g
    in, x out; a Cholesky and two substitutions, N^3 / 3 + 2 N^2
    operations, per system."""
    B, N = g.shape
    tri = B * N * (N + 1) // 2 * S.element_size()
    return bound(tri + nbytes(g, g), B * (N ** 3 / 3 + 2 * N ** 2))


def check_b6(ck, S, g, label: str, bad=None) -> float:
    """Kernel B6 vs its plain version, both against the float64 solution
    of the same systems on the card. Tolerance: the kernel's error
    relative to max |x| (per system, the largest over the batch) at most
    4x the plain version's + 1e-6 (both factor the same float32 matrix,
    summing in other orders); the systems whose factorization the plain
    version fails (``bad``, where given), and only they, all NaN in the
    kernel's result. Returns max abs (kernel - plain) over the solved
    rows."""
    x_k = ck.cholesky_solve(S, g)
    x_p = ck.cholesky_solve_plain(S, g)
    x_64 = torch.linalg.solve(S.double(), g.double())
    sync(S)
    failed = torch.isnan(x_p).all(-1)
    rows = failed.nonzero().flatten().tolist()
    if bad is not None and rows != list(bad):
        fail(f"B6 {label}: the plain version fails systems {rows}, want "
             f"{list(bad)}")
    if not torch.equal(torch.isnan(x_k).all(-1), failed):
        fail(f"B6 {label}: the kernel's NaN rows "
             f"{torch.isnan(x_k).all(-1).nonzero().flatten().tolist()}, the "
             f"plain version's {rows}")
    ok = ~failed
    if not torch.isfinite(x_k[ok]).all():
        fail(f"B6 {label}: non-finite x in a solved system")
    scale = x_64[ok].abs().amax(-1)
    e_k = float(((x_k[ok] - x_64[ok]).abs().amax(-1) / scale).max())
    e_p = float(((x_p[ok] - x_64[ok]).abs().amax(-1) / scale).max())
    if e_k > 4.0 * e_p + 1e-6:
        fail(f"B6 {label}: error {e_k:.3e} > 4 x plain {e_p:.3e} + 1e-6")
    err = float((x_k[ok] - x_p[ok]).abs().max())
    log(f"[B6] {label} {tuple(S.shape)}: error vs float64 {e_k:.3e} "
        f"(plain {e_p:.3e}), max abs vs plain {err:.3e}, failed systems "
        f"{rows} all NaN in both")
    return err


# where b7_args puts the slot table and lam
B7_SLOT, B7_LAM = 7, 8


def b7_args(ba, poses, points, cam, lm, meas, w, calib, lam0=1e-4):
    """B7's arguments at LM's first iteration: the state after the first
    depth prune (poses, points, cam, lm, meas, w, calib), the slot table
    and lam (B,)."""
    w = ba.prune_depth_weights(poses, points, cam, lm, w)
    slot = ba._slot_table(cam, lm, w, poses.shape[1], points.shape[1])
    lam = torch.full((poses.shape[0],), lam0, device=poses.device)
    return poses, points, cam, lm, meas, w, calib, slot, lam


def b7_bound(args):
    """B7's bound, one reduction: the windows' poses and points, the
    observed lanes' measurement and weight (4 floats), the slot table and
    lam in; S, ghat, Hll_inv, g_l and the observed lanes' W out.
    Multiply-adds (2 operations each): per observation ~80 for its
    residual and Jacobians, 81 for its Hll, g_l and W terms, 216 for
    V = W Hll^-1, Hpp's and V W^T's upper triangles, g_p and V g; per pair
    of observations of one landmark, 108 for the 6x6 block V_il W_jl^T."""
    slot = args[B7_SLOT]
    B, L, P = slot.shape
    n_l = (slot >= 0).sum(-1).double()
    n_obs = float(n_l.sum())
    pairs = float((n_l * (n_l - 1) / 2).sum())
    n_bytes = 4 * (B * P * 16 + B * L * 3 + n_obs * (4 + 18) + slot.numel()
                   + B + B * (36 * P * P + 6 * P) + B * L * 12)
    return bound(n_bytes, 2 * (n_obs * (80 + 81 + 216) + pairs * 108))


def b7_rel_err(x, ref) -> float:
    """Largest |x - ref| over each window's largest |ref|, the worst
    window's."""
    B = ref.shape[0]
    d = (x.double() - ref).abs().reshape(B, -1).amax(-1)
    return float((d / ref.abs().reshape(B, -1).amax(-1).clamp_min(1e-30))
                 .max())


def check_b7(ck, args, label: str) -> float:
    """Kernel B7 vs its plain version, both against the plain version in
    float64, for LM's damped system and the covariances' (S, ghat,
    Hll_inv, g_l; then the landmark steps from the float64 pose step).
    Tolerance: the kernel's error per window relative to its largest
    entry at most 4x the plain version's + 1e-6 for what is built from
    the Jacobians alone (S, Hll_inv), + 1e-3 for what is built from the
    residuals (ghat, g_l, the landmark steps): a residual of ~0.5 px is
    the difference of a projection of up to ~1241 px and its measurement,
    so the float32 rounding of the projection leaves ~1.5e-4 of it, which
    the kernel and torch round apart (tests/test_torch_schur_reduce.py).
    S exactly symmetric, the gauge rows identity, a second launch equal
    bit for bit. Returns max abs (kernel - plain) of S over both
    systems."""
    a64 = tuple(t.double() if t.is_floating_point() else t for t in args)
    err, worst = 0.0, {}
    for lam_on in (True, False):
        a32 = args if lam_on else args[:B7_LAM] + (None,)
        b64 = a64 if lam_on else a64[:B7_LAM] + (None,)
        eps = {} if lam_on else {"eps_l": 1e-6, "eps_s": 1e-8}
        k = ck.schur_reduce(*a32, **eps)
        k2 = ck.schur_reduce(*a32, **eps)
        p = ck.schur_reduce_plain(*a32, **eps)
        r64 = ck.schur_reduce_plain(*b64, **eps)
        sync(k[0])
        for name, i in (("S", 0), ("ghat", 1), ("Hll_inv", 2), ("g_l", 3)):
            if not torch.equal(k[i], k2[i]):
                fail(f"B7 {label}: {name} differs between two launches")
            e_k, e_p = b7_rel_err(k[i], r64[i]), b7_rel_err(p[i], r64[i])
            atol = 1e-6 if name in ("S", "Hll_inv") else 1e-3
            if not e_k <= 4.0 * e_p + atol:
                fail(f"B7 {label}: {name} (lam {lam_on}) error {e_k:.3e} > "
                     f"4 x plain {e_p:.3e} + {atol}")
            worst[f"{name}{'' if lam_on else ' cov'}"] = (e_k, e_p)
        S = k[0]
        if not torch.equal(S, S.transpose(1, 2)):
            fail(f"B7 {label}: S not symmetric")
        eye = torch.eye(6, device=S.device).expand(S.shape[0], 6, 6)
        if not torch.equal(S[:, :6, :6], eye) or (S[:, :6, 6:] != 0).any():
            fail(f"B7 {label}: the gauge rows are not identity")
        err = max(err, float((k[0] - p[0]).abs().max()))
    k = ck.schur_reduce(*args)
    p = ck.schur_reduce_plain(*args)
    r64 = ck.schur_reduce_plain(*a64)
    dp = -torch.linalg.solve(r64[0], r64[1])
    slot = args[B7_SLOT]
    dl_k = ck.schur_back(dp.float(), slot, k[4], k[2], k[3])
    dl_p = ck.schur_back_plain(dp.float(), slot, p[4], p[2], p[3])
    dl_64 = ck.schur_back_plain(dp, slot, r64[4], r64[2], r64[3])
    e_k, e_p = b7_rel_err(dl_k, dl_64), b7_rel_err(dl_p, dl_64)
    if not e_k <= 4.0 * e_p + 1e-3:
        fail(f"B7 {label}: dl error {e_k:.3e} > 4 x plain {e_p:.3e} + 1e-3")
    worst["dl"] = (e_k, e_p)
    log(f"[B7] {label} {tuple(slot.shape)} x {args[5].shape[1]} lanes: "
        f"error vs float64 (kernel / plain) "
        + ", ".join(f"{n} {a:.2e} / {b:.2e}" for n, (a, b) in worst.items())
        + f"; max abs S vs plain {err:.3e}; repeats bit for bit")
    return err


def b9_bound(args):
    """B9's bound, one system: the nodes, the edges (two int64 indices,
    Z^-1, S, the weight) and the mask in; A, rhs and dscale out; or the
    edges' float64 arithmetic (B9_OPS_PER_EDGE), the larger."""
    nodes, e_i = args[0], args[1]
    N, E = nodes.shape[0], e_i.shape[0]
    n_bytes = (64 * N + E * (16 + 64 + 144 + 4) + 24 * N
               + 4 * (36 * N * N + 12 * N))
    return bound(n_bytes, B9_OPS_PER_EDGE * E, "f64")


def b9_phase(ck, card: str):
    """Phase 2g: B9 against its plain version at each bucket of
    pg_system_check.BUCKETS (its rule), then median times of the system,
    the step, their plain versions and the LU solve between them, and the
    bound. Returns (the largest A / rhs error, {bucket: (system ms, plain
    system ms, step ms, plain step ms, LU solve ms, bound ms, bound by)})."""
    import pg_system_check as pgc

    err, at = 0.0, {}
    for bucket in pgc.BUCKETS:
        args = pgc.system_args(pgc.bucket_graph(bucket, "cuda"))
        try:
            errs = pgc.check_system(ck, args)
        except AssertionError as e:
            fail(f"B9 at {bucket} nodes: {e}")
        err = max(err, errs["A"], errs["rhs"])
        A, rhs, dscale, cost = ck.pg_system(*args)
        x = torch.linalg.solve_ex(A, rhs[:, None])[0][:, 0]
        nodes, lam, c = args[0].clone(), args[7].clone(), cost.clone()
        edges = args[1:6]
        at[bucket] = t = (
            median_ms(lambda: ck.pg_system(*args)),
            median_ms(lambda: ck.pg_system_plain(*args)),
            median_ms(lambda: ck.pg_step(nodes, x, dscale, c, lam, *edges)),
            median_ms(lambda: ck.pg_step_plain(nodes, x, dscale, c, lam,
                                               *edges)),
            median_ms(lambda: torch.linalg.solve_ex(A, rhs[:, None])),
            *b9_bound(args))
        log(f"[B9] {bucket} nodes, {args[1].shape[0]} edges: errors "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; median of {TIMING_RUNS}: system {t[0]:.4f} ms (plain "
            f"{t[1]:.4f}), step {t[2]:.4f} ms (plain {t[3]:.4f}), LU solve "
            f"{t[4]:.4f} ms, bound {t[5]:.5f} ms ({t[6]}) ({card})")
    return err, at


def scene_windows(frontend, bundle, TrackStore, L, R, scene, cfg):
    """The scene's BA windows, built on the host from a frontend run on
    the card as run_bundles builds them."""
    fr = frontend.run_frontend(L, R, scene.calib, cfg, device="cuda")
    db = TrackStore.from_frontend(fr)
    kfs = bundle.select_keyframes(db, fr.T_w2c, cfg.keyframes)
    batch = bundle.build_windows(db, fr.T_w2c, kfs, cfg.bundle)
    bundle.init_landmarks(batch, scene.calib)
    return batch


def reduced_systems(ba, poses, points, cam, lm, meas, w, calib, lam0=1e-4):
    """The reduced pose systems (S, ghat) of LM's first iteration: the
    first depth prune, then one Schur setup at lam0."""
    w = ba.prune_depth_weights(poses, points, cam, lm, w)
    J_pose, J_lm, r = ba._linearize(poses, points, cam, lm, meas, w, calib)
    blocks = ba._build_blocks(J_pose, J_lm, r, cam, lm, poses.shape[1],
                              points.shape[1])
    lam = torch.full((poses.shape[0],), lam0, device=poses.device)
    S, ghat, _, _ = ba._damped_system(blocks, lam)
    return S, ghat


def synthetic_windows(se3, stereo, calib, B, P, L, M, seed):
    """B seeded BA windows at full capacity on calib's device: P cameras
    1 m apart along the optical axis, L landmarks 8-60 m ahead, each seen
    by M / L distinct cameras (stereo measurements with 0.5 px noise), and
    the initial state perturbed by ~0.3 deg / 5 cm per pose (pose 0
    exact) and 10 cm per landmark."""
    dev = calib.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    per = M // L
    T = torch.eye(4, device=dev).repeat(B, P, 1, 1)
    T[..., 2, 3] = -torch.arange(P, device=dev, dtype=torch.float32)
    lo = torch.tensor([-12.0, -3.0, P + 8.0], device=dev)
    hi = torch.tensor([12.0, 3.0, P + 60.0], device=dev)
    X = lo + (hi - lo) * torch.rand((B, L, 3), generator=gen, device=dev)
    cam = torch.argsort(torch.rand((B, L, P), generator=gen, device=dev),
                        dim=-1)[..., :per].reshape(B, M)
    lm = torch.arange(L, device=dev).repeat_interleave(per).repeat(B, 1)
    b = torch.arange(B, device=dev)[:, None]
    Tc, Xo = T[b, cam], X[b, lm]
    Xc = se3.mv3(Tc[..., :3, :3], Xo) + Tc[..., :3, 3]
    meas = stereo.project(calib, Xc) + 0.5 * randn(B, M, 3)
    delta = torch.cat([0.005 * randn(B, P, 3), 0.05 * randn(B, P, 3)], -1)
    delta[:, 0] = 0.0
    poses0 = se3.retract(T, delta)
    points0 = X + 0.1 * randn(B, L, 3)
    w = torch.ones((B, M), device=dev)
    return poses0, points0, cam, lm, meas, w



def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)

    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.models import bundle, frontend, loop_closure
    from slam_tpu_torch.models.trackstore import TrackStore
    from slam_tpu_torch.ops import akaze, ba, binary, features, se3, sift
    from slam_tpu_torch.ops import stereo as stereo_ops
    from slam_tpu_torch.ops import cuda_kernels as ck

    cfg = SlamConfig()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    ck.build()
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")
    for line in ck.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    # the card tests' 80-frame loop scene (card_checks.SCENE)
    t0 = time.perf_counter()
    scene, L, R = card_checks.loop_scene()
    log(f"[scene] rendered {L.shape[0]} stereo pairs at {HW} in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. kernel B1 -------------------------------------------------------
    # the frontend's B1 call: one chunk, left then right images
    chunk = cfg.runtime.chunk_frames
    path = torch.from_numpy(np.concatenate([L[:chunk], R[:chunk]])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    odd = torch.rand((2, 100, 333), generator=gen, device="cuda")
    b1_err = max(check_b1(ck, path, "frontend chunk"),
                 check_b1(ck, path[::chunk // 2][:4].contiguous(),
                          "4 rendered"),
                 check_b1(ck, odd, "odd"))
    # around the kernel's edges: a block owns at most 246 output columns
    # and at least 32 rows
    for shape in ((1, 31, 245), (1, 32, 246), (1, 33, 247), (2, 63, 491),
                  (1, 64, 492), (1, 65, 493), (1, 40, 9)):
        edge = torch.rand(shape, generator=gen, device="cuda")
        b1_err = max(b1_err, check_b1(ck, edge, "edge"))
    b1_ms = median_ms(lambda: ck.detect_maps(path))
    b1_plain_ms = median_ms(lambda: ck.detect_maps_plain(path))
    # 1 plane in; resp, nms and 8 orientation maps out
    px = path.numel()
    bounds = {"detect_maps": bound(4 * px * 11,
                                   OPS_PER_PIXEL["detect_maps"] * px),
              "harris_response": bound(4 * px * 3,
                                       OPS_PER_PIXEL["harris_response"] * px)}
    log(f"[B1] {tuple(path.shape)} median of {TIMING_RUNS}: kernel "
        f"{b1_ms:.3f} ms, plain {b1_plain_ms:.3f} ms ({card})")
    # the wrappers' host cost where the launch is all there is to it
    tiny = torch.rand((1, 40, 60), generator=gen, device="cuda")
    log(f"[B1] wrapper host time at {tuple(tiny.shape)}: "
        f"{host_us(lambda: ck.detect_maps(tiny)):.2f} us per call (mean of "
        f"{HOST_CALLS} calls, no sync between) ({card})")

    # ---- 2b. kernels B4 and B3 ---------------------------------------------
    # B4 has no caller in the pipeline: its launch count is this phase's
    ck.reset_counters()
    b4_err = check_b4(ck, path, "frontend chunk")
    b4_launches = ck.LAUNCHES["harris_response"]
    for shape in ((1, 33, 247), (2, 63, 491)):
        edge = torch.rand(shape, generator=gen, device="cuda")
        b4_err = max(b4_err, check_b4(ck, edge, "edge"))
    b4_ms = median_ms(lambda: ck.harris_response(path))
    b4_plain_ms = median_ms(lambda: ck.harris_response_plain(path))
    log(f"[B4] {tuple(path.shape)} median of {TIMING_RUNS}: kernel "
        f"{b4_ms:.3f} ms, plain {b4_plain_ms:.3f} ms ({card})")
    # B3 runs on AKAZE's diffused octaves: the blurred chunk at octave 0,
    # its 2x downsample at octave 1
    oct0 = features.gaussian_blur(path, 1.0, 2)
    oct1 = features.downsample2(oct0)
    b3_err = max(check_b3(ck, oct0, "octave 0"),
                 check_b3(ck, oct1, "octave 1"),
                 check_b3(ck, odd, "odd"),
                 check_b3(ck, torch.rand((1, 33, 247), generator=gen,
                                         device="cuda"), "edge"),
                 check_b3(ck, torch.rand((2, 63, 491), generator=gen,
                                         device="cuda"), "edge"))
    bounds["orientation_maps"] = bound(4 * px * 9,
                                       OPS_PER_PIXEL["orientation_maps"] * px)
    b3_times = {}
    for label, x in (("octave 0", oct0), ("octave 1", oct1)):
        b3_times[label] = (median_ms(lambda: ck.orientation_maps(x)),
                           median_ms(lambda: ck.orientation_maps_plain(x)))
        log(f"[B3] {label} {tuple(x.shape)} median of {TIMING_RUNS}: kernel "
            f"{b3_times[label][0]:.3f} ms, plain {b3_times[label][1]:.3f} "
            f"ms ({card})")
    # SIFT's octave bases of the same chunk: the x2 '-1' octave, and the
    # last of the four (each decimates gauss[3] of the one before)
    b3_sift = {}
    for label, x in sift_octave_bases(sift, features, path):
        b3_err = max(b3_err, check_b3(ck, x, label))
        px_x = x.numel()
        t_k = median_ms(lambda: ck.orientation_maps(x))
        t_p = median_ms(lambda: ck.orientation_maps_plain(x))
        b_ms, b_by = bound(4 * px_x * 9, OPS_PER_PIXEL["orientation_maps"]
                           * px_x)
        b3_sift[str(tuple(x.shape))] = {"ms": t_k, "plain_ms": t_p,
                                        "bound_ms": b_ms, "bound_by": b_by}
        log(f"[B3] {label} {tuple(x.shape)} median of {TIMING_RUNS}: kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}) ({card})")
        del x

    # ---- 2c. kernel B5 ------------------------------------------------------
    # the AKAZE path's own inputs: per-frame contrast of the chunk, octave 0
    # on the blurred chunk, octave 1 on the 2x downsample of its diffusion
    k = akaze._contrast_k(path)
    b5_err, L0 = check_b5(ck, oct0, k, 1.6, "octave 0")
    oct1 = features.downsample2(L0)
    b5_err = max(b5_err, check_b5(ck, oct1, k, 3.2, "octave 1")[0])
    small = path[:2]
    for _ in range(3):
        small = features.downsample2(small)
    b5_err = max(b5_err, check_b5(ck, small, k[:2], 12.8,
                                  "KITTI octave 3")[0])
    # around the kernel's edges: a CTA owns a 72 x 64 output tile; an image
    # smaller than the halo wraps more than once
    for shape in ((1, 63, 71), (1, 64, 72), (1, 65, 73), (2, 127, 143),
                  (1, 128, 144), (1, 129, 145), (1, 30, 20), (1, 13, 9)):
        edge = torch.rand(shape, generator=gen, device="cuda")
        b5_err = max(b5_err, check_b5(ck, edge, k[:shape[0]], 3.2, "edge")[0])
    # every count but 6 takes the run-time path
    b5_err = max(b5_err, check_b5(ck, oct0, k, 1.6, "octave 0", steps=4)[0],
                 check_b5(ck, small, k[:2], 12.8, "KITTI octave 3",
                          steps=9)[0])
    bounds["akaze_octave"] = bound(4 * px * 4 + nbytes(k),
                                   OPS_PER_PIXEL["akaze_octave"] * px)
    b5_times = {}
    for label, x, sigma in (("octave 0", oct0, 1.6), ("octave 1", oct1, 3.2)):
        b5_times[label] = (
            median_ms(lambda: ck.akaze_octave(x, k, 6, sigma=sigma)),
            median_ms(lambda: ck.akaze_octave_plain(x, k, 6, sigma=sigma)))
        log(f"[B5] {label} {tuple(x.shape)} median of {TIMING_RUNS}: kernel "
            f"{b5_times[label][0]:.3f} ms, plain {b5_times[label][1]:.3f} "
            f"ms ({card})")
    log(f"[B5] wrapper host time at {tuple(tiny.shape)}: "
        f"{host_us(lambda: ck.akaze_octave(tiny, k[:1], 6)):.2f} us per call "
        f"(mean of {HOST_CALLS} calls, no sync between) ({card})")
    del oct0, oct1, L0

    # ---- 2f. kernel B8 ------------------------------------------------------
    # SIFT's five octaves of the frontend chunk at sift.loop80's settings
    b8_err, b8_times = b8_phase(ck, sift, features, path, card)
    first = next(iter(b8_times))
    bounds["sift_octave"] = b8_times[first][2:]
    del path

    # ---- 2d. kernel B6 ------------------------------------------------------
    # the reduced pose systems BA solves: the scene's own windows at LM's
    # first iteration, BA's device_batch of random systems, the
    # loop-closure mini-bundle's one 12x12 system, and a failing system
    calib_t = torch.tensor(scene.calib, device="cuda")
    batch = scene_windows(frontend, bundle, TrackStore, L, R, scene, cfg)
    S_scene, g_scene = reduced_systems(
        ba, *(torch.as_tensor(a, device="cuda") for a in (
            batch.poses0, batch.points0, batch.cam_idx.astype(np.int64),
            batch.lm_idx.astype(np.int64), batch.meas, batch.w)), calib_t)
    N6 = 6 * cfg.bundle.max_poses
    S_64, g_64 = spd_systems(gen, 64, N6)
    S_12, g_12 = spd_systems(gen, 1, 12)
    S_bad, g_bad = spd_systems(gen, 8, N6, bad=(3,))
    b6_err = max(check_b6(ck, S_scene, g_scene, "scene windows"),
                 check_b6(ck, S_64, g_64, "device batch"),
                 check_b6(ck, S_12, g_12, "loop-closure pair"),
                 check_b6(ck, S_bad, g_bad, "one failing", bad=(3,)))
    # by shape: (kernel, plain, solve_ex, bound) ms
    b6_at = {}
    for label, S_, g_ in (("device batch", S_64, g_64),
                          ("scene windows", S_scene, g_scene),
                          ("loop-closure pair", S_12, g_12)):
        b6_at[tuple(S_.shape)] = t = (
            median_ms(lambda: ck.cholesky_solve(S_, g_)),
            median_ms(lambda: ck.cholesky_solve_plain(S_, g_)),
            median_ms(lambda: torch.linalg.solve_ex(S_, g_)),
            b6_bound(S_, g_)[0])
        log(f"[B6] {label} {tuple(S_.shape)} median of {TIMING_RUNS}: kernel "
            f"{t[0]:.4f} ms, plain (cholesky_ex + cholesky_solve) {t[1]:.4f} "
            f"ms, solve_ex {t[2]:.4f} ms, bound {t[3]:.5f} ms ({card})")
    b6_ms, b6_plain_ms, b6_lib_ms, _ = b6_at[tuple(S_64.shape)]
    # the wrapper's host cost where the launch is all there is to it
    wrapper_us = host_us(lambda: ck.cholesky_solve(S_12, g_12))
    log(f"[B6] wrapper host time at {tuple(S_12.shape)}: {wrapper_us:.2f} us "
        f"per call (mean of {HOST_CALLS} calls, no sync between) ({card})")
    bounds["cholesky_solve"] = b6_bound(S_64, g_64)
    del S_scene, S_64, S_bad

    # ---- 2e. kernel B7 ------------------------------------------------------
    # the reduced systems' assembly: the scene's windows at LM's first
    # iteration, seeded windows at BA's device_batch and at the loops'
    # one slice, and the pair refinement's one window of two poses
    bc = cfg.bundle
    b7_sets = {"scene windows": b7_args(ba, *(
        torch.as_tensor(a, device="cuda") for a in (
            batch.poses0, batch.points0, batch.cam_idx.astype(np.int64),
            batch.lm_idx.astype(np.int64), batch.meas, batch.w)), calib_t)}
    for label, B_, P_, L_, M_ in (
            ("device batch", 64, bc.max_poses, bc.max_landmarks, bc.max_obs),
            ("loop slice", 16, bc.max_poses, bc.max_landmarks, bc.max_obs),
            ("loop-closure pair", 1, 2, 512, 1024)):
        b7_sets[label] = b7_args(ba, *synthetic_windows(
            se3, stereo_ops, calib_t, B_, P_, L_, M_, SEED + B_), calib_t)
    b7_err = max(check_b7(ck, t_, label) for label, t_ in b7_sets.items())
    # by set: (kernel, plain, kernel landmark steps, plain landmark steps,
    # bound) ms
    b7_at = {}
    for label, t_ in b7_sets.items():
        k_, p_ = ck.schur_reduce(*t_), ck.schur_reduce_plain(*t_)
        dp_ = torch.zeros_like(k_[1])
        b7_at[label] = t = (
            median_ms(lambda: ck.schur_reduce(*t_)),
            median_ms(lambda: ck.schur_reduce_plain(*t_)),
            median_ms(lambda: ck.schur_back(dp_, t_[B7_SLOT], k_[4], k_[2],
                                            k_[3])),
            median_ms(lambda: ck.schur_back_plain(dp_, t_[B7_SLOT], p_[4],
                                                  p_[2], p_[3])),
            *b7_bound(t_))
        log(f"[B7] {label} {tuple(t_[B7_SLOT].shape)} x {t_[5].shape[1]} "
            f"lanes, "
            f"median of {TIMING_RUNS}: kernel {t[0]:.4f} ms (landmark steps "
            f"{t[2]:.4f}), plain {t[1]:.4f} ms (landmark steps {t[3]:.4f}), "
            f"bound {t[4]:.5f} ms ({t[5]}) ({card})")
    b7_ms, b7_plain_ms = b7_at["device batch"][:2]
    pair = b7_sets["loop-closure pair"]
    log(f"[B7] wrapper host time at {tuple(pair[B7_SLOT].shape)}: "
        f"{host_us(lambda: ck.schur_reduce(*pair)):.2f} us per call (mean "
        f"of {HOST_CALLS} calls, no sync between) ({card})")
    bounds["schur_reduce"] = b7_bound(b7_sets["device batch"])
    del b7_sets, k_, p_, pair

    # ---- 2g. kernel B9 ------------------------------------------------------
    # the pose graph's LM system and step at the dense node buckets: the
    # loops' 64, the clover's 128 and KITTI 00's 704
    b9_err, b9_at = b9_phase(ck, card)
    bounds["pg_system"] = b9_at[64][5:]

    # ---- 3. kernel B2 -------------------------------------------------------
    # every call of the main path: the frontend's stereo and temporal
    # matching (windows of SlamConfig().matching) and loop verification
    # (no window, float16 descriptors, SPEC_Q * max_candidates pairs)
    K = cfg.features.max_kp
    stereo_win, temporal_win = frontend.search_windows(cfg.matching)
    n_verify = loop_closure.SPEC_Q * cfg.loop.max_candidates
    stereo = b2_inputs(gen, chunk, K, K)
    temporal = b2_inputs(gen, chunk, K, K, shift=TEMPORAL_SHIFT)
    verify = b2_inputs(gen, n_verify, K, K, dtype=torch.float16)
    ragged = b2_inputs(gen, 3, 1500, 1777)
    b2_err = max(check_b2(ck, stereo, stereo_win, "stereo window"),
                 check_b2(ck, temporal, temporal_win, "temporal window"),
                 check_b2(ck, verify, None, "loop verify, no window"),
                 check_b2(ck, stereo, None, "no window"),
                 check_b2(ck, ragged, None, "ragged"),
                 check_b2(ck, ragged, stereo_win, "ragged window"))
    b2_times = {}
    for label, inputs, win in (("stereo", stereo, stereo_win),
                               ("temporal", temporal, temporal_win),
                               ("verify", verify, None)):
        b2_times[label] = (
            median_ms(lambda: ck.mutual_nearest(*inputs, window=win)),
            median_ms(lambda: ck.mutual_nearest_plain(*inputs, window=win)))
        log(f"[B2] {label} {tuple(inputs[0].shape)} {inputs[0].dtype} "
            f"window {win} median of {TIMING_RUNS}: kernel "
            f"{b2_times[label][0]:.3f} ms, plain {b2_times[label][1]:.3f} "
            f"ms ({card})")
    b2_ms, b2_plain_ms = b2_times["stereo"]
    # descriptors, masks and positions in; row and column (dist, idx) out
    n_out = chunk * K * (4 + 8) * 2
    bounds["mutual_nearest"] = bound(nbytes(*stereo) + n_out,
                                     2 * chunk * K * K * stereo[0].shape[-1],
                                     "bf16")

    # ---- 3b. kernel B2 on the Hamming calls ---------------------------------
    # the AKAZE path's matching: binarized descriptors (+-1 signs) under
    # the stereo and the temporal window; integer distances tie often
    def signs(inputs):
        return tuple(binary.binarize_descriptors(x).contiguous()
                     if i < 2 else x for i, x in enumerate(inputs))

    hamming = {"stereo": (signs(stereo), stereo_win),
               "temporal": (signs(temporal), temporal_win)}
    for label, (inputs, win) in hamming.items():
        check_b2_hamming(ck, binary, inputs, win, f"{label} window")
    for label, (inputs, win) in hamming.items():
        t_k = median_ms(lambda: ck.mutual_nearest(*inputs, window=win))
        t_p = median_ms(lambda: ck.mutual_nearest_plain(*inputs, window=win))
        log(f"[B2] hamming {label} median of {TIMING_RUNS}: kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms ({card})")
    del stereo, temporal, verify, hamming

    # ---- 4. the paths -------------------------------------------------------
    # each detector's whole path on the scene from its CUDA graphs, as the
    # card tests run it (card_checks.run_path): the counters zeroed just
    # before the counted pass, every kernel the path needs launched, no
    # plain version run, >= 1 closure, every ATE under 1 m. No times: the
    # paths' speed is the benchmark's (slambench/)
    path_launches = {}
    for name, (cfg_p, required, _) in card_checks.DETECTORS.items():
        try:
            out = card_checks.run_path(cfg_p, required)
        except AssertionError as e:
            fail(f"path {name}: {e}")
        path_launches[name] = out["launches"]
        log(f"[path] {name}: launches {out['launches']}, ATEs "
            f"{out['ates']}, {len(out['closures'])} closure(s)")
        del out

    kernels = [
        {"name": "detect_maps", "route": "cuda",
         "source": "slam_tpu_torch/csrc/detect_maps.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:621",
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "mutual_nearest", "route": "cuda",
         "source": "slam_tpu_torch/csrc/mutual_nearest.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:105",
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms},
        {"name": "orientation_maps", "route": "cuda",
         "source": "slam_tpu_torch/csrc/detect_maps.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:461",
         "max_abs_err": b3_err, "ms": b3_times["octave 0"][0],
         "plain_ms": b3_times["octave 0"][1]},
        {"name": "harris_response", "route": "cuda",
         "source": "slam_tpu_torch/csrc/detect_maps.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:294",
         "max_abs_err": b4_err, "ms": b4_ms, "plain_ms": b4_plain_ms},
        {"name": "akaze_octave", "route": "cuda",
         "source": "slam_tpu_torch/csrc/akaze_octave.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:785",
         "max_abs_err": b5_err, "ms": b5_times["octave 0"][0],
         "plain_ms": b5_times["octave 0"][1]},
        {"name": "cholesky_solve", "route": "cuda",
         "source": "slam_tpu_torch/csrc/cholesky_solve.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:925",
         "max_abs_err": b6_err, "ms": b6_ms, "plain_ms": b6_plain_ms,
         "library_ms": b6_lib_ms},
        {"name": "schur_reduce", "route": "cuda",
         "source": "slam_tpu_torch/csrc/schur_reduce.cu",
         "replaces": "no TPU kernel (plain jnp in slam_tpu/ops/ba.py)",
         "max_abs_err": b7_err, "ms": b7_ms, "plain_ms": b7_plain_ms},
        {"name": "sift_octave", "route": "cuda",
         "source": "slam_tpu_torch/csrc/sift_octave.cu",
         "replaces": "no TPU kernel (plain jnp in slam_tpu/ops/sift.py)",
         "max_abs_err": b8_err, "ms": b8_times[first][0],
         "plain_ms": b8_times[first][1], "at_octaves": b8_times},
        {"name": "pg_system", "route": "cuda",
         "source": "slam_tpu_torch/csrc/pose_graph.cu",
         "replaces": "no TPU kernel (jax.jacfwd and plain jnp in "
                     "slam_tpu/ops/pose_graph.py)",
         "max_abs_err": b9_err, "ms": b9_at[64][0], "plain_ms": b9_at[64][1],
         "at_buckets": b9_at},
    ]
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k.setdefault("library_ms", None)
    by_name = {k["name"]: k for k in kernels}
    # each kernel's launches in the counted pass of each path that runs it
    for k in kernels:
        k["launches"] = {p: n[k["name"]] for p, n in path_launches.items()
                         if n[k["name"]]}
    by_name["pg_system"]["step_launches"] = {
        p: n["pg_step"] for p, n in path_launches.items() if n["pg_step"]}
    by_name["harris_response"]["launches_phase_2b"] = b4_launches
    by_name["orientation_maps"]["at_sift_octaves"] = b3_sift

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "slam_tpu"))
    if foreign:
        fail(f"modules of JAX or of the JAX package were imported: "
             f"{foreign[:10]}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
