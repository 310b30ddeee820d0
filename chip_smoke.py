"""GPU smoke test of slam_tpu_torch: kernels against their plain versions,
then the pipeline's main path end to end on the card.

    python3 chip_smoke.py                # every phase (one CUDA card)
    python3 chip_smoke.py --kernels-only # phases 1-3b: build + kernel checks
    python3 chip_smoke.py --profile DIR  # + phase 5, written to DIR

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
  3. kernel B2 (mutual_nearest) against its plain version on the card at
     every call the main path makes: (32, 2048, 128) with the stereo and
     the temporal window of SlamConfig().matching, and loop verification's
     (SPEC_Q * max_candidates = 60, 2048, 128) float16 batch without a
     window; also without a window at (32, 2048, 128) and a ragged
     (3, 1500, 128) x (3, 1777, 128); then median times;
  3b. kernel B2 on the Hamming calls: +-1 signs of binarized descriptors
     under the stereo and the temporal window; every index equal to the
     lowest-index argmin, ties included; median times;
  4. main path: run_pipeline + evaluate on an 80-frame 376x1241 loop
     scene (157 m, 8000 landmarks) on the card, with B1, B2 and B6
     launched (B6 once per LM iteration of BA and of loop closure, by
     shape), no plain version run and every stage's ATE under 1 m; B6's
     time on the path from its launches and phase 2d's times;
  4b. the AKAZE path: the same, under SlamConfig(features=
     FeatureConfig(detector="akaze"), matching=MatchConfig(norm=
     "hamming")), with B5, B3, B2 and B6 launched and no plain version
     run;
  4c. multiscale Harris: run_frontend under FeatureConfig(num_levels=2),
     B1 launched at both level shapes, frontend ATE under 1 m;
  4d. the main path with BA's solve on the library instead of B6
     (ops.ba._spd_solve swapped, here only, for B6's plain version,
     cholesky_ex + cholesky_solve): the same closures as phase 4 and
     every stage's ATE within 0.01 m of phase 4's;
  4e. the BA engine A/B: ops.ba.optimize_bundle at B=64, P=24, L=512,
     M=4096, 20 iterations, on seeded synthetic windows, solving on B6
     and on the library (median of 5 after a warm-up, and the median
     final cost of each), and one LM iteration split by phase (block
     build, Schur reduction, solve, back-substitution, cost) from a
     torch.profiler trace: host time, device busy time and the host's
     blocking calls of each phase (none allowed in back-substitution on
     B6: a pageable host copy there made the host wait every iteration);
  4f. the disk path: the scene written as uint8 PNGs in KITTI's layout
     (utils.kitti.write_kitti_sequence), then (a) run_pipeline from the
     path lists with a stage cache, with B1, B2 and B6 launched, no plain
     version run, >= 1 closure, every ATE under 1 m, and the decoder that
     ran named (the native one must have built); (b) a second call that
     loads every stage from the cache (no kernel launched) with the same
     closures and trajectories; (c) the frontend from the PNGs (chunks of
     16) stopped after 48 frames and resumed, equal bit for bit to an
     uninterrupted run, with the resumed chunks' recomputed descriptors
     equal to the originals; (d) run_frontend (uploads and read-backs
     overlapped) equal bit for bit to a plain sequential loop over
     process_chunk written here; (e) optimize_windows on the scene's
     windows in 4 pipelined slices of 4 against one slice of 16, within
     the tolerance below; (f) a 16-frame 370x1226 sequence through the
     (376, 1248) bucket;
  4g. the CLI on the card, started as users start it: python3 -m
     slam_tpu_torch --kitti-root <4f's KITTI directory> --seq 00: rc 0, the
     same closures as 4f's run (a), every stage's ATE under 1 m and within
     0.01 m of run_pipeline called in this process with the CLI's
     arguments (the (376, 1248) image bucket), graphs/analysis.json with
     numbers for every ARTIFACTS entry, and their PNGs where matplotlib is
     installed (else none, and the note); then --synthetic loop --frames
     80 (rc 0, >= 1 closure, ATE under 1 m); then utils.analysis.run_analysis
     in this process on phase 4's result, which launches B2 once per
     closure and no plain version; then the CLI with
     CUDA_VISIBLE_DEVICES="", which must exit non-zero naming the card;
  4h. the scale run at reduced depth and full width: python3 -m
     slam_tpu_torch.scale_run on a 336-frame 376x1241 clover of radii 10,
     13, 16, 14.5 m (12000 landmarks, 6 m corridor): rc 0, per-stage walls,
     >= 1 closure, every stage's ATE under 1 m; a second invocation loads
     every stage from its artifacts (no stage run, the same ATEs);
  4i. the SIFT path: run_pipeline + evaluate under SlamConfig(features=
     FeatureConfig(detector="sift")) with drive_path's gates (B3, B2 and B6
     launched, no plain version run, >= 1 closure, every ATE under 1 m;
     `[path sift]` lines), then run_frontend once more for its peak device
     memory (one batch of 64 images through four octaves, the first at
     752x2482), and chunk 0's descriptors recomputed as DescriptorBank
     does after a resume, equal bit for bit;
  4j. the ORB path: the same under FeatureConfig(detector="orb") and
     MatchConfig(norm="hamming"), B2 on the Hamming calls and B6 launched
     (`[path orb]` lines);
  4k. the sparse pose graph (`[pg sparse]` lines): (a) a 2560-node stiff
     chain with loop edges (2, 2558), (100, 2000), (500, 2400), built in
     numpy here (stiff_loop_graph, the JAX tests' construction), through
     PoseGraph above SPARSE_NODE_THRESHOLD on the card: optimize(iters=15)
     moves the nodes (> 0.05 m) to a finite cost, gate_distances of 121
     pairs 499 apart finite and positive, marginal_logdets growing along
     the chain, and selected_blocks within 1e-5 of the dense float64
     inverse of the same whitened Hessian formed on the card (refined by
     one Newton step, its change printed; relative to
     each block's largest entry; every diagonal block but the gauge's,
     the gated pairs' and the loop edges' cross blocks), the seconds of
     each call; (b) phase 4's main path with SPARSE_NODE_THRESHOLD patched
     to 8: the sparse gate and optimize called, phase 4's closures, every
     ATE within 0.01 m of phase 4's;
  4l. the mesh and overlap modes and the TP mega-bundle (`[mesh]` lines):
     (a) run_pipeline(mesh=make_mesh()) under drive_path's gates: its
     frontend equal bit for bit to phase 4's, phase 4's keyframes and
     closures, B6 launched at the TP shapes (every window of the scene
     overflows SlamConfig()'s capacities, so a mesh re-solves each on the
     TP path), and the window batch on the mesh (optimize_windows(mesh=),
     before the re-solve) within SLICE_TOL of phase 4's rel_T; (b) a
     4-shard mesh with chunk_frames=16 (steps of 64 and 16 frames), BA's
     batches padded to a multiple of 4; (c) overlap=True on (a)'s mesh:
     (a)'s keyframes, windows and closures, rel_T within SLICE_TOL of
     phase 4's (the overlapped stages re-solve nothing on the TP path, as
     in the JAX package), and the medians of 3 warm runs of the
     overlapped stage against (a)'s frontend + trackstore + bundles, with
     and without the TP re-solves; (d) run_bundles on
     phase 4's frontend under BundleConfig(max_landmarks=128,
     max_obs=1024) with 4 shards: windows re-solved at full size
     (num_obs > max_obs), every such rel_cov positive definite, B6 at the
     TP shapes (1, 6n, 6n) and, on the last system of its most launched
     TP shape, against its plain version, the bundles' keyframe ATE at
     most the truncated solve's x 1.1 + 0.02 m, and the difference to the
     port's emulation of the JAX package's re-solve (no depth gate,
     covariances at the initial landmarks); (e) a mega-bundle (P = 24,
     50,000 landmarks, 8 observations each, utils.synthetic.megaproblem;
     40 LM iterations, its sums in float64) on 4 shards and on
     1: poses within
     1e-4 and cost within 1e-4 relative, the cost below the initial one,
     ms per LM iteration and peak device memory, and B6 against its plain
     version on every (1, 144, 144) reduced system of a 4-shard run; (f) one BA batch of
     KITTI 00's 651 windows at full capacity: seconds and peak memory;
  5. with --profile DIR: one more warm run of the main path, and one
     each of the AKAZE, the SIFT and the ORB path, under torch.profiler;
     wall time, device busy time (union of the device events' intervals)
     and idle share of that one run, per stage and in all, and device
     time by kernel, into DIR/profile.json, profile_akaze.json,
     profile_sift.json and profile_orb.json.
The second line from the end is the kernels' JSON record (after a full
run only): per kernel its launches on the path that runs it, max abs
error against its plain version, its time, the plain version's, the
least time the card could take (bytes over 3.35 TB/s or operations over
the peak rate of their type, the larger) and one PyTorch call computing
the same function where there is one; B3's also its launches on the
SIFT path and its times at SIFT's octave shapes. The last line is the
device record. Nothing here imports JAX or any module of the JAX
package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
HW = (376, 1241)
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


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize()


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


@contextlib.contextmanager
def solving_with(ba, solve):
    """ops.ba._spd_solve replaced by ``solve`` inside the block: the
    library solve (B6's plain version) for the A/B phases, or a counter."""
    saved = ba._spd_solve
    ba._spd_solve = solve
    try:
        yield
    finally:
        ba._spd_solve = saved


LM_PHASES = ("block build", "Schur reduction", "solve", "back-substitution",
             "cost")


def lm_split(ba, se3, poses, points, cam, lm, meas, w, calib,
             runs: int = 5) -> dict:
    """One LM iteration by phase, from a torch.profiler trace of ``runs``
    iterations after a warm-up: block build (residuals, Jacobians,
    index_add_ blocks), Schur reduction (damping, landmark inverses, S and
    ghat), solve (ba._spd_solve), back-substitution (landmark steps, pose
    retraction) and cost (the trial state's cost). Each phase runs in a
    ``lm:<phase>`` range and the device is drained after it, so the
    phase's device work lies between its range's start and the next's.
    Per phase, medians over the runs: ``host_ms``, the range's host time
    (launches, and any wait inside the phase's own calls); ``busy_ms``,
    the device's busy time (union of the device events' intervals) in its
    window; ``events``, those device events; ``blocking``, the CUDA
    runtime calls named *Synchronize* inside the range. ``wall_ms`` is the
    median iteration from its first range to its end mark."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    P, L = poses.shape[1], points.shape[1]
    lam = torch.full((poses.shape[0],), 1e-4, device=poses.device)

    @contextlib.contextmanager
    def phase(name):
        with record_function(f"lm:{name}"):
            yield
        torch.cuda.synchronize()

    def iteration():
        with phase("block build"):
            J_pose, J_lm, r = ba._linearize(poses, points, cam, lm, meas, w,
                                            calib)
            blocks = ba._build_blocks(J_pose, J_lm, r, cam, lm, P, L)
        with phase("Schur reduction"):
            S, ghat, Bm, Hll_inv = ba._damped_system(blocks, lam)
        with phase("solve"):
            dp = -ba._spd_solve(S, ghat)
        with phase("back-substitution"):
            dl = ba._back_substitute(dp, Bm, Hll_inv, blocks[1])
            new_poses = se3.retract(poses, dp.reshape(-1, P, 6))
        with phase("cost"):
            ba._cost(new_poses, points + dl, cam, lm, meas, w, calib)
        with record_function("lm:end"):
            pass

    iteration()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            iteration()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("lm:")]
    merged = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    host = [e for e in events if e.device_type == DeviceType.CPU]
    marks = sorted({(e.time_range.start, e.time_range.end, e.name[3:])
                    for e in host if e.name.startswith("lm:")})
    if len(marks) != runs * (len(LM_PHASES) + 1):
        fail(f"BA split: {len(marks)} lm: ranges in the trace for {runs} "
             f"iterations of {len(LM_PHASES)} phases")
    syncs = [e.time_range.start for e in host if "Synchronize" in e.name]
    per = {n: collections.defaultdict(list) for n in LM_PHASES}
    walls = []
    t_first = None
    for (lo, hi, name), (nxt, _, _) in zip(marks, marks[1:] + [marks[-1]]):
        if name == "end":
            walls.append(lo - t_first)
            t_first = None
            continue
        t_first = lo if t_first is None else t_first
        rec = per[name]
        rec["host_ms"].append((hi - lo) * 1e-3)
        rec["busy_ms"].append(_covered(merged, lo, nxt) * 1e-3)
        rec["events"].append(sum(1 for e in dev
                                 if lo <= e.time_range.start < nxt))
        rec["blocking"].append(sum(1 for t in syncs if lo <= t < hi))
    out = {n: {k: float(np.median(v)) for k, v in rec.items()}
           for n, rec in per.items()}
    out["wall_ms"] = float(np.median(walls)) * 1e-3
    return out


def _merge(iv):
    """Union of [start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, lo, hi) -> float:
    """Length of the merged intervals inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def profile_path(pipeline, L, R, calib, cfg, out_dir, card,
                 tag: str = "") -> None:
    """One more warm run of a path under torch.profiler. From that
    run alone: its wall time, the device's busy time (the union of the
    device events' intervals, so overlapping kernels count once), the
    idle share, the same per pipeline stage (device busy inside the
    stage's host span), and device time by kernel name. Host overhead of
    the profiler lengthens this run, so its idle share is an upper bound
    for an unprofiled run. Written to out_dir/profile{tag}.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False,
                                    device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    # kernels and copies; the stage spans also appear on the device
    # timeline (as user annotations) and are no device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("stage:")]
    if not dev:
        fail("the profiler recorded no device events")
    merged = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = _covered(merged, -float("inf"), float("inf"))
    host = [e for e in events if e.device_type == DeviceType.CPU]
    stage_spans = {e.name[len("stage:"):]: (e.time_range.start,
                                            e.time_range.end)
                   for e in host if e.name.startswith("stage:")}
    run_lo = min(a for a, _ in stage_spans.values())
    run_hi = max(b for _, b in stage_spans.values())
    stages = {}
    for name, (lo, hi) in stage_spans.items():
        b = _covered(merged, lo, hi)
        stages[name] = {"host_s": (hi - lo) * 1e-6, "device_busy_s": b * 1e-6,
                        "idle_share": 1.0 - b / max(hi - lo, 1e-9)}
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    report = {
        "card": card, "torch": torch.__version__,
        "wall_s": wall_s, "stages_span_s": (run_hi - run_lo) * 1e-6,
        "device_events": len(dev), "device_busy_s": busy_us * 1e-6,
        "device_sum_s": sum(us for _, us in by_name.values()) * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall_s,
        "stage_timings_s": res.timings, "stages": stages,
        "kernels": [{"name": n, "count": c, "ms": us * 1e-3}
                    for n, (c, us) in top[:40]],
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"profile{tag}.json"
    path.write_text(json.dumps(report, indent=1))
    log(f"[profile{tag}] one profiled run: wall {wall_s:.3f} s, device busy "
        f"{busy_us * 1e-6:.4f} s over {len(dev)} device events, idle share "
        f"{report['idle_share']:.3f} ({card})")
    for name, st in stages.items():
        log(f"[profile{tag}] stage {name}: host {st['host_s']:.3f} s, "
            f"device busy {st['device_busy_s']:.4f} s, idle share "
            f"{st['idle_share']:.3f}")
    for n, (c, us) in top[:12]:
        log(f"[profile{tag}] {us * 1e-3:9.3f} ms  x{c:<6d} {n[:90]}")
    log(f"[profile{tag}] written to {path}")


def drive_path(pipeline, ck, L, R, scene, cfg, required, tag, card,
               on_reset=None, plain_ok=(), **run_kw):
    """run_pipeline + evaluate under ``cfg`` (and ``run_kw``, a mesh) on
    the card: a warm-up pass
    (cuDNN / cuBLAS / cuSOLVER handles, allocator), then the measured pass
    with the launch counters zeroed just before it (``on_reset`` is called
    there too) and read just after. Fails unless every kernel in
    ``required`` launched, no plain version ran (but those of
    ``plain_ok``, which the caller put in on purpose), the trajectory is
    finite, at least one loop closed and every stage's ATE is under 1 m.
    Returns the measured pass's launches, plain calls, ATEs, closure frame
    pairs, stage timings and number of BA windows."""
    pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                          device="cuda", **run_kw)
    torch.cuda.synchronize()
    ck.reset_counters()
    if on_reset is not None:
        on_reset()
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                device="cuda", **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    plain = dict(ck.PLAIN_CALLS)
    report = pipeline.evaluate(res, scene.T_w2c)
    if any(launches[k] == 0 for k in required):
        fail(f"{tag}: a kernel of the path was not launched: {launches}")
    if any(n for k, n in plain.items() if k not in plain_ok):
        fail(f"{tag}: a plain version ran during the CUDA path: {plain}")
    n_frames = L.shape[0]
    if res.T_frontend.shape != (n_frames, 4, 4) or not np.isfinite(
            res.T_frontend).all():
        fail(f"{tag}: frontend trajectory malformed")
    ates = {k: report[k]["ate_rmse_m"]
            for k in ("frontend", "bundles_kf", "pose_graph_kf",
                      "pose_graph_lc_kf") if k in report}
    for k, v in ates.items():
        if not (np.isfinite(v) and v < 1.0):
            fail(f"{tag}: ATE {k} = {v} m (limit 1.0 m)")
    if report["num_closures"] < 1:
        fail(f"{tag}: no loop closure found on the loop scene")
    t = res.timings
    rate = (f"; frontend {n_frames / t['frontend']:.1f} frames/s"
            if "frontend" in t else "")
    log(f"[{tag}] {n_frames} frames {HW}: wall {wall:.2f} s, stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
        + f"{rate} ({card})")
    log(f"[{tag}] closures "
        f"{[(c.frame_i, c.frame_j, c.num_inliers) for c in res.closures]}"
        f"; ATE m {json.dumps(ates)}; pose failures "
        f"{report['num_pose_failures']}; launches {launches} ({card})")
    return {"launches": launches, "plain": plain, "ates": ates, "timings": t,
            "closures": [(c.frame_i, c.frame_j) for c in res.closures],
            "windows": res.bundles.poses.shape[0], "result": res}


def u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def kitti_paths(kitti, root, seq, left, right, calib, T_w2c):
    """A sequence written in KITTI's layout: (left paths, right paths,
    calibration and poses read back from the files)."""
    paths = kitti.write_kitti_sequence(root, seq, u8(left), u8(right), calib,
                                       T_w2c)
    lp = sorted(str(p) for p in paths.left_dir.glob("*.png"))
    rp = sorted(str(p) for p in paths.right_dir.glob("*.png"))
    return lp, rp, kitti.calib_vector(paths), kitti.read_ground_truth(paths)


FRONTEND_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev",
                   "match_dist", "inlier_prev", "T_rel", "T_w2c",
                   "num_inliers", "inlier_frac", "pose_ok")


def same_frontend(a, b, label: str, frames=None) -> None:
    """Every per-frame array of two frontend results equal bit for bit,
    and the descriptors of ``frames`` (all by default)."""
    for k in FRONTEND_ARRAYS:
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            fail(f"{label}: {k} differs")
    idx = np.arange(len(a.xy)) if frames is None else frames
    if not torch.equal(a.desc.gather(idx), b.desc.gather(idx)):
        fail(f"{label}: descriptors differ")


# optimize_windows in slices of 4 against one slice of 16: each window's LM
# is independent of the others in its slice, so they differ as two runs of
# the same call do, by the order index_add_ sums in: up to ~2e-5 in a pose
# entry and in a relative cost on the scene's windows (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6); the limits are ~10x that
SLICE_TOL = {"poses": 2e-4, "cost": 1e-4}


def disk_phase(pipeline, ck, L, R, scene, cfg, batch, card, tmp) -> dict:
    """Phase 4f, the disk path (see the module docstring). Returns run (a)'s
    closure frame pairs and ATEs."""
    import dataclasses

    from slam_tpu_torch import runtime
    from slam_tpu_torch.config import RuntimeConfig
    from slam_tpu_torch.models import bundle, frontend
    from slam_tpu_torch.parallel import pipeline as ppipe
    from slam_tpu_torch.utils import kitti, metrics, synthetic

    t0 = time.perf_counter()
    lp, rp, calib, T_gt = kitti_paths(kitti, tmp / "kitti", "00", L, R,
                                      scene.calib, scene.T_w2c)
    write_s = time.perf_counter() - t0
    decoder = ppipe.PngFrames(lp, rp, HW).decoder
    if not runtime.available():
        fail(f"disk: the native runtime did not build: {runtime.build_error}")
    n = len(lp)
    log(f"[disk] wrote {n} stereo pairs {HW} as PNG in {write_s:.2f} s; "
        f"decoder {decoder} ({card})")
    # host costs of the disk path, on this machine's CPU: one frame's
    # decode by the port's decoder and by cv2, and a checkpoint segment of
    # the 80 frames written plain (as the port does) and compressed
    import cv2
    frame = torch.empty(HW, dtype=torch.uint8)
    dec = {"native": lambda: runtime.load_png_u8_padded(lp[0], HW, out=frame),
           "cv2": lambda: cv2.imread(lp[0], cv2.IMREAD_GRAYSCALE)}
    dec_ms = {}
    for name, fn in dec.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        dec_ms[name] = (time.perf_counter() - t0) / 20 * 1e3

    # (a) run_pipeline from the path lists, cold stage cache
    cache = tmp / "cache"
    ck.reset_counters()
    t0 = time.perf_counter()
    r1 = pipeline.run_pipeline(lp, rp, calib, cfg, cache_dir=cache,
                               verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    if any(launches[k] == 0 for k in ("detect_maps", "mutual_nearest",
                                      "cholesky_solve")):
        fail(f"disk (a): a kernel of the path was not launched: {launches}")
    if any(plain.values()):
        fail(f"disk (a): a plain version ran: {plain}")
    report = pipeline.evaluate(r1, T_gt)
    ates = {k: report[k]["ate_rmse_m"] for k in
            ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")
            if k in report}
    if report["num_closures"] < 1 or not all(
            np.isfinite(v) and v < 1.0 for v in ates.values()):
        fail(f"disk (a): closures {report['num_closures']}, ATE m {ates}")
    seg = {k: getattr(r1.frontend, k) for k in FRONTEND_ARRAYS}
    save_s = {}
    for name, save in (("plain", np.savez),
                       ("compressed", np.savez_compressed)):
        t0 = time.perf_counter()
        save(str(tmp / f"seg_{name}.npz"), **seg)
        save_s[name] = (time.perf_counter() - t0,
                        (tmp / f"seg_{name}.npz").stat().st_size / 1e6)
    log(f"[disk] host: decode of one frame {HW} native {dec_ms['native']:.2f}"
        f" ms, cv2 {dec_ms['cv2']:.2f} ms (mean of 20); {n} frames' "
        f"checkpoint arrays written plain in {save_s['plain'][0]:.3f} s "
        f"({save_s['plain'][1]:.1f} MB), compressed in "
        f"{save_s['compressed'][0]:.3f} s ({save_s['compressed'][1]:.1f} MB)"
        f"; {ppipe.default_io_threads()} decode threads of "
        f"{os.cpu_count()} cores ({card})")
    t = r1.timings
    log(f"[disk] (a) run_pipeline from {n} PNG pairs, cold cache: wall "
        f"{wall:.2f} s, stages " + ", ".join(f"{k} {v:.3f} s"
                                            for k, v in t.items())
        + f"; frontend {n / t['frontend']:.1f} frames/s; closures "
        f"{[(c.frame_i, c.frame_j) for c in r1.closures]}; ATE m "
        f"{json.dumps(ates)}; launches {launches} ({card})")

    # (b) the same call again: every stage from the cache
    ck.reset_counters()
    t0 = time.perf_counter()
    r2 = pipeline.run_pipeline(lp, rp, calib, cfg, cache_dir=cache,
                               verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    if any(ck.LAUNCHES.values()) or any(ck.PLAIN_CALLS.values()):
        fail(f"disk (b): work ran on a full cache: {ck.LAUNCHES}")
    if [(c.frame_i, c.frame_j) for c in r2.closures] != [
            (c.frame_i, c.frame_j) for c in r1.closures]:
        fail("disk (b): other closures from the cache")
    for get in (lambda r: r.T_frontend, lambda r: r.bundles.T_w2c_keyframes,
                lambda r: r.pose_graph_pre_lc.nodes,
                lambda r: r.keyframe_trajectory()):
        if not np.array_equal(get(r1), get(r2)):
            fail("disk (b): trajectories from the cache differ")
    log(f"[disk] (b) second call, every stage from the cache: wall "
        f"{wall:.3f} s, stages " + ", ".join(f"{k} {v:.4f} s"
                                             for k, v in r2.timings.items())
        + f"; no kernel launched; same closures and trajectories ({card})")

    # (c) stop after 48 frames, resume, against an uninterrupted run
    cfg16 = dataclasses.replace(cfg, runtime=RuntimeConfig(chunk_frames=16))

    def from_pngs(m, **kw):
        return ppipe.run_frontend_pipelined(lp[:m], rp[:m], HW, calib, cfg16,
                                            device="cuda", **kw)

    full = from_pngs(n)
    ckpt = str(tmp / "fe_ckpt.npz")
    from_pngs(48, checkpoint_path=ckpt, checkpoint_every=16)
    t0 = time.perf_counter()
    resumed = from_pngs(n, checkpoint_path=ckpt, checkpoint_every=16,
                        resume=True)
    resume_s = time.perf_counter() - t0
    same_frontend(resumed, full, "disk (c) resumed", np.arange(48, n))
    ck.reset_counters()
    t0 = time.perf_counter()
    rec = resumed.desc.gather(np.arange(48))
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    if not torch.equal(rec, full.desc.gather(np.arange(48))):
        fail("disk (c): recomputed descriptors differ from the originals")
    log(f"[disk] (c) frontend from PNGs (chunks of 16) stopped after 48 "
        f"frames and resumed in {resume_s:.3f} s: every array equal to an "
        f"uninterrupted run; the 3 resumed chunks' descriptors recomputed "
        f"from the PNGs in {rec_s:.3f} s ({ck.LAUNCHES['detect_maps']} B1 "
        f"launches), equal bit for bit ({card})")

    # (d) the overlapped run_frontend against a plain sequential loop
    chunk = cfg.runtime.chunk_frames
    calib_t = torch.from_numpy(scene.calib).cuda()
    carry, T_carry, T_all, parts, descs = None, np.eye(4, dtype=np.float32), \
        [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ci, s in enumerate(range(0, len(L), chunk)):
        m = min(chunk, len(L) - s)
        blk = [np.zeros((chunk,) + HW, np.float32) for _ in range(2)]
        blk[0][:m], blk[1][:m] = L[s:s + m], R[s:s + m]
        out, carry = frontend.process_chunk(
            torch.from_numpy(blk[0]).cuda(), torch.from_numpy(blk[1]).cuda(),
            carry, calib_t, cfg,
            generator=frontend.chunk_generator(cfg, ci, "cuda"))
        descs.append(out.pop("desc")[:m])
        host = {k: v[:m].cpu().numpy() for k, v in out.items()}
        T_all.append(host["T_chain"] @ T_carry[None])
        T_carry = T_all[-1][-1]
        parts.append(host)
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = frontend.run_frontend(L, R, scene.calib, cfg, device="cuda")
    torch.cuda.synchronize()
    ovl_s = time.perf_counter() - t0
    T_rel = np.concatenate([p["T_rel"] for p in parts])
    T_rel[0] = np.eye(4, dtype=np.float32)
    seq = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    seq.update(T_rel=T_rel, T_w2c=np.concatenate(T_all))
    for k in FRONTEND_ARRAYS:
        if not np.array_equal(seq[k], getattr(fe, k)):
            fail(f"disk (d): run_frontend's {k} differs from the sequential "
                 f"loop's")
    if not torch.equal(torch.cat(descs), fe.desc[:]):
        fail("disk (d): run_frontend's descriptors differ")
    log(f"[disk] (d) run_frontend, uploads and read-backs overlapped: "
        f"{ovl_s:.3f} s ({len(L) / ovl_s:.1f} frames/s) against a plain "
        f"sequential loop's {seq_s:.3f} s ({len(L) / seq_s:.1f} frames/s), "
        f"every array and descriptor equal bit for bit ({card})")

    # (e) optimize_windows: 4 pipelined slices of 4 against 1 slice of 16
    runs = {}
    for tag, db in (("16 a", 16), ("16 b", 16), ("4", 4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[tag] = bundle.optimize_windows(batch, scene.calib, cfg.bundle,
                                            device_batch=db, device="cuda")
        runs[tag + " s"] = time.perf_counter() - t0

    def diff(a, b):
        return {"poses": float(np.abs(a.poses - b.poses).max()),
                "cost": float((np.abs(a.cost - b.cost)
                               / np.maximum(np.abs(b.cost), 1.0)).max())}

    spread, d4 = diff(runs["16 a"], runs["16 b"]), diff(runs["4"],
                                                        runs["16 a"])
    if any(not np.isfinite(v) or v > SLICE_TOL[k] for k, v in d4.items()):
        fail(f"disk (e): device_batch 4 vs 16 {d4} (limits {SLICE_TOL})")
    log(f"[disk] (e) optimize_windows on the scene's {batch.num_windows} "
        f"windows: 4 slices of 4 in {runs['4 s']:.3f} s, 1 slice of 16 in "
        f"{runs['16 a s']:.3f} / {runs['16 b s']:.3f} s; max |pose diff| and "
        f"relative cost diff 4 vs 16 {json.dumps(d4)}, 16 vs 16 (two runs) "
        f"{json.dumps(spread)}, limits {json.dumps(SLICE_TOL)} ({card})")

    # (f) a 370 x 1226 sequence (KITTI 04-12) through the shared bucket
    hw2 = (370, 1226)
    bucket = kitti.bucket_for([HW, hw2])
    sc2 = synthetic.make_scene(seed=SEED + 1, num_frames=16,
                               num_landmarks=4000, trajectory="straight",
                               hw=hw2)
    L2, R2 = synthetic.render_sequence(sc2)
    lp2, rp2, calib2, T_gt2 = kitti_paths(kitti, tmp / "kitti", "04", L2,
                                          R2, sc2.calib, sc2.T_w2c)
    ck.reset_counters()
    r3 = pipeline.run_pipeline(lp2, rp2, calib2, cfg, image_hw=bucket,
                               run_loop_closure=False, verbose=False,
                               device="cuda")
    ate = metrics.trajectory_summary(r3.T_frontend, T_gt2)["ate_rmse_m"]
    frame0 = torch.zeros(bucket, dtype=torch.uint8)
    ppipe.PngFrames(lp2, rp2, bucket).decode(lp2[0], frame0)
    padded = kitti.pad_to_bucket(u8(L2[:1]), bucket)[0]
    if not (np.isfinite(r3.T_frontend).all() and ate < 1.0
            and ck.LAUNCHES["detect_maps"] > 0
            and np.array_equal(frame0.numpy(), padded)):
        fail(f"disk (f): {hw2} in bucket {bucket}: ATE {ate} m, launches "
             f"{ck.LAUNCHES}, padded decode equal "
             f"{np.array_equal(frame0.numpy(), padded)}")
    log(f"[disk] (f) 16 frames {hw2} through bucket {bucket}: stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in r3.timings.items())
        + f"; frontend ATE {ate:.4f} m; decoded frames equal pad_to_bucket "
        f"of the written ones ({card})")
    return {"closures": [(c.frame_i, c.frame_j) for c in r1.closures],
            "ates": ates}


REPO = Path(__file__).resolve().parent
STAGE_ATES = ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")


def run_module(args, label: str, env=None, timeout: int = 600):
    """``python3 -m <args>`` from the repository's root, as a user runs it;
    (completed process, wall seconds)."""
    env = dict(os.environ if env is None else env, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def require_rc0(proc, label: str) -> None:
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")


def stage_ates(report: dict, label: str) -> dict:
    """Every stage's ATE of an evaluate() report; fails unless each is
    finite and under 1 m."""
    ates = {k: report[k]["ate_rmse_m"] for k in STAGE_ATES if k in report}
    if not ates or not all(np.isfinite(v) and v < 1.0 for v in ates.values()):
        fail(f"{label}: ATE m {ates} (limit 1.0 m)")
    return ates


def cli_phase(pipeline, ck, main_res, scene, L, disk, cfg, card, tmp) -> None:
    """Phase 4g, the CLI on the card (see the module docstring)."""
    import importlib.util

    from slam_tpu_torch.models import loop_closure
    from slam_tpu_torch.utils import analysis, kitti

    drawn = importlib.util.find_spec("matplotlib") is not None
    root, out = tmp / "kitti", tmp / "cli"
    proc, wall = run_module(["slam_tpu_torch", "--kitti-root", str(root),
                             "--seq", "00", "--out", str(out)], "cli")
    require_rc0(proc, "cli (KITTI)")
    seq = out / "00"
    report = json.loads((seq / "report.json").read_text())
    ates = stage_ates(report, "cli (KITTI)")
    closures = [(c.frame_i, c.frame_j) for c in
                loop_closure.load_closures(seq / "cache" / "closures.npz")]
    if closures != disk["closures"] or report["num_closures"] != len(closures):
        fail(f"cli (KITTI): closures {closures} ({report['num_closures']} in "
             f"report.json), phase 4f {disk['closures']}")
    # the CLI pads every sequence to its image bucket (376, 1248): the same
    # call in this process is what its numbers must equal
    paths = kitti.KittiPaths(root=root, sequence="00")
    lp = sorted(str(p) for p in paths.left_dir.glob("*.png"))
    rp = sorted(str(p) for p in paths.right_dir.glob("*.png"))
    bucket = kitti.bucket_for([HW])
    same = pipeline.evaluate(pipeline.run_pipeline(
        lp, rp, kitti.calib_vector(paths), cfg, image_hw=bucket,
        verbose=False, device="cuda"), kitti.read_ground_truth(paths))
    d_ate = {k: abs(v - same[k]["ate_rmse_m"]) for k, v in ates.items()}
    d_4f = {k: abs(v - disk["ates"][k]) for k, v in ates.items()}
    if set(ates) != set(disk["ates"]) or max(d_ate.values()) > 0.01:
        fail(f"cli (KITTI): ATE {ates} vs run_pipeline in this process "
             f"{ {k: same[k]['ate_rmse_m'] for k in ates} } (limit 0.01 m "
             f"apart)")
    an = json.loads((seq / "graphs" / "analysis.json").read_text())
    want = [a for a in analysis.ARTIFACTS
            if closures or "poseGraph_LC" not in a]
    missing = [a for a in want if not an["artifacts"].get(a, {}).get("series")]
    pngs = sorted(p.name for p in (seq / "graphs").glob("*.png"))
    if missing or (drawn and any(f"{a}.png" not in pngs for a in want)) or (
            not drawn and (pngs or an["plots"] != analysis.NO_MATPLOTLIB)):
        fail(f"cli (KITTI): analysis artifacts without numbers {missing}, "
             f"PNGs {pngs}, plots {an['plots']!r}")
    log(f"[cli] python3 -m slam_tpu_torch --kitti-root <4f's> --seq 00: rc 0 "
        f"in {wall:.1f} s; closures {closures} as in phase 4f; ATE m "
        f"{json.dumps(ates)}, within {max(d_ate.values()):.2e} m of "
        f"run_pipeline at bucket {bucket} in this process and "
        f"{max(d_4f.values()):.4f} m of phase 4f's (376, 1241) run; analysis: "
        f"{len(want)} artifacts with numbers, {len(pngs)} PNGs, plots "
        f"{an['plots']!r} ({card})")

    proc, wall = run_module(["slam_tpu_torch", "--synthetic", "loop",
                             "--frames", "80", "--out", str(tmp / "syn")],
                            "cli synthetic")
    require_rc0(proc, "cli (synthetic)")
    report = json.loads((tmp / "syn" / "synthetic" / "report.json")
                        .read_text())
    ates = stage_ates(report, "cli (synthetic)")
    if report["num_closures"] < 1:
        fail("cli (synthetic): no loop closure on the loop scene")
    log(f"[cli] python3 -m slam_tpu_torch --synthetic loop --frames 80: rc 0 "
        f"in {wall:.1f} s; {report['num_closures']} closure(s); ATE m "
        f"{json.dumps(ates)}; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in report["timings_s"].items())
        + f" ({card})")

    # the analysis in this process, on phase 4's result: B2 once per closure
    ck.reset_counters()
    t0 = time.perf_counter()
    an = analysis.run_analysis(main_res, scene.T_w2c, tmp / "analysis",
                               images_left=L)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_cl = len(main_res.closures)
    launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    if launches["mutual_nearest"] != n_cl or any(plain.values()):
        fail(f"analysis: launches {launches} for {n_cl} closure(s), plain "
             f"calls {plain}")
    log(f"[cli] analysis.run_analysis on phase 4's result in {wall:.2f} s: "
        f"launches {launches} ({n_cl} closure(s): B2 once each), no plain "
        f"call; loop matches {json.dumps(an.get('loop_match'))} ({card})")

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc, _ = run_module(["slam_tpu_torch", "--synthetic", "loop", "--frames",
                          "8", "--out", str(tmp / "nocard")], "cli no card",
                         env=env)
    if proc.returncode == 0 or "no CUDA card" not in proc.stderr:
        fail(f"cli without a card: exit {proc.returncode}, stderr "
             f"{proc.stderr[-500:]!r}")
    log(f"[cli] without a card (CUDA_VISIBLE_DEVICES=''): exit "
        f"{proc.returncode}, '{proc.stderr.strip().splitlines()[-1]}'")


# phase 4h: the clover at reduced depth and full width. 336 frames at ~1 m
# a frame drive four laps of radii 10-16 m, each back through the origin
SCALE_ARGS = ("--frames", "336", "--radii", "10", "13", "16", "14.5",
              "--landmarks", "12000", "--corridor", "6")


def scale_phase(card, tmp) -> None:
    """Phase 4h, the scale run (see the module docstring)."""
    out = tmp / "scale"
    proc, wall = run_module(["slam_tpu_torch.scale_run", *SCALE_ARGS,
                             "--out", str(out)], "scale run")
    require_rc0(proc, "scale run")
    report = json.loads((out / "report.json").read_text())
    ates = stage_ates(report, "scale run")
    if report["num_closures"] < 1:
        fail(f"scale run: no closure; revisits {report['revisits']}")
    log(f"[scale] python3 -m slam_tpu_torch.scale_run {' '.join(SCALE_ARGS)} "
        f"{tuple(HW)}: rc 0 in {wall:.1f} s; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in report["timings_s"].items())
        + f"; {report['num_keyframes']} keyframes, {report['num_closures']} "
        f"closure(s), per revisit event {json.dumps(report['revisits'])}; "
        f"ATE m {json.dumps(ates)}; pose failures "
        f"{report['num_pose_failures']} ({card})")
    proc, wall = run_module(["slam_tpu_torch.scale_run", *SCALE_ARGS,
                             "--out", str(out)], "scale run again")
    require_rc0(proc, "scale run again")
    again = json.loads((out / "report.json").read_text())
    if again["stages_run"] or again["timings_s"] != report["timings_s"]:
        fail(f"scale run again: stages run {again['stages_run']}")
    if stage_ates(again, "scale run again") != ates:
        fail("scale run again: other ATEs from the artifacts")
    log(f"[scale] second invocation: every stage loaded from its artifacts "
        f"in {wall:.1f} s, the same ATEs ({card})")


def detector_phase(pipeline, ck, frontend, L, R, scene, cfg, required, tag,
                   card) -> dict:
    """Phases 4i and 4j: the path under ``cfg`` (drive_path's gates), the
    frontend's peak device memory (one more run_frontend, the peak reset
    just before it), and the first chunk's descriptors recomputed
    (DescriptorBank's resume path) equal bit for bit to that run's."""
    path = drive_path(pipeline, ck, L, R, scene, cfg, required, tag, card)
    chunk = cfg.runtime.chunk_frames
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fe = frontend.run_frontend(L, R, scene.calib, cfg, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    first = np.arange(chunk)
    rec = frontend.recompute_descriptors(
        torch.from_numpy(L[:chunk]).cuda(), torch.from_numpy(R[:chunk]).cuda(),
        cfg)
    if not torch.equal(rec, fe.desc.gather(first)):
        fail(f"{tag}: recomputed descriptors of chunk 0 differ from the run's")
    log(f"[{tag}] frontend peak device memory {peak / 2**30:.2f} GiB "
        f"(allocated before it {base / 2**30:.2f} GiB; detection of "
        f"{2 * chunk} images {HW} at once); chunk 0's descriptors recomputed "
        f"equal bit for bit ({card})")
    return dict(path, peak_gib=peak / 2**30)


# phase 4k: the sparse pose graph at 2560 keyframes (> SPARSE_NODE_THRESHOLD)
PG_NODES = 2560
PG_LOOPS = ((100, 2000), (500, 2400))


def stiff_loop_graph(N: int, device: str, loops=PG_LOOPS, seed: int = 0):
    """A port PoseGraph of N keyframes: a ~2 m-step odometry chain with
    gentle yaw noise and reference-scale stiff sqrt-information (5e3
    rotation, 1.5e2 translation rows), built on the host in float64; a loop
    edge (2, N - 2) whose measurement disagrees with the chain by 0.5 m;
    and one loop edge per pair of ``loops`` off by 0.05 m. The same
    construction as the JAX package's tests (make_stiff_loop_graph,
    add_loops; tests/test_torch_pg_sparse.py holds the two equal)."""
    from slam_tpu_torch.models.pose_graph import PoseGraph

    rng = np.random.default_rng(seed)
    nodes = np.zeros((N, 4, 4))
    nodes[0] = np.eye(4)
    Z = np.zeros((N - 1, 4, 4))
    for i, yaw in enumerate(0.002 * rng.standard_normal(N - 1)):
        c, s_ = np.cos(yaw), np.sin(yaw)
        Z[i] = [[c, 0.0, s_, 0.0], [0.0, 1.0, 0.0, 0.0], [-s_, 0.0, c, 2.0],
                [0.0, 0.0, 0.0, 1.0]]
        nodes[i + 1] = Z[i] @ nodes[i]
    si = np.eye(6, dtype=np.float32)
    si[:3, :3] *= 5e3
    si[3:, 3:] *= 1.5e2
    pg = PoseGraph(nodes=nodes.astype(np.float32), keyframes=list(range(N)),
                   e_i=np.arange(N - 1, dtype=np.int32),
                   e_j=np.arange(1, N, dtype=np.int32),
                   Z=Z.astype(np.float32),
                   sqrt_info=np.tile(si, (N - 1, 1, 1)),
                   is_loop=np.zeros(N - 1, bool), device=device)
    i, j = 2, N - 2
    T_mis = np.eye(4)
    T_mis[0, 3] = 0.5
    rel = (pg.nodes[j].astype(np.float64)
           @ np.linalg.inv(pg.nodes[i].astype(np.float64)))
    pg.add_edge(i, j, (rel @ T_mis).astype(np.float32), np.eye(6) * 1e-4)
    for i, j in loops:
        rel = pg.nodes[j] @ np.linalg.inv(pg.nodes[i])
        T_mis = np.eye(4, dtype=np.float32)
        T_mis[0, 3] = 0.05
        pg.add_edge(i, j, rel @ T_mis, np.eye(6) * 1e-4)
    return pg


def dense_cov64(pg_sparse, args):
    """The dense float64 inverse of the sparse path's whitened Hessian
    (the same Jacobians, the chain and the loop edges assembled into
    (6N, 6N), the gauge rows the identity), Jacobi-scaled for the
    inversion, refined by one Newton step X += X (I - H X), unscaled
    after, the gauge rows zeroed: (N, 6, N, 6), and the step's largest
    change relative to max |X|."""
    nodes, Z_c, si_c, li, lj, Z_l, si_l, lv, n = args
    X, Zc_inv, si_c, Zl_inv, si_l, v = pg_sparse._inputs64(
        nodes, Z_c, si_c, Z_l, si_l, lv)
    N = X.shape[0]
    m, _ = pg_sparse._node_masks(N, n, X)
    _, Ji, Jj = pg_sparse._chain_jacobians(X, Zc_inv, si_c, m)
    _, Jil, Jjl = pg_sparse._loop_jacobians(X, li, lj, Zl_inv, si_l, v, m)
    k = torch.arange(N - 1, device=X.device)
    H = torch.zeros((N, N, 6, 6), dtype=X.dtype, device=X.device)
    for a, b, Ja, Jb in ((k, k + 1, Ji, Jj), (li, lj, Jil, Jjl)):
        for r, c, Jr, Jc in ((a, a, Ja, Ja), (b, b, Jb, Jb), (a, b, Ja, Jb),
                             (b, a, Jb, Ja)):
            H.index_put_((r, c), Jr.transpose(1, 2) @ Jc, accumulate=True)
    H = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    mask = m.repeat_interleave(6)
    H = H + torch.diag(1.0 - mask)
    s = torch.rsqrt(torch.diagonal(H))
    H = H * s[:, None] * s[None, :]
    C = torch.linalg.inv(H)
    R = -(H @ C)
    R.diagonal().add_(1.0)
    D = C @ R
    step = float(D.abs().max() / C.abs().max())
    C += D
    del R, D
    C = C * (s * mask)[:, None] * (s * mask)[None, :]
    return C.reshape(N, 6, N, 6), step


def sparse_pg_phase(pipeline, ck, L, R, scene, cfg, main_path, card) -> dict:
    """Phase 4k (see the module docstring). Returns the seconds of each
    call at PG_NODES."""
    from slam_tpu_torch.models import pose_graph
    from slam_tpu_torch.ops import pg_sparse

    N = PG_NODES
    pg = stiff_loop_graph(N, "cuda")
    if not pg._use_sparse():
        fail(f"pg sparse: {N} nodes under SPARSE_NODE_THRESHOLD")
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    before = pg.nodes.copy()
    cost = timed("optimize", lambda: pg.optimize(iters=15))
    shift = float(np.abs(pg.nodes[:, :3, 3] - before[:, :3, 3]).max())
    if not (np.isfinite(cost) and shift > 0.05):
        fail(f"pg sparse: optimize cost {cost}, largest node shift {shift} m")
    pi = np.arange(0, N - 500, 17)
    pj = pi + 499
    d = timed("gate", lambda: pg.gate_distances(pi, pj))
    if not (np.isfinite(d).all() and (d > 0).all()):
        fail(f"pg sparse: gate distances {d[~(np.isfinite(d) & (d > 0))]}")
    loc, rot = timed("logdets", pg.marginal_logdets)
    if not (loc.shape == (N,) and np.isfinite(loc).all()
            and np.median(loc[-200:]) > np.median(loc[1:201])):
        fail(f"pg sparse: log-dets {loc[:3]} ... {loc[-3:]}")
    # selected blocks against the dense float64 inverse on the card: every
    # diagonal block but the gauge's (zero in both), the cross blocks of
    # the gated pairs (both orders) and of the loop edges
    args = pg._sparse_arrays()
    a, b = pi[pi > 0], pj[pi > 0]
    qi = torch.as_tensor(np.concatenate([a, b, [2, 100, 500]]),
                         device="cuda")
    qj = torch.as_tensor(np.concatenate([b, a, [N - 2, 2000, 2400]]),
                         device="cuda")
    Cdiag, Cq = timed("selected blocks", lambda: pg_sparse.selected_blocks(
        *args, qi, qj))
    C, step = timed("dense float64 inverse", lambda: dense_cov64(pg_sparse,
                                                                 args))
    k = torch.arange(1, N, device="cuda")
    pairs = ((Cdiag[1:].double(), C[k, :, k, :]),
             (Cq.double(), C[qi, :, qj, :]))
    err = max(float(((a - b).abs().amax((1, 2))
                     / b.abs().amax((1, 2))).max()) for a, b in pairs)
    del C
    if not err <= 1e-5:
        fail(f"pg sparse: selected blocks {err:.3e} off the dense float64 "
             f"inverse, relative to each block's largest entry (limit 1e-5)")
    log(f"[pg sparse] {N} nodes, {int(pg.is_loop.sum())} loop edges: "
        f"optimize(iters=15) {secs['optimize']:.3f} s "
        f"({secs['optimize'] / 15:.3f} s per LM iteration), cost {cost:.4f}, "
        f"largest node shift {shift:.3f} m; gate_distances of {pi.size} pairs "
        f"{secs['gate']:.3f} s; marginal_logdets {secs['logdets']:.3f} s "
        f"(median log det loc nodes 1-200 {np.median(loc[1:201]):.2f}, last "
        f"200 {np.median(loc[-200:]):.2f}); selected_blocks "
        f"{secs['selected blocks']:.3f} s, {N - 1} diagonal and {qi.numel()} "
        f"cross blocks within {err:.2e} of the dense float64 inverse "
        f"({secs['dense float64 inverse']:.3f} s, one Newton step changed it "
        f"by {step:.1e} of its largest entry) relative to each block's "
        f"largest entry ({card})")

    # (b) the main path with every pose-graph query on the sparse path
    calls = collections.Counter()
    saved = {n: getattr(pg_sparse, n) for n in (
        "optimize_sparse", "gate_matrix_sparse", "marginal_logdets_sparse")}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return call

    threshold = pose_graph.SPARSE_NODE_THRESHOLD
    pose_graph.SPARSE_NODE_THRESHOLD = 8
    for n in saved:
        setattr(pg_sparse, n, counted(n))
    try:
        sp = drive_path(pipeline, ck, L, R, scene, cfg,
                        ("detect_maps", "mutual_nearest", "cholesky_solve"),
                        "pg sparse", card, on_reset=calls.clear)
    finally:
        pose_graph.SPARSE_NODE_THRESHOLD = threshold
        for n, fn in saved.items():
            setattr(pg_sparse, n, fn)
    if not calls["gate_matrix_sparse"] or not calls["optimize_sparse"]:
        fail(f"pg sparse (b): sparse calls {dict(calls)}")
    if sp["closures"] != main_path["closures"]:
        fail(f"pg sparse (b): closures {sp['closures']}, phase 4 "
             f"{main_path['closures']}")
    d_ate = {k: abs(sp["ates"][k] - v) for k, v in main_path["ates"].items()}
    if set(sp["ates"]) != set(main_path["ates"]) or max(d_ate.values()) > 0.01:
        fail(f"pg sparse (b): ATE {sp['ates']} vs phase 4 {main_path['ates']}"
             f" (limit 0.01 m apart)")
    log(f"[pg sparse] (b) the main path with SPARSE_NODE_THRESHOLD = 8: "
        f"sparse calls {dict(calls)}; closures {sp['closures']} as in phase "
        f"4; ATE differences {json.dumps(d_ate)} m ({card})")
    return secs


# phase 4l: the mesh and overlap modes and the TP mega-bundle. (d) cuts
# the windows' capacities so that the scene's windows overflow; (e) is a
# mega-bundle of tests/test_tp_megabundle.py's construction at P = 24
TIGHT = {"max_landmarks": 128, "max_obs": 1024}
MEGA = {"P": 24, "L": 50_000, "obs_per_lm": 8, "iters": 40}
KITTI00_WINDOWS = 651


def mesh_phase(pipeline, ck, ba, bundle, L, R, scene, cfg, main_path,
               card) -> dict:
    """Phase 4l: (a) run_pipeline on a 1-shard mesh, (b) on 4 shards with
    chunk_frames=16, (c) overlap=True, (d) the TP overflow re-solve, (e) a
    mega-bundle on 4 shards and on 1, (f) one BA batch of KITTI 00's
    window count. Returns B6's rows at the TP shapes of (d) and (e): each
    with its launches in that run, and its error and times on one of the
    systems that run solved."""
    import dataclasses

    from slam_tpu_torch.config import BundleConfig, RuntimeConfig
    from slam_tpu_torch.ops import se3, stereo
    from slam_tpu_torch.parallel import sharded_ba
    from slam_tpu_torch.parallel import tp_megabundle as tp
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.utils import metrics, synthetic

    need = ("detect_maps", "mutual_nearest", "cholesky_solve")
    ref = main_path["result"]
    mesh1, mesh4 = make_mesh(), make_mesh(4)
    # the windows the TP path re-solves under a mesh (overflowed ones)
    batch = bundle.build_windows(ref.db, ref.frontend.T_w2c,
                                 ref.bundles.keyframes, cfg.bundle)
    bundle.init_landmarks(batch, scene.calib)
    routed = sorted(spec["bi"] for spec in batch.overflow)

    def rel_T_diff(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    # ---- (a) a 1-shard mesh ------------------------------------------------
    shapes = collections.Counter()
    kept = {}  # the last single system solved at each (1, N, N) shape
    b6_solve = ba._spd_solve

    def counting(S, g):
        shapes[tuple(S.shape)] += 1
        if S.shape[0] == 1:
            kept[tuple(S.shape)] = (S.detach().clone(), g.detach().clone())
        return b6_solve(S, g)

    def b6_row(run, S, g, launches, by_shape, checked=None):
        """B6 on one system of a run against its plain version: error
        (check_b6's tolerance; on the batch ``checked`` where given), the
        three times and the bound."""
        err = check_b6(ck, *(checked or (S, g)), run)
        return {"run": run, "shape": list(S.shape), "launches": launches,
                "launches_by_shape": by_shape, "max_abs_err": err,
                "ms": median_ms(lambda: ck.cholesky_solve(S, g)),
                "plain_ms": median_ms(lambda: ck.cholesky_solve_plain(S, g)),
                "library_ms": median_ms(lambda: torch.linalg.solve_ex(S, g)),
                "bound_ms": b6_bound(S, g)[0]}

    with solving_with(ba, counting):
        a = drive_path(pipeline, ck, L, R, scene, cfg, need, "mesh 1-shard",
                       card, on_reset=shapes.clear, mesh=mesh1)
    res_a = a["result"]
    same_frontend(res_a.frontend, ref.frontend, "mesh (a) frontend")
    if res_a.bundles.keyframes != ref.bundles.keyframes:
        fail(f"mesh (a): keyframes {res_a.bundles.keyframes}, phase 4 "
             f"{ref.bundles.keyframes}")
    if a["closures"] != main_path["closures"]:
        fail(f"mesh (a): closures {a['closures']}, phase 4 "
             f"{main_path['closures']}")
    if not any(s_[0] == 1 and s_[1] > 12 for s_ in shapes) and routed:
        fail(f"mesh (a): B6 at no TP shape, {dict(shapes)}")
    # the window batch on the mesh, before the TP re-solve, against phase
    # 4's windows (both cut to the capacities)
    sharded = bundle.optimize_windows(batch, scene.calib, cfg.bundle,
                                      mesh=mesh1)
    d_a = rel_T_diff(sharded.rel_T, ref.bundles.rel_T)
    if not d_a <= SLICE_TOL["poses"]:
        fail(f"mesh (a): the sharded batch's rel_T {d_a:.3e} from phase 4's "
             f"(limit {SLICE_TOL['poses']})")
    log(f"[mesh] (a) 1-shard mesh: frontend equal bit for bit to phase 4's, "
        f"keyframes and closures equal; the sharded batch of "
        f"{batch.num_windows} windows within {d_a:.3e} of phase 4's rel_T "
        f"(limit {SLICE_TOL['poses']}); windows {routed} overflow "
        f"SlamConfig()'s capacities (max_landmarks {cfg.bundle.max_landmarks}"
        f", max_obs {cfg.bundle.max_obs}; obs_dropped {batch.obs_dropped} of "
        f"{batch.obs_total}, which leaves out the landmark cut, as in the JAX "
        f"package) and are re-solved at full size on the TP path (rel_T "
        f"{rel_T_diff(res_a.bundles.rel_T, ref.bundles.rel_T):.3e} from the "
        f"truncated solve); B6 by shape {dict(shapes)} ({card})")

    # ---- (b) 4 shards, 16 frames each: steps of 64 and 16 frames ---------
    cfg16 = dataclasses.replace(cfg, runtime=RuntimeConfig(chunk_frames=16))
    with solving_with(ba, counting):
        b = drive_path(pipeline, ck, L, R, scene, cfg16, need, "mesh 4-shard",
                       card, on_reset=shapes.clear, mesh=mesh4)
    batched = [s_ for s_ in shapes if s_[0] > 1]
    if not batched or any(s_[0] % 4 for s_ in batched):
        fail(f"mesh (b): BA batches {batched} not padded to a multiple of 4")
    log(f"[mesh] (b) 4-shard mesh, chunk_frames=16 (steps of 64 and 16 "
        f"frames): {b['windows']} windows in B6 batches {batched}, closures "
        f"{b['closures']}, ATE m {json.dumps(b['ates'])} ({card})")

    # ---- (c) overlap on (a)'s mesh ------------------------------------------
    # the overlapped stages re-solve no window on the TP path (as in the
    # JAX package): their rel_T is held against phase 4's truncated solve
    c = drive_path(pipeline, ck, L, R, scene, cfg, need, "mesh overlap", card,
                   mesh=mesh1, overlap=True)
    res_c = c["result"]
    for k in ("frames", "n_poses", "track_of_lm", "meas", "cam_idx",
              "lm_idx"):
        if not np.array_equal(getattr(res_c.bundles, k),
                              getattr(res_a.bundles, k)):
            fail(f"mesh (c): the overlapped windows' {k} differ from (a)'s")
    if res_c.bundles.keyframes != res_a.bundles.keyframes:
        fail(f"mesh (c): keyframes {res_c.bundles.keyframes}, (a) "
             f"{res_a.bundles.keyframes}")
    d_c = rel_T_diff(res_c.bundles.rel_T, ref.bundles.rel_T)
    if not d_c <= SLICE_TOL["poses"]:
        fail(f"mesh (c): rel_T {d_c:.3e} from phase 4's (limit "
             f"{SLICE_TOL['poses']})")
    if c["closures"] != a["closures"]:
        fail(f"mesh (c): closures {c['closures']}, (a) {a['closures']}")
    no_tp = dataclasses.replace(cfg, bundle=dataclasses.replace(
        cfg.bundle, tp_overflow=False))
    walls = {k: [] for k in ("sequential", "sequential, no TP", "overlapped")}
    for _ in range(3):
        for k, c_ in (("sequential", cfg), ("sequential, no TP", no_tp)):
            t = pipeline.run_pipeline(L, R, scene.calib, c_, verbose=False,
                                      mesh=mesh1).timings
            walls[k].append(t["frontend"] + t["trackstore"] + t["bundles"])
        t = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                  mesh=mesh1, overlap=True).timings
        walls["overlapped"].append(t["frontend+bundles_overlapped"])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"[mesh] (c) overlap: keyframes and windows equal to (a)'s, rel_T "
        f"within {d_c:.3e} of phase 4's, closures equal; medians of 3 warm "
        f"runs: frontend + trackstore + bundles {med['sequential']:.3f} s "
        f"(with the TP re-solves), {med['sequential, no TP']:.3f} s "
        f"(tp_overflow=False), frontend+bundles_overlapped "
        f"{med['overlapped']:.3f} s (runs {json.dumps(walls)}) ({card})")

    # ---- (d) the TP overflow re-solve ---------------------------------------
    cfg_t = dataclasses.replace(cfg, bundle=BundleConfig(**TIGHT))
    fe, db = ref.frontend, ref.db
    cut = bundle.run_bundles(db, fe.T_w2c, scene.calib, cfg_t)
    torch.cuda.synchronize()
    ck.reset_counters()
    shapes.clear()
    kept.clear()
    t0 = time.perf_counter()
    with solving_with(ba, counting):
        res_d = bundle.run_bundles(db, fe.T_w2c, scene.calib, cfg_t,
                                   mesh=mesh4)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    if any(ck.PLAIN_CALLS.values()):
        fail(f"mesh (d): a plain version ran: {ck.PLAIN_CALLS}")
    tp_shapes = {s_: n for s_, n in shapes.items() if s_[0] == 1}
    routed_d = np.nonzero(res_d.num_obs > TIGHT["max_obs"])[0]
    if not len(routed_d) or not tp_shapes:
        fail(f"mesh (d): no window re-solved at full size (num_obs "
             f"{res_d.num_obs.tolist()}, B6 shapes {dict(shapes)})")
    for bi in routed_d:
        eig = np.linalg.eigvalsh(res_d.rel_cov[bi].astype(np.float64))
        if not eig.min() > 0:
            fail(f"mesh (d): rel_cov of window {bi} not positive definite "
                 f"({eig})")
    kfs = res_d.keyframes
    ate_tp = metrics.ate_rmse(res_d.T_w2c_keyframes, scene.T_w2c[kfs])
    ate_cut = metrics.ate_rmse(cut.T_w2c_keyframes, scene.T_w2c[kfs])
    if not ate_tp <= ate_cut * 1.1 + 0.02:
        fail(f"mesh (d): bundles ATE {ate_tp} m with the TP re-solve, "
             f"{ate_cut} m truncated (limit x 1.1 + 0.02)")
    # B6 on a system that (d) solved: the last one of its most launched
    # TP shape
    top = max(tp_shapes, key=lambda s_: (tp_shapes[s_], s_[1]))
    row_d = b6_row("(d) TP overflow re-solve, 4 shards", *kept[top],
                   sum(tp_shapes.values()),
                   {str(k): n for k, n in tp_shapes.items()})
    # the port's emulation of the JAX package's re-solve on the same
    # windows: no depth gate, the covariances at the initial landmarks
    # (ROADMAP.md queue C; tests/test_torch_tp_megabundle.py holds the
    # JAX package itself against the port on the CPU)
    batch_t = bundle.build_windows(db, fe.T_w2c, kfs, cfg_t.bundle)
    mesh_tp = make_mesh(4, axis="tp")
    d_cov, d_rel, jax_rel = [], [], res_d.rel_T.copy()
    for spec in batch_t.overflow:
        bi, n = spec["bi"], int(batch_t.n_poses[spec["bi"]])
        p0, x0, ci, li, ms, w = bundle.overflow_problem(
            spec, batch_t, db, scene.calib, cfg_t.bundle)
        parts = tp.partition_megabundle(x0, ci, li, ms, w, 4)
        poses = tp.optimize_megabundle(mesh_tp, p0, *parts, scene.calib,
                                       iters=cfg_t.bundle.lm_iters)[0]
        cov0 = tp.megabundle_pose_covariances(mesh_tp, poses, *parts,
                                              scene.calib)[n - 1]
        ours = res_d.rel_cov[bi]
        d_cov.append(float(np.linalg.norm(cov0 - ours) / np.linalg.norm(ours)))
        d_rel.append(synthetic.twist_err(poses[n - 1:n],
                                         res_d.rel_T[bi:bi + 1]))
        jax_rel[bi] = poses[n - 1]
    ate_jax = metrics.ate_rmse(bundle._chain(jax_rel), scene.T_w2c[kfs])
    log(f"[mesh] (d) TP overflow under {TIGHT}, 4 shards: {len(routed_d)} of "
        f"{len(res_d.num_obs)} windows re-solved at full size (num_obs "
        f"{res_d.num_obs[routed_d].tolist()}), every rel_cov positive "
        f"definite; B6 at the TP shapes {tp_shapes}; run_bundles {wall_d:.2f} "
        f"s; bundles ATE {ate_tp:.4f} m vs {ate_cut:.4f} m truncated (limit "
        f"x 1.1 + 0.02); B6 at {top} on (d)'s last such system: kernel "
        f"{row_d['ms']:.4f} ms, plain {row_d['plain_ms']:.4f} ms, solve_ex "
        f"{row_d['library_ms']:.4f} ms, bound {row_d['bound_ms']:.6f} ms, "
        f"max abs err {row_d['max_abs_err']:.3e} ({card})")
    log(f"[mesh] (d) against the port's emulation of the JAX package's "
        f"re-solve (optimize_megabundle with no depth gate, covariances at "
        f"the initial landmarks) on the same windows: rel_cov "
        f"differs by {min(d_cov):.3e}-{max(d_cov):.3e} (relative Frobenius), "
        f"rel_T by {min(d_rel):.3e}-{max(d_rel):.3e} (twist norm); bundles "
        f"ATE {ate_jax:.4f} m there ({card})")

    # ---- (e) one mega-bundle on 4 shards and on 1 ---------------------------
    _, _, p0, x0, ci, li, ms, w = synthetic.megaproblem(
        scene.calib, MEGA["P"], MEGA["L"], MEGA["obs_per_lm"], SEED)
    iters = MEGA["iters"]  # the dense path's 2 x 20; 20 leave it short
    mega = {}
    ck.reset_counters()
    for n_sh in (4, 1):
        m = make_mesh(n_sh, axis="tp")
        parts = tp.partition_megabundle(x0, ci, li, ms, w, n_sh)
        tp.optimize_megabundle(m, p0, *parts, scene.calib, iters=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = tp.optimize_megabundle(m, p0, *parts, scene.calib, iters=iters)
        mega[n_sh] = out + ((time.perf_counter() - t0) / iters,
                            torch.cuda.max_memory_allocated() / 2**30)
    launches_e = ck.LAUNCHES["cholesky_solve"]
    if any(ck.PLAIN_CALLS.values()) or not launches_e:
        fail(f"mesh (e): B6 launches {launches_e}, plain calls "
             f"{ck.PLAIN_CALLS}")
    d_pose = synthetic.twist_err(mega[4][0], mega[1][0])
    d_cost = abs(mega[4][2] - mega[1][2]) / mega[1][2]
    if not (d_pose <= 1e-4 and d_cost <= 1e-4):
        fail(f"mesh (e): 4 shards vs 1: poses {d_pose:.3e} (limit 1e-4), "
             f"cost {d_cost:.3e} relative (limit 1e-4)")
    if not mega[4][2] < mega[4][3]:
        fail(f"mesh (e): cost {mega[4][2]} not below the initial "
             f"{mega[4][3]}")
    # B6 against its plain version on every system of one more 4-shard
    # run, as one batch: on a system this ill-conditioned either solve's
    # error alone varies by several times from one system to the next, so
    # the batch's largest errors are compared (check_b6); timed on the
    # first system
    solved = []

    def keep(S_, g_):
        solved.append((S_.detach().clone(), g_.detach().clone()))
        return b6_solve(S_, g_)

    parts = tp.partition_megabundle(x0, ci, li, ms, w, 4)
    with solving_with(ba, keep):
        tp.optimize_megabundle(make_mesh(4, axis="tp"), p0, *parts,
                               scene.calib, iters=iters)
    S_all = torch.cat([S_ for S_, _ in solved])
    g_all = torch.cat([g_ for _, g_ in solved])
    S, g = S_all[:1], g_all[:1]
    row_e = b6_row("(e) mega-bundle, 4 and 1 shards", S, g, launches_e,
                   {str(tuple(S.shape)): launches_e},
                   checked=(S_all, g_all))
    row_e["checked_systems"] = len(solved)
    log(f"[mesh] (e) mega-bundle P={MEGA['P']}, {MEGA['L']} landmarks, "
        f"{len(li)} observations, {iters} LM iterations: 4 shards "
        f"{mega[4][4] * 1e3:.2f} ms per iteration, peak device memory "
        f"{mega[4][5]:.2f} GiB; 1 shard {mega[1][4] * 1e3:.2f} ms, "
        f"{mega[1][5]:.2f} GiB; cost {mega[4][3]:.1f} -> {mega[4][2]:.4f} "
        f"(1 shard {mega[1][2]:.4f}, {d_cost:.2e} relative), poses "
        f"{d_pose:.2e} apart; B6 at {tuple(S.shape)} median of "
        f"{TIMING_RUNS}: kernel {row_e['ms']:.4f} ms, plain "
        f"{row_e['plain_ms']:.4f} ms, solve_ex {row_e['library_ms']:.4f} ms, "
        f"bound {row_e['bound_ms']:.5f} ms, {launches_e} launches ({card})")

    # ---- (f) one BA batch of KITTI 00's window count ------------------------
    bc = cfg.bundle
    calib_t = torch.tensor(scene.calib, device="cuda")
    win = synthetic_windows(se3, stereo, calib_t, KITTI00_WINDOWS,
                            bc.max_poses, bc.max_landmarks, bc.max_obs, SEED)
    host = [x.cpu().numpy() for x in win]
    step = sharded_ba.ba_training_step(mesh1, scene.calib, iters=bc.lm_iters)
    n_poses = np.full(KITTI00_WINDOWS, bc.max_poses)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(*host, n_poses)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    if not torch.isfinite(out[3]).all() or not (out[3] < out[4]).all():
        fail("mesh (f): a window's cost is not finite or did not fall")
    log(f"[mesh] (f) {KITTI00_WINDOWS} windows (P={bc.max_poses}, "
        f"L={bc.max_landmarks}, M={bc.max_obs}) in one batch: "
        f"{wall_f:.2f} s for 2 x {bc.lm_iters} LM iterations, peak device "
        f"memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} "
        f"GiB above the {base / 2**30:.2f} GiB held before ({card})")
    del win, out
    return [row_d, row_e]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3b)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after the paths, profile one more run of the main "
                         "path and of the AKAZE, SIFT and ORB paths and "
                         "write DIR/profile.json, DIR/profile_akaze.json, "
                         "profile_sift.json, profile_orb.json (phase 5)")
    args = ap.parse_args(argv)

    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.config import FeatureConfig, MatchConfig, SlamConfig
    from slam_tpu_torch.models import bundle, frontend, loop_closure
    from slam_tpu_torch.models.trackstore import TrackStore
    from slam_tpu_torch.ops import akaze, ba, binary, features, se3, sift
    from slam_tpu_torch.ops import stereo as stereo_ops
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.utils import metrics, synthetic

    cfg = SlamConfig()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # the native runtime (g++) builds beside the kernels (nvcc)
    from slam_tpu_torch import runtime
    t0 = time.perf_counter()
    native_build = threading.Thread(target=runtime.available)
    native_build.start()
    ck.build()
    build_s = time.perf_counter() - t0
    native_build.join()
    log(f"[build] kernels built in {build_s:.2f} s; native runtime "
        f"{'built' if runtime.available() else 'NOT built'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ck.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    scene = synthetic.make_scene(seed=SEED, num_frames=80,
                                 num_landmarks=8000, trajectory="loop",
                                 hw=HW)
    t0 = time.perf_counter()
    L, R = synthetic.render_sequence(scene)
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
    del path, oct0, oct1, L0

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
    ]
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k.setdefault("library_ms", None)
    if args.kernels_only:
        # no main-path run, so no launch counts to report
        log(json.dumps({"ok": True, "kernels_only": True}))
        return 0

    # ---- 4. main path -------------------------------------------------------
    # the default SlamConfig(); ba._spd_solve is wrapped to count the
    # measured pass's LM iterations by shape, each of which launches B6 once
    solves = collections.Counter()
    b6_solve = ba._spd_solve

    def counting(S, g):
        solves[tuple(S.shape)] += 1
        return b6_solve(S, g)

    with solving_with(ba, counting):
        main_path = drive_path(
            pipeline, ck, L, R, scene, cfg,
            ("detect_maps", "mutual_nearest", "cholesky_solve"), "path", card,
            on_reset=solves.clear)
    b6_launches = main_path["launches"]["cholesky_solve"]
    if b6_launches != sum(solves.values()):
        fail(f"path: {b6_launches} B6 launches for {dict(solves)} LM "
             f"iterations")
    # B6's time on the path: each shape's launches at phase 2d's times
    for shape in solves:
        if shape not in b6_at:
            fail(f"path: B6 at {shape}, a shape phase 2d did not time")
    k_ms, p_ms, lib_ms, b_ms = (sum(n * b6_at[s_][i]
                                    for s_, n in solves.items())
                                for i in range(4))
    log(f"[B6] main path: launches by shape {dict(solves)} (one per LM "
        f"iteration of BA, {main_path['windows']} windows, and of loop "
        f"closure); at phase 2d's times: kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, solve_ex {lib_ms:.3f} ms, bound {b_ms:.4f} ms, "
        f"kernel - bound {k_ms - b_ms:.3f} ms ({card})")

    # ---- 4b. the AKAZE path -------------------------------------------------
    cfg_akaze = SlamConfig(features=FeatureConfig(detector="akaze"),
                           matching=MatchConfig(norm="hamming"))
    launches_akaze = drive_path(
        pipeline, ck, L, R, scene, cfg_akaze,
        ("akaze_octave", "orientation_maps", "mutual_nearest",
         "cholesky_solve"), "path akaze", card)["launches"]

    # ---- 4c. multiscale Harris ----------------------------------------------
    # B1 at every pyramid level; the level shapes are recorded through the
    # wrapper, which features looks up at each call
    cfg_ms = SlamConfig(features=FeatureConfig(num_levels=2))
    shapes = set()
    detect_maps = ck.detect_maps

    def recording(imgs, *a, **kw):
        shapes.add(tuple(imgs.shape))
        return detect_maps(imgs, *a, **kw)

    ck.detect_maps = recording
    try:
        frontend.run_frontend(L, R, scene.calib, cfg_ms, device="cuda")
        torch.cuda.synchronize()
        shapes.clear()
        ck.reset_counters()
        t0 = time.perf_counter()
        fr = frontend.run_frontend(L, R, scene.calib, cfg_ms, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ck.detect_maps = detect_maps
    want = {(2 * chunk, HW[0], HW[1]),
            (2 * chunk, (HW[0] + 1) // 2, (HW[1] + 1) // 2)}
    if shapes != want or any(ck.PLAIN_CALLS.values()):
        fail(f"multiscale Harris: B1 at shapes {shapes} (want {want}), "
             f"plain calls {ck.PLAIN_CALLS}")
    ate = metrics.trajectory_summary(fr.T_w2c, scene.T_w2c)["ate_rmse_m"]
    if not (np.isfinite(fr.T_w2c).all() and ate < 1.0):
        fail(f"multiscale Harris: frontend ATE {ate} m (limit 1.0 m)")
    log(f"[path multiscale] num_levels=2, {L.shape[0]} frames {HW}: "
        f"frontend {wall:.3f} s, {L.shape[0] / wall:.1f} frames/s, ATE "
        f"{ate:.4f} m, pose failures {fr.num_pose_failures}; B1 shapes "
        f"{sorted(shapes)}, launches {dict(ck.LAUNCHES)} ({card})")

    # ---- 4d. the main path on the library solve -----------------------------
    # BA's and loop closure's reduced systems go to B6's plain version
    # (cholesky_ex + cholesky_solve, cuSOLVER) instead of B6
    with solving_with(ba, ck.cholesky_solve_plain):
        lib_path = drive_path(
            pipeline, ck, L, R, scene, cfg, ("detect_maps", "mutual_nearest"),
            "path library solve", card, plain_ok=("cholesky_solve",))
    if (lib_path["launches"]["cholesky_solve"]
            or lib_path["plain"]["cholesky_solve"] != b6_launches):
        fail(f"path library solve: B6 launches "
             f"{lib_path['launches']['cholesky_solve']}, library solves "
             f"{lib_path['plain']['cholesky_solve']} (phase 4: {b6_launches} "
             f"B6 launches)")
    if lib_path["closures"] != main_path["closures"]:
        fail(f"path library solve: closures {lib_path['closures']}, phase 4 "
             f"{main_path['closures']}")
    if set(lib_path["ates"]) != set(main_path["ates"]):
        fail(f"path library solve: ATE of stages {sorted(lib_path['ates'])}, "
             f"phase 4 {sorted(main_path['ates'])}")
    d_ate = {k: abs(lib_path["ates"][k] - v)
             for k, v in main_path["ates"].items()}
    if max(d_ate.values()) > 0.01:
        fail(f"path library solve: ATE {lib_path['ates']} vs phase 4 "
             f"{main_path['ates']} (limit 0.01 m apart)")
    log(f"[path library solve] {lib_path['plain']['cholesky_solve']} library "
        f"solves in place of B6's {b6_launches} launches; closures "
        f"{lib_path['closures']} as in phase 4; ATE differences "
        f"{json.dumps(d_ate)} m; bundles stage "
        f"{lib_path['timings']['bundles']:.3f} s vs "
        f"{main_path['timings']['bundles']:.3f} s on B6 ({card})")

    # ---- 4e. the BA engine A/B ----------------------------------------------
    # optimize_bundle at the default capacities and device_batch, solving
    # on the library and on B6 in turns (library, B6, B6, library)
    bc = cfg.bundle
    win = synthetic_windows(se3, stereo_ops, calib_t, 64, bc.max_poses,
                            bc.max_landmarks, bc.max_obs, SEED)
    cost0 = float(ba._cost(*win, calib_t).median())
    solvers = {"library": ck.cholesky_solve_plain, "B6": b6_solve}
    ab = {side: [] for side in solvers}
    costs, splits = {}, {}
    for side in ("library", "B6", "B6", "library"):
        with solving_with(ba, solvers[side]):
            ab[side].append(median_ms(
                lambda: ba.optimize_bundle(*win, calib_t, iters=bc.lm_iters),
                runs=5))
            cost = ba.optimize_bundle(*win, calib_t, iters=bc.lm_iters)[2]
            costs[side] = float(cost.median())
            splits[side] = lm_split(ba, se3, *win, calib_t)
    for side, c in costs.items():
        if not np.isfinite(c) or c >= cost0:
            fail(f"BA A/B {side}: median final cost {c} (initial {cost0})")
    if abs(costs["B6"] - costs["library"]) > 0.01 * costs["library"]:
        fail(f"BA A/B: median final cost on B6 {costs['B6']} vs "
             f"{costs['library']} on the library (limit 1% apart)")
    log(f"[BA A/B] optimize_bundle (64, P={bc.max_poses}, "
        f"L={bc.max_landmarks}, M={bc.max_obs}), {bc.lm_iters} iterations, "
        f"median of 5 per turn: library (cholesky_ex + cholesky_solve) "
        f"{ab['library']} ms, B6 {ab['B6']} ms; median cost {cost0:.1f} -> "
        f"library {costs['library']:.4f}, B6 {costs['B6']:.4f} ({card})")
    for side, split in splits.items():
        log(f"[BA split] one LM iteration on {side} (torch.profiler, device "
            f"drained between phases, median of 5): "
            + "; ".join(f"{n} host {split[n]['host_ms']:.3f} ms, device busy "
                        f"{split[n]['busy_ms']:.3f} ms, "
                        f"{split[n]['events']:.0f} device events, "
                        f"{split[n]['blocking']:.0f} blocking calls"
                        for n in LM_PHASES)
            + f"; iteration {split['wall_ms']:.3f} ms, device busy "
            f"{sum(split[n]['busy_ms'] for n in LM_PHASES):.3f} ms ({card})")
    if splits["B6"]["back-substitution"]["blocking"] > 0:
        fail(f"BA split: {splits['B6']['back-substitution']['blocking']} "
             f"blocking calls in back-substitution on B6 (want 0)")

    # ---- 4f. the disk path ---------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        disk = disk_phase(pipeline, ck, L, R, scene, cfg, batch, card,
                          Path(tmp))
        # ---- 4g. the CLI on 4f's KITTI directory, and the analysis -------
        cli_phase(pipeline, ck, main_path["result"], scene, L, disk, cfg,
                  card, Path(tmp))
        # ---- 4h. the scale run ------------------------------------------
        scale_phase(card, Path(tmp))

    # ---- 4i. the SIFT path --------------------------------------------------
    cfg_sift = SlamConfig(features=FeatureConfig(detector="sift"))
    sift_path = detector_phase(
        pipeline, ck, frontend, L, R, scene, cfg_sift,
        ("orientation_maps", "mutual_nearest", "cholesky_solve"), "path sift",
        card)
    # ---- 4j. the ORB path ---------------------------------------------------
    cfg_orb = SlamConfig(features=FeatureConfig(detector="orb"),
                         matching=MatchConfig(norm="hamming"))
    detector_phase(pipeline, ck, frontend, L, R, scene, cfg_orb,
                   ("mutual_nearest", "cholesky_solve"), "path orb", card)
    # ---- 4k. the sparse pose graph ------------------------------------------
    sparse_pg_phase(pipeline, ck, L, R, scene, cfg, main_path, card)
    # ---- 4l. the mesh and overlap modes, the TP mega-bundle -----------------
    at_tp = mesh_phase(pipeline, ck, ba, bundle, L, R, scene, cfg, main_path,
                       card)

    # ---- 5. profile (optional) ---------------------------------------------
    if args.profile:
        profile_path(pipeline, L, R, scene.calib, cfg, args.profile, card)
        profile_path(pipeline, L, R, scene.calib, cfg_akaze, args.profile,
                     card, "_akaze")
        profile_path(pipeline, L, R, scene.calib, cfg_sift, args.profile,
                     card, "_sift")
        profile_path(pipeline, L, R, scene.calib, cfg_orb, args.profile,
                     card, "_orb")

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "slam_tpu"))
    if foreign:
        fail(f"modules of JAX or of the JAX package were imported: "
             f"{foreign[:10]}")
    # each kernel's launches in the path that runs it; B4's in phase 2b
    counts = dict(main_path["launches"], orientation_maps=launches_akaze[
        "orientation_maps"], akaze_octave=launches_akaze["akaze_octave"],
        harris_response=b4_launches)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["name"] == "orientation_maps":
            k["launches_sift"] = sift_path["launches"]["orientation_maps"]
            k["at_sift_octaves"] = b3_sift
        if k["name"] == "cholesky_solve":
            k["at_tp"] = at_tp
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
