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
     scene (157 m, 8000 landmarks) on the card, with B1, B2, B6 and B7
     launched (B6 once per LM iteration of BA and of loop closure, by
     shape; B7 once per LM iteration and once per covariance system), no
     plain version run and every stage's ATE under 1 m, and the clock
     stamp (csrc/stamp.cu) launched three times per replay of the
     frontend chunk's graph; B6's time on the
     path from its launches and phase 2d's times. The path
     runs from CUDA graphs (runtime.graphs): drive_path warms it until a
     pass captures no new graph, times a pass, then counts the launches
     of another under torch.profiler (after a lead pass in the same
     trace, which may lose its first events, and between two marker
     kernels) and fails unless the trace holds the same launches of each
     kernel, by the name of its device function (a replay calls no
     wrapper: it adds the counts its capture took).
     B6's counter by shape is in graphs.COUNTERS while the path's graphs
     are captured, so its replays count too. Phases that swap a function
     of the path for another (4c's B1 recorder, 4d and 4e's library
     solve, 4l (a), (b), (d), (e)) run under runtime.graphs.eager(): a
     replay would not call the new one;
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
     final cost of each), and one LM iteration split by phase (Schur
     reduction (B7, with the linearization), solve, back-substitution,
     cost) from a
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
     KITTI 00's 651 windows at full capacity: seconds and peak memory
     (eagerly, the key's first call), then a second call that captures
     its graph: seconds, the capture pool's bytes, rel_T within
     SLICE_TOL of the first;
  4m. the mesh over ranks (`[mesh ranks]` lines), each rank a process of
     its own (slam_tpu_torch.parallel.ranks.spawn, a file:// rendezvous,
     every group joined within 300 s or killed): (a) the port's
     dryrun_multichip in 4 gloo ranks sharing the card (rank 0's line);
     (b) in the same ranks 4l (e)'s mega-bundle, one shard per rank,
     against the one-process 4-shard mesh: poses within 1e-6 and cost
     within 1e-9 relative, ms per LM iteration and peak device memory per
     rank, B6 launched in every rank; (c) run_pipeline(mesh=make_mesh())
     in 2 gloo ranks with chunk_frames=32 (steps of 64 frames, as 4l (b)'s)
     against 4l (b): keypoints and matches equal, the same keyframes,
     rel_T within SLICE_TOL, every ATE within 0.01 m, and B1, B2 and B6
     launched in each rank with no plain call; (d) where the host has
     more than one card, (a) and (b) over nccl with one rank per card and
     B1, B2 and B6 on cuda:1 against their plain versions, and (e)'s
     overlap over nccl on 2 and on 4 cards where the host has them;
     otherwise a line says it was not run and why; (e) the stage overlap
     over 2 gloo ranks sharing the card, run_pipeline(mesh=make_mesh(),
     overlap=True) under SlamConfig() in each (rank 0 the frontend, rank 1
     the BA, fed window batches point to point), cold and then with the
     launch counters zeroed: keypoints, matches, keyframes, windows and
     closures equal to the one-process overlap on a 2-shard mesh, rel_T
     within 1e-4, every ATE within 0.01 m, the two ranks' results equal,
     B1 launched on rank 0 and B6 on rank 1, no plain call; the
     overlapped stage per rank, warm and cold, beside (c)'s stages in
     turn and 4l (c)'s one-process overlap;
  4n. (a) slam_tpu_torch.entry.entry(): its step (one frontend chunk of
     4 x 256 x 832, 1024 keypoints, 256 hypotheses) twice on the card,
     outputs of the JAX step's shapes and dtypes, finite, B1 and B2
     launched, then the median ms of 5 warm steps; (b) the per-image
     forms on one frame of the scene (row 5 of 32): detect_and_describe,
     _multiscale, _akaze, _sift, _orb and match_stereo_pair each equal
     bit for bit to that row of its batched form, and detect on kernel B4
     (one launch) with xy and valid equal to detect_and_describe_batch's
     row on B1;
  4o. the CUDA graphs (runtime.graphs, `[graphs]` lines), all graphs
     freed first: (c) run_pipeline under graphs.eager() and then three
     times with graphs (warm-ups, captures, replays): per-stage seconds,
     frontend frames/s, ATEs (each under 1 m and within 0.01 m of the
     eager run's), the eager run's closures, kernel launches equal to the
     eager run's in every graphed run (B1 3, B2 7, B6 70, B7 72), each
     graphed function of the main path replayed in the third run, and
     graphs.stats(); then two more in one torch.profiler trace (a lead
     run, then a counted one between two marker kernels), all replays,
     the counted run's launches equal to the trace's by kernel name; (e) peak device memory and the capture pools' bytes;
     (a) per function, at the main path's shapes, three graphed calls
     and one on new inputs of the same shapes against the same calls
     under eager(): the frontend chunk with a carry and
     recompute_descriptors equal bit for bit (same_frontend's rule), the
     scene's 16-window batch (window_step) and the first closure's pair
     refinement within SLICE_TOL, loop verification at SPEC_Q x max_candidates with
     equal inliers and matches; (b) each one's median wall ms eager and
     graphed, the host's ms to launch the graphed call, and device busy
     ms of both (torch.profiler); (d) 4e's optimize_bundle at B = 64: ms
     per LM iteration eager and graphed (wall, host to launch, device
     busy), the graphed result within SLICE_TOL of the eager one. Since
     the pose graph's ops and the window covariances run from graphs
     too: (c) prints find_loops' split of each run (gate, re-optimisation,
     pair refinement and verification seconds, gate refreshes) and the
     Python calls of torch.linalg.inv_ex (none in the warm runs: every
     inverse of the path is inside a graph), and requires the pose
     graph's LM and gate sweep to replay; (a), (b) add solve_windows
     alone on the batch's device inputs and ops.pose_graph.optimize and
     gate_matrix on the scene's graph with its closures and on a
     652-keyframe graph (KITTI 00's count, the 704-node bucket): nodes
     and cost within PG_TOL, the same pairs failing closed, distances
     within PG_TOL, two eager runs' spread beside them, the capture pools
     each added, and on the scene's graph the LM with its nodes unpadded
     beside the 64-node bucket (wall, device busy); and the window
     batch's and the pair's rel_cov against a float64 inverse of the
     same S, within COV_TOL;
  4p. the frontend chunk's clock stamps (`[stamp]` lines), all graphs
     freed first: for each of the benchmark's configurations
     (slambench/configs: kitti00_harris, kitti00_akaze, kitti00_sift),
     its chunk (32 frames of the scene at 376x1241, its K) with a carry
     through frontend._chunk's graph, warmed up and captured, then
     STAMP_RUNS replays, each between two CUDA events: in every replay
     the three stamps rise, three stamp launches per replay, and the
     median of the stamps' span (features + motion) within 10 % of the
     median event time (a clock has no plain version on the same
     inputs: the events are its counterpart); the features' share of
     the span printed;
  5. with --profile DIR: one more warm run of the main path, and one
     each of the AKAZE, the SIFT and the ORB path, under torch.profiler;
     wall time, device busy time (union of the device events' intervals)
     and idle share of that one run, per stage and in all, and device
     time by kernel, into DIR/profile.json, profile_akaze.json,
     profile_sift.json and profile_orb.json.
The second line from the end is the kernels' JSON record (after a full
run only): per kernel its launches on the path that runs it (B4's on the
per-image detect path of 4n (b), and in phase 2b beside it), max abs
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
    library solve (B6's plain version) for the A/B phases, or a counter.
    The block runs eagerly (runtime.graphs.eager()): a graph replays what
    its capture launched and calls no Python, so it would neither take
    the replacement nor count through it."""
    from slam_tpu_torch.runtime import graphs

    saved = ba._spd_solve
    ba._spd_solve = solve
    try:
        with graphs.eager():
            yield
    finally:
        ba._spd_solve = saved


LM_PHASES = ("Schur reduction", "solve", "back-substitution", "cost")


def lm_split(ba, se3, poses, points, cam, lm, meas, w, calib,
             runs: int = 5) -> dict:
    """One LM iteration by phase, from a torch.profiler trace of ``runs``
    iterations after a warm-up, on the main path's code: Schur reduction
    (B7: the residuals, Jacobians and the damped S and ghat from the
    observations and the slot table, which optimize_bundle makes once per
    call and this makes once before the runs), solve (ba._spd_solve),
    back-substitution (B7's landmark steps, pose retraction) and cost
    (the trial state's cost). Each phase runs in a
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

    from slam_tpu_torch.ops import cuda_kernels as ck

    P, L = poses.shape[1], points.shape[1]
    lam = torch.full((poses.shape[0],), 1e-4, device=poses.device)
    slot = ba._slot_table(cam, lm, w, P, L)

    @contextlib.contextmanager
    def phase(name):
        with record_function(f"lm:{name}"):
            yield
        torch.cuda.synchronize()

    def iteration():
        with phase("Schur reduction"):
            S, ghat, Hll_inv, g_l, cross = ck.schur_reduce(
                poses, points, cam, lm, meas, w, calib, slot, lam)
        with phase("solve"):
            dp = -ba._spd_solve(S, ghat)
        with phase("back-substitution"):
            dl = ck.schur_back(dp, slot, cross, Hll_inv, g_l)
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


# each kernel's device function as a trace names it: every wrapper
# launches one per call (B1, B3 and B4 are instances of one template)
TRACE_NAMES = {"detect_maps": "maps_kernel<true, true>",
               "harris_response": "maps_kernel<true, false>",
               "orientation_maps": "maps_kernel<false, true>",
               "akaze_octave": "akaze_octave_kernel<",
               "mutual_nearest": "mutual_kernel<",
               "cholesky_solve": "cholesky_solve_kernel<",
               "schur_reduce": "schur_poses_kernel",
               "stamp": "stamp_kernel"}


# host seconds of idle trace before the lead call and after the last
# marker, per attempt: a trace drops device events whose times, mapped to
# the host's clock, fall outside its window, and the mapping drifts
TRACE_PADS_S = (0.2, 0.5, 1.0)


def traced_window(fn, lead, reset=None) -> tuple:
    """lead(), then fn() between two marker kernels, under one
    torch.profiler trace of the card: (fn()'s result, the trace's device
    events inside the markers). A trace can drop device events at its
    edges as out of range (its conversion of device times to host times
    drifts; seen on the H100 machines, eagerly too, and with fast graphed
    passes): the lead call and idle host time at both ends
    (TRACE_PADS_S) take that loss. Both markers must be in the trace; an
    attempt that lost one is logged and repeated with longer pads, and
    the phase fails if the last attempt lost one too. ``reset`` runs
    between the lead call and fn() (the launch counters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for pad in TRACE_PADS_S:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            lead()
            torch.cuda.synchronize()
            if reset is not None:
                reset()
            torch.cuda._sleep(1000)
            out = fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = sorted(e.time_range.start for e in dev
                       if "spin_kernel" in e.name)
        if len(marks) == 2:
            return out, [e for e in dev if marks[0] < e.time_range.start
                         and e.time_range.end <= marks[1]]
        log(f"[trace] {len(marks)} of its 2 marker kernels among "
            f"{len(dev)} device events (pads {pad} s)")
    fail(f"trace: a marker kernel lost with every pad of {TRACE_PADS_S} s")


def traced_launches(fn, reset=None) -> tuple:
    """fn() traced after a lead call of fn() (``traced_window``): (its
    result, the launches of each kernel of TRACE_NAMES in its trace, and
    the names of the device functions counted). Kernels replayed from a
    CUDA graph are in the trace one by one."""
    out, dev = traced_window(fn, fn, reset)
    counts = dict.fromkeys(TRACE_NAMES, 0)
    names = collections.Counter()
    for e in dev:
        for k, pat in TRACE_NAMES.items():
            if pat in e.name:
                counts[k] += 1
                names[e.name[:e.name.find(pat) + len(pat) + 12]] += 1
    return out, counts, dict(names)


def drive_path(pipeline, ck, L, R, scene, cfg, required, tag, card,
               on_reset=None, plain_ok=(), trace=False, **run_kw):
    """run_pipeline + evaluate under ``cfg`` (and ``run_kw``, a mesh) on
    the card: warm-up passes
    (cuDNN / cuBLAS / cuSOLVER handles, allocator; with graphs on, until a
    pass captures no new graph), then the measured pass with the launch
    counters zeroed just before it (``on_reset`` is called there too) and
    read just after. With ``trace`` (the paths whose launches the
    kernels line reports) the launches come from one more pass, under
    torch.profiler after a lead pass (``traced_launches``), and must
    equal the trace's, kernel by kernel, and the measured pass's. Fails unless every
    kernel in ``required`` launched, no plain version ran (but those of
    ``plain_ok``, which the caller put in on purpose), the trajectory is
    finite, at least one loop closed and every stage's ATE is under 1 m.
    Returns the launches, the measured pass's plain calls, ATEs, closure
    frame pairs, stage timings and number of BA windows."""
    from slam_tpu_torch.runtime import graphs

    def settled():  # warm-ups and captures so far
        return sum(st["warmups"] + st["captures"]
                   for st in graphs.stats().values())

    # warm-up passes until one warms up and captures no graph (the first
    # call of a key runs eagerly, the second captures it)
    for _ in range(3):
        before = settled()
        pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                              device="cuda", **run_kw)
        if settled() == before:
            break
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
    if trace:
        def reset():
            ck.reset_counters()
            if on_reset is not None:
                on_reset()

        _, traced, names = traced_launches(lambda: pipeline.run_pipeline(
            L, R, scene.calib, cfg, verbose=False, device="cuda", **run_kw),
            reset)
        if dict(ck.LAUNCHES) != launches:
            fail(f"{tag}: launches {ck.LAUNCHES} in the traced pass, "
                 f"{launches} in the measured one")
        if any(traced[k] != launches[k] for k in TRACE_NAMES):
            fail(f"{tag}: launches counted {launches}, in the trace {traced} "
                 f"(device functions {names})")
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
        f"{report['num_pose_failures']}; launches {launches}"
        + (", each equal to the trace's launches of its device function"
           if trace else "") + f" ({card})")
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
    from slam_tpu_torch.runtime import graphs

    path = drive_path(pipeline, ck, L, R, scene, cfg, required, tag, card,
                      trace=True)
    chunk = cfg.runtime.chunk_frames
    pool = graphs.stats()["models.frontend._chunk"]["pool_bytes"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # eagerly, as before the graphs: a replay allocates nothing, its
    # capture pool (printed beside) holds the body's memory
    with graphs.eager():
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
        f"eagerly (allocated before it {base / 2**30:.2f} GiB; detection of "
        f"{2 * chunk} images {HW} at once); the chunk graph's capture pool "
        f"{pool / 2**30:.2f} GiB; chunk 0's descriptors recomputed equal bit "
        f"for bit ({card})")
    graphs.clear()  # this detector's graphs: none of the later phases
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
               card) -> tuple:
    """Phase 4l: (a) run_pipeline on a 1-shard mesh, (b) on 4 shards with
    chunk_frames=16, (c) overlap=True, (d) the TP overflow re-solve, (e) a
    mega-bundle on 4 shards and on 1, (f) one BA batch of KITTI 00's
    window count. Returns B6's rows at the TP shapes of (d) and (e): each
    with its launches in that run, and its error and times on one of the
    systems that run solved; (b)'s drive_path record; and (c)'s medians."""
    import dataclasses

    from slam_tpu_torch.config import BundleConfig, RuntimeConfig
    from slam_tpu_torch.ops import se3, stereo
    from slam_tpu_torch.parallel import sharded_ba
    from slam_tpu_torch.parallel import tp_megabundle as tp
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.runtime import graphs
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
    ba_graphs = graphs.stats()["ops.ba.solve_windows"]
    for _ in range(3):
        for k, c_ in (("sequential", cfg), ("sequential, no TP", no_tp)):
            t = pipeline.run_pipeline(L, R, scene.calib, c_, verbose=False,
                                      mesh=mesh1).timings
            walls[k].append(t["frontend"] + t["trackstore"] + t["bundles"])
        t = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                  mesh=mesh1, overlap=True).timings
        walls["overlapped"].append(t["frontend+bundles_overlapped"])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    # every window batch shape of these runs (the 16-window batch, the
    # pair, the overlap's flushes) stays cached: no warm-up or capture
    st = graphs.stats()["ops.ba.solve_windows"]
    if any(st[k] != ba_graphs[k] for k in ("warmups", "captures")):
        fail(f"mesh (c): the window BA warmed up or captured again in the "
             f"warm runs: {ba_graphs} before them, {st} after")
    log(f"[mesh] (c) the window BA's graphs over the warm runs: {st['keys']} "
        f"keys (at most graphs.MAX_KEYS = {graphs.MAX_KEYS}), "
        f"{st['replays'] - ba_graphs['replays']} replays, no warm-up, "
        f"capture or eviction ({st['evictions']} evictions in all) ({card})")
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
    graphs.clear()  # this batch's graph alone in solve_windows' pools
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(*host, n_poses)  # the key's first call: eager
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    peak_f = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(out[3]).all() or not (out[3] < out[4]).all():
        fail("mesh (f): a window's cost is not finite or did not fall")
    # the second call captures the batch's graph and replays it
    t0 = time.perf_counter()
    out2 = step(*host, n_poses)
    torch.cuda.synchronize()
    wall_f2 = time.perf_counter() - t0
    pool = graphs.stats()["ops.ba.solve_windows"]
    d_f = float((out2[5] - out[5]).abs().max())
    c_f = float(((out2[3] - out[3]).abs() / out[3].abs()).max())
    if pool["captures"] != 1 or not d_f <= SLICE_TOL["poses"]:
        fail(f"mesh (f): the graphed batch ({pool}) rel_T {d_f:.3e} from "
             f"the eager one (limit {SLICE_TOL['poses']})")
    log(f"[mesh] (f) {KITTI00_WINDOWS} windows (P={bc.max_poses}, "
        f"L={bc.max_landmarks}, M={bc.max_obs}) in one batch: "
        f"{wall_f:.2f} s for 2 x {bc.lm_iters} LM iterations eagerly (the "
        f"key's first call), peak device memory {peak_f / 2**30:.2f} GiB "
        f"above the {base / 2**30:.2f} GiB held before; the second call "
        f"captured and replayed in {wall_f2:.2f} s, its capture pool "
        f"{pool['pool_bytes'] / 2**30:.2f} GiB (reserved "
        f"{reserved / 2**30:.2f} -> {torch.cuda.memory_reserved() / 2**30:.2f}"
        f" GiB), rel_T {d_f:.3e} from the eager call (limit "
        f"{SLICE_TOL['poses']}), cost {c_f:.3e} relative ({card})")
    del win, out, out2
    graphs.clear()
    return [row_d, row_e], b, med


# phase 4m: the mesh over ranks, each rank a process of its own. (a) and
# (b) run in one group of MESH_RANKS ranks, (c) in one of 2; every group is
# joined within RANKS_JOIN_S seconds, or killed and the phase failed
MESH_RANKS = 4
RANKS_JOIN_S = 300.0
RANK_POSE_TOL, RANK_COST_TOL = 1e-6, 1e-9
# what (c) holds equal to 4l (b)'s: keypoints and matches
RANK_FE_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev")


def ranks_ab(mega, calib, iters: int, backend: str) -> dict:
    """One rank of phase 4m (a) and (b): the dry run's checks in this
    rank's process group, then 4l (e)'s mega-bundle on one shard per rank
    (a warm-up of one iteration, then ``iters`` with the launch counters
    zeroed just before): its poses and costs, ms per LM iteration, peak
    device memory and launches; then the ms of one LM iteration's two
    all_sums alone (the system's four float64 tensors, the cost),
    drained before and after, median of 20."""
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.parallel import tp_megabundle as tp
    from slam_tpu_torch.parallel.dryrun import dryrun_multichip
    from slam_tpu_torch.parallel.mesh import all_sum, make_mesh

    t0 = time.perf_counter()
    line = dryrun_multichip(torch.distributed.get_world_size(), backend)
    dry_s = time.perf_counter() - t0
    _, _, p0, x0, ci, li, ms, w = mega
    m = make_mesh(axis="tp")
    parts = tp.partition_megabundle(x0, ci, li, ms, w, m.size)
    tp.optimize_megabundle(m, p0, *parts, calib, iters=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counters()
    t0 = time.perf_counter()
    poses, _, cost, cost0 = tp.optimize_megabundle(m, p0, *parts, calib,
                                                   iters=iters)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / iters * 1e3
    P6 = 6 * p0.shape[0]
    system = [torch.ones(shape, dtype=torch.float64, device=m.device)
              for shape in ((1, P6 // 6, 6, 6), (1, P6 // 6, 6),
                            (1, P6, P6), (1, P6), (1,))]
    sums = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_sum(m, *system[:4])
        all_sum(m, system[4])
        torch.cuda.synchronize()
        sums.append((time.perf_counter() - t0) * 1e3)
    return {"line": line, "dry_s": dry_s, "device": str(m.device),
            "poses": poses, "cost": cost, "cost0": cost0, "ms": ms_iter,
            "all_sum_ms": float(np.median(sums[1:])),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": dict(ck.LAUNCHES), "plain": dict(ck.PLAIN_CALLS)}


def ranks_path(paths, calib, T_gt, cfg) -> dict:
    """One rank of phase 4m (c): run_pipeline(mesh=make_mesh()) on the
    scene (its images from ``paths``), once to warm up (a fresh process:
    the card's context, cuDNN / cuBLAS handles, the allocator), then
    with the launch counters zeroed just before it and read just after;
    the frontend's keypoints and matches, the windows' rel_T, the
    closures and every stage's ATE."""
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.parallel.mesh import make_mesh

    L, R = (np.load(p) for p in paths)
    mesh = make_mesh()
    t0 = time.perf_counter()
    pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    ck.reset_counters()
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    report = pipeline.evaluate(res, T_gt)
    fe = res.frontend
    return {"device": str(mesh.device), "wall": wall, "cold": cold,
            "timings": res.timings, "launches": launches, "plain": plain,
            "ates": {k: report[k]["ate_rmse_m"] for k in (
                "frontend", "bundles_kf", "pose_graph_kf",
                "pose_graph_lc_kf") if k in report},
            "closures": [(c.frame_i, c.frame_j) for c in res.closures],
            "keyframes": res.bundles.keyframes, "rel_T": res.bundles.rel_T,
            **{k: getattr(fe, k) for k in RANK_FE_ARRAYS}}


# what (e) holds equal to the one-process overlap's: the windows
OVERLAP_WINDOWS = ("frames", "n_poses", "track_of_lm", "meas", "cam_idx",
                   "lm_idx")
RANK_REL_T_TOL = 1e-4
RANK_ATE_SPREAD = 1e-5


def ranks_overlap(paths, calib, T_gt, cfg) -> dict:
    """One rank of phase 4m (e): run_pipeline(mesh=make_mesh(),
    overlap=True) on the scene, once cold (a fresh process) and once,
    after a barrier (so that every rank's clock starts together), with
    the launch counters zeroed just before it and read just after; both
    runs' stage timings, the measured run's frontend, windows, rel_T,
    closures and every stage's ATE."""
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.parallel.mesh import make_mesh

    L, R = (np.load(p) for p in paths)
    mesh = make_mesh()
    cold = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh,
                                 overlap=True).timings
    torch.cuda.synchronize()
    torch.distributed.barrier()
    ck.reset_counters()
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh,
                                overlap=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    report = pipeline.evaluate(res, T_gt)
    return {"device": str(mesh.device), "wall": wall, "cold": cold,
            "timings": res.timings, "launches": launches, "plain": plain,
            "ates": {k: report[k]["ate_rmse_m"] for k in (
                "frontend", "bundles_kf", "pose_graph_kf",
                "pose_graph_lc_kf") if k in report},
            "closures": [(c.frame_i, c.frame_j) for c in res.closures],
            "keyframes": res.bundles.keyframes, "rel_T": res.bundles.rel_T,
            **{k: getattr(res.bundles, k) for k in OVERLAP_WINDOWS},
            **{k: getattr(res.frontend, k) for k in RANK_FE_ARRAYS}}


def check_overlap_ranks(runs, ref, backend: str, card: str,
                        rel_tol: float = RANK_REL_T_TOL) -> None:
    """Phase 4m (e) (and its nccl runs in (d)): every rank's overlapped
    pipeline against the one-process overlap on a mesh of as many shards
    (``ref``, drive_path's record): keypoints, matches, keyframes, windows
    and closures equal, rel_T within ``rel_tol``, every ATE within
    0.01 m; every rank's frontend, windows, rel_T, keyframes and closures
    equal to rank 0's, its ATEs within RANK_ATE_SPREAD of rank 0's (each
    rank optimizes the pose graph and the loop-closure pairs on its own,
    and the card's atomic sums vary in order); B1 launched on the
    frontend's first rank, B6 on the BA group's (rank (n + 1) // 2, as
    split_mesh cuts), no plain call on any. Logs every rank's line, then
    fails on the first fault found."""
    res = ref["result"]
    n = len(runs)
    fe_first, ba_first = 0, (n + 1) // 2
    faults = []
    for r, out in enumerate(runs):
        where = f"mesh ranks overlap {backend}, rank {r}"
        differ = [k for k in RANK_FE_ARRAYS
                  if not np.array_equal(out[k], getattr(res.frontend, k))]
        differ += [k for k in OVERLAP_WINDOWS
                   if not np.array_equal(out[k], getattr(res.bundles, k))]
        differ += [k for k, v in (("keyframes", res.bundles.keyframes),
                                  ("closures", ref["closures"]))
                   if out[k] != v]
        if differ:
            faults.append(f"{where}: {differ} differ from one process's")
        d_rel = float(np.abs(out["rel_T"] - res.bundles.rel_T).max())
        d_ate = {k: abs(v - ref["ates"][k]) for k, v in out["ates"].items()}
        if not d_rel <= rel_tol or out["ates"].keys() != \
                ref["ates"].keys() or max(d_ate.values()) > 0.01:
            faults.append(
                f"{where}: rel_T {d_rel:.3e} (limit {rel_tol}), ATE "
                f"{out['ates']}, one process {ref['ates']} (limit 0.01 m)")
        differ = [k for k in ("keyframes", "closures")
                  if out[k] != runs[0][k]]
        differ += [k for k in ("rel_T",) + RANK_FE_ARRAYS + OVERLAP_WINDOWS
                   if not np.array_equal(out[k], runs[0][k])]
        spread = max(abs(v - runs[0]["ates"][k])
                     for k, v in out["ates"].items())
        if differ or spread > RANK_ATE_SPREAD:
            faults.append(f"{where}: {differ} differ from rank 0's, ATEs "
                          f"{spread:.3e} m from rank 0's (limit "
                          f"{RANK_ATE_SPREAD})")
        out["d_rel"], out["d_ate"] = d_rel, max(d_ate.values())
        out["spread"] = spread
    if not runs[fe_first]["launches"]["detect_maps"] or \
            not runs[ba_first]["launches"]["cholesky_solve"] or \
            any(any(out["plain"].values()) for out in runs):
        faults.append(
            f"mesh ranks overlap {backend}: B1 launches on rank {fe_first} "
            f"{runs[fe_first]['launches']['detect_maps']}, B6 on rank "
            f"{ba_first} {runs[ba_first]['launches']['cholesky_solve']}, "
            f"plain calls {[out['plain'] for out in runs]}")
    stage = "frontend+bundles_overlapped"
    for r, out in enumerate(runs):
        log(f"[mesh ranks] (e) overlap, {backend} rank {r} of {n} on "
            f"{out['device']}: {stage} warm {out['timings'][stage]:.3f} s, "
            f"cold {out['cold'][stage]:.3f} s; run_pipeline warm "
            f"{out['wall']:.2f} s, stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in out["timings"].items())
            + f"; against one process: rel_T within {out['d_rel']:.3e} "
            f"(limit {rel_tol}), ATEs within {out['d_ate']:.2e} m, "
            f"ATEs {out['spread']:.2e} m from rank 0's; launches "
            f"{out['launches']} ({card})")
    if faults:
        fail("; ".join(faults))


def mega_in_process(tp, make_mesh, mega, calib, n: int, iters: int):
    """4l (e)'s mega-bundle on a one-process n-shard mesh: (poses, cost,
    ms per LM iteration), after a warm-up of one iteration."""
    _, _, p0, x0, ci, li, ms, w = mega
    m = make_mesh(n, axis="tp")
    parts = tp.partition_megabundle(x0, ci, li, ms, w, n)
    tp.optimize_megabundle(m, p0, *parts, calib, iters=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, _, cost, _ = tp.optimize_megabundle(m, p0, *parts, calib,
                                               iters=iters)
    torch.cuda.synchronize()
    return poses, cost, (time.perf_counter() - t0) / iters * 1e3


def check_ranks_ab(ab, ref, n: int, backend: str, card: str) -> None:
    """Phase 4m (a) and (b) of ``ranks_ab``'s results on n ranks against
    the one-process n-shard mesh's ``ref``."""
    from slam_tpu_torch.utils import synthetic

    poses, cost, ms = ref
    devices = sorted({r["device"] for r in ab})
    log(f"[mesh ranks] (a) {n} {backend} ranks on {devices}: rank 0's "
        f"line: {ab[0]['line']} ({ab[0]['dry_s']:.1f} s in the ranks) "
        f"({card})")
    for r, out in enumerate(ab):
        d_pose = synthetic.twist_err(out["poses"], poses)
        d_cost = abs(out["cost"] - cost) / cost
        if not (d_pose <= RANK_POSE_TOL and d_cost <= RANK_COST_TOL):
            fail(f"mesh ranks (b) {backend}, rank {r}: poses {d_pose:.3e} "
                 f"from the one-process {n}-shard mesh's (limit "
                 f"{RANK_POSE_TOL}), cost {d_cost:.3e} relative (limit "
                 f"{RANK_COST_TOL})")
        if not out["launches"]["cholesky_solve"] or any(
                out["plain"].values()):
            fail(f"mesh ranks (b) {backend}, rank {r}: B6 launches "
                 f"{out['launches']['cholesky_solve']}, plain calls "
                 f"{out['plain']}")
        log(f"[mesh ranks] (b) {backend} rank {r} on {out['device']}: "
            f"{out['ms']:.2f} ms per LM iteration (its two all_sums alone "
            f"{out['all_sum_ms']:.3f} ms), peak device memory "
            f"{out['peak_gib']:.3f} GiB, cost {out['cost0']:.1f} -> "
            f"{out['cost']:.4f}, poses {d_pose:.2e} and cost {d_cost:.2e} "
            f"relative from the one-process {n}-shard mesh's, B6 launches "
            f"{out['launches']['cholesky_solve']} ({card})")
    log(f"[mesh ranks] (b) {MEGA['L']} landmarks, {MEGA['iters']} LM "
        f"iterations: {n} {backend} ranks "
        f"{max(r['ms'] for r in ab):.2f} ms per iteration (slowest rank), "
        f"one process with {n} shards {ms:.2f} ms ({card})")


def nccl_ranks(ck, mega, calib, L, R, scene, cfg, card) -> str:
    """Phase 4m (d), on a host with more than one card: (a) and (b) over
    nccl with one rank per card (at most MESH_RANKS), (b) against the
    one-process mesh of as many shards; (e)'s overlap over nccl on 2 and
    on 4 cards (where the host has them), each against the one-process
    overlap on a mesh of as many shards; then B1 on 4 of the frames, B2
    and B6 on cuda:1 against their plain versions there. Returns the note
    for the phase's last line."""
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.parallel import ranks
    from slam_tpu_torch.parallel import tp_megabundle as tp
    from slam_tpu_torch.parallel.mesh import make_mesh

    n = min(MESH_RANKS, torch.cuda.device_count())
    ref = mega_in_process(tp, make_mesh, mega, calib, n, MEGA["iters"])
    t0 = time.perf_counter()
    d = ranks.spawn(ranks_ab, n, "nccl", "cuda",
                    args=(mega, calib, MEGA["iters"], "nccl"),
                    timeout=RANKS_JOIN_S)
    wall = time.perf_counter() - t0
    check_ranks_ab(d, ref, n, "nccl", card)
    with tempfile.TemporaryDirectory() as tmp:
        paths = (str(Path(tmp) / "left.npy"), str(Path(tmp) / "right.npy"))
        np.save(paths[0], L)
        np.save(paths[1], R)
        for n_ov in (2, 4):
            if torch.cuda.device_count() < n_ov:
                continue
            ref_ov = drive_path(
                pipeline, ck, L, R, scene, cfg,
                ("detect_maps", "mutual_nearest", "cholesky_solve"),
                f"mesh ranks overlap, one process, {n_ov} shards", card,
                mesh=make_mesh(n_ov), overlap=True)
            ov = ranks.spawn(ranks_overlap, n_ov, "nccl", "cuda",
                             args=(paths, calib, scene.T_w2c, cfg),
                             timeout=RANKS_JOIN_S)
            # the BA rank solves on another card than the one-process
            # reference: the float32 window LM, whose sums on the card
            # vary in order, may take another accept path there (1.32e-4
            # measured on 2 cards, NVIDIA H100 80GB HBM3, 700 W; PERF.md),
            # so the windows' SLICE_TOL holds it
            check_overlap_ranks(ov, ref_ov, "nccl", card,
                                rel_tol=SLICE_TOL["poses"])
            log(f"[mesh ranks] (d) the one-process overlap on {n_ov} shards "
                f"{ref_ov['timings']['frontend+bundles_overlapped']:.3f} s "
                f"({card})")
    dev1 = torch.device("cuda", 1)
    gen = torch.Generator(device=dev1)
    gen.manual_seed(SEED)
    check_b1(ck, torch.as_tensor(L[:4], device=dev1), "on cuda:1")
    check_b2(ck, b2_inputs(gen, 4, 2048, 2048), None, "on cuda:1")
    check_b6(ck, *spd_systems(gen, 64, 144), "on cuda:1")
    return f"run: {n} nccl ranks on {n} cards in {wall:.1f} s"


def mesh_ranks_phase(ck, L, R, scene, cfg, mesh_b, overlap_med, card,
                     tmp) -> None:
    """Phase 4m: (a) the dry run and (b) 4l (e)'s mega-bundle on
    MESH_RANKS gloo ranks sharing the card, (b) held against the
    one-process mesh of as many shards; (c) run_pipeline(mesh=make_mesh())
    on 2 gloo ranks (steps of 2 x 32 frames, 4l (b)'s 64) held against
    4l (b)'s one-process 4-shard mesh; (e) the overlap on 2 gloo ranks
    (a frontend rank and a BA rank) held against the one-process overlap
    on a 2-shard mesh, its stage beside (c)'s stages in turn and 4l (c)'s
    one-process overlap (``overlap_med``); (d) over nccl, one rank per
    card, and the kernels on cuda:1, where the host has more than one
    card."""
    import dataclasses

    from slam_tpu_torch import pipeline
    from slam_tpu_torch.config import RuntimeConfig
    from slam_tpu_torch.parallel import ranks
    from slam_tpu_torch.parallel import tp_megabundle as tp
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.utils import synthetic

    mega = synthetic.megaproblem(scene.calib, MEGA["P"], MEGA["L"],
                                 MEGA["obs_per_lm"], SEED)
    iters = MEGA["iters"]
    ref4 = mega_in_process(tp, make_mesh, mega, scene.calib, MESH_RANKS,
                           iters)
    t0 = time.perf_counter()
    ab = ranks.spawn(ranks_ab, MESH_RANKS, "gloo", "cuda",
                     args=(mega, scene.calib, iters, "gloo"),
                     timeout=RANKS_JOIN_S)
    wall_ab = time.perf_counter() - t0
    check_ranks_ab(ab, ref4, MESH_RANKS, "gloo", card)

    # ---- (c) run_pipeline on 2 ranks --------------------------------------
    paths = (str(tmp / "left.npy"), str(tmp / "right.npy"))
    np.save(paths[0], L)
    np.save(paths[1], R)
    cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(chunk_frames=32))
    t0 = time.perf_counter()
    c = ranks.spawn(ranks_path, 2, "gloo", "cuda",
                    args=(paths, scene.calib, scene.T_w2c, cfg32),
                    timeout=RANKS_JOIN_S)
    wall_c = time.perf_counter() - t0
    ref = mesh_b["result"]
    need = ("detect_maps", "mutual_nearest", "cholesky_solve")
    for r, out in enumerate(c):
        for k in RANK_FE_ARRAYS:
            if not np.array_equal(out[k], getattr(ref.frontend, k)):
                fail(f"mesh ranks (c) rank {r}: the frontend's {k} differs "
                     f"from 4l (b)'s")
        if out["keyframes"] != ref.bundles.keyframes:
            fail(f"mesh ranks (c) rank {r}: keyframes {out['keyframes']}, "
                 f"4l (b) {ref.bundles.keyframes}")
        d_rel = float(np.abs(out["rel_T"] - ref.bundles.rel_T).max())
        if not d_rel <= SLICE_TOL["poses"]:
            fail(f"mesh ranks (c) rank {r}: rel_T {d_rel:.3e} from 4l (b)'s "
                 f"(limit {SLICE_TOL['poses']})")
        d_ate = {k: abs(v - mesh_b["ates"][k]) for k, v in out["ates"].items()}
        if out["ates"].keys() != mesh_b["ates"].keys() or \
                max(d_ate.values()) > 0.01:
            fail(f"mesh ranks (c) rank {r}: ATE {out['ates']}, 4l (b) "
                 f"{mesh_b['ates']} (limit 0.01 m)")
        if any(out["launches"][k] == 0 for k in need) or any(
                out["plain"].values()):
            fail(f"mesh ranks (c) rank {r}: launches {out['launches']}, "
                 f"plain calls {out['plain']}")
        log(f"[mesh ranks] (c) rank {r} on {out['device']}: run_pipeline "
            f"warm {out['wall']:.2f} s (cold {out['cold']:.2f} s; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in out["timings"].items())
            + f"); keypoints and matches equal to 4l (b)'s, keyframes "
            f"equal, rel_T within {d_rel:.3e} (limit {SLICE_TOL['poses']}), "
            f"ATE m {json.dumps(out['ates'])} (differences up to "
            f"{max(d_ate.values()):.2e}), closures {out['closures']}; "
            f"launches {out['launches']} ({card})")

    # ---- (e) the overlap on 2 ranks: a frontend rank and a BA rank --------
    stage = "frontend+bundles_overlapped"
    ref_e = drive_path(pipeline, ck, L, R, scene, cfg, need,
                       "mesh ranks overlap, one process", card,
                       mesh=make_mesh(2), overlap=True)
    t0 = time.perf_counter()
    e = ranks.spawn(ranks_overlap, 2, "gloo", "cuda",
                    args=(paths, scene.calib, scene.T_w2c, cfg),
                    timeout=RANKS_JOIN_S)
    wall_e = time.perf_counter() - t0
    check_overlap_ranks(e, ref_e, "gloo", card)
    in_turn = [sum(out["timings"][k] for k in ("frontend", "trackstore",
                                               "bundles")) for out in c]
    log(f"[mesh ranks] (e) beside it, this call: the one-process overlap "
        f"on 2 shards {ref_e['timings'][stage]:.3f} s; 4m (c)'s stages in "
        f"turn on 2 ranks (frontend + trackstore + bundles, with the TP "
        f"re-solves) {' / '.join(f'{v:.3f}' for v in in_turn)} s (rank 0 / "
        f"1); 4l (c)'s one-process overlap {overlap_med['overlapped']:.3f} s"
        f", its stages in turn {overlap_med['sequential']:.3f} s with the "
        f"TP re-solves and {overlap_med['sequential, no TP']:.3f} s without "
        f"(medians of 3) ({card})")

    # ---- (d) nccl, one rank per card ----------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        nccl_note = nccl_ranks(ck, mega, scene.calib, L, R, scene, cfg, card)
    else:
        nccl_note = (f"not run: the host has {n_cards} card, and nccl takes "
                     f"one card per rank (the kernels on cuda:1 likewise)")
        log(f"[mesh ranks] (d) nccl with one rank per card {nccl_note}")
    log(f"[mesh ranks] spawns joined within {RANKS_JOIN_S:.0f} s: (a) + (b) "
        f"{MESH_RANKS} ranks {wall_ab:.1f} s, (c) 2 ranks {wall_c:.1f} s, "
        f"(e) 2 ranks {wall_e:.1f} s (each with its ranks' start-up and "
        f"imports); (d) {nccl_note} ({card})")


# phase 4n: the single-card step (slam_tpu_torch.entry) and the per-image
# forms. The JAX step's outputs, as jax.eval_shape gives them
# (tests/test_torch_public_ops.py holds the port's step to them on the
# CPU)
ENTRY_OUTPUTS = {"T_rel": ((4, 4, 4), torch.float32),
                 "num_inliers": ((4,), torch.int32)}
ENTRY_RUNS = 5
# the per-image forms run on row PER_IMAGE_ROW of the scene's first
# PER_IMAGE_BATCH left images, the batched forms on all of them
PER_IMAGE_BATCH, PER_IMAGE_ROW = 32, 5


def entry_phase(ck, card) -> None:
    """Phase 4n (a): entry()'s step twice on the card with the launch
    counters zeroed just before: outputs of the JAX step's shapes and
    dtypes, on the card and finite, B1 and B2 launched and no plain
    version; then the median of ENTRY_RUNS warm steps."""
    from slam_tpu_torch.entry import SHAPE, entry

    step, args = entry()
    ck.reset_counters()
    for _ in range(2):
        outs = step(*args)
    torch.cuda.synchronize()
    launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    for (name, (shape, dtype)), x in zip(ENTRY_OUTPUTS.items(), outs):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device.type != "cuda"
                or not torch.isfinite(x.float()).all()):
            fail(f"entry: {name} {tuple(x.shape)} {x.dtype} on {x.device} "
                 f"(want {shape} {dtype} on the card, finite)")
    if not (launches["detect_maps"] and launches["mutual_nearest"]) or any(
            plain.values()):
        fail(f"entry: launches {launches}, plain calls {plain}")
    times = []
    for _ in range(ENTRY_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[entry] slam_tpu_torch.entry: one frontend chunk of {SHAPE} "
        f"stereo frames, T_rel {tuple(outs[0].shape)} {outs[0].dtype}, "
        f"num_inliers {tuple(outs[1].shape)} {outs[1].dtype} "
        f"{outs[1].tolist()}; launches in 2 steps {launches}; median of "
        f"{ENTRY_RUNS} warm steps {float(np.median(times)):.3f} ms (runs "
        f"{[round(v, 3) for v in times]}) ({card})")


def per_image_phase(ck, L, R, cfg, card) -> int:
    """Phase 4n (b): each per-image form on one frame on the card equal bit
    for bit to that row of its batched form; ``detect`` on B4 (one launch
    on a batch of one, no plain call) with xy and valid equal to the
    batched detect_and_describe_batch's row on B1, and B4's response
    against B1's on that frame; match_stereo_pair on that frame pair
    equal to the batched matcher's row. Returns B4's launches on the
    detect path."""
    from slam_tpu_torch.models import frontend
    from slam_tpu_torch.ops import akaze, features, matching, orb, sift

    n, i = PER_IMAGE_BATCH, PER_IMAGE_ROW
    left = torch.from_numpy(np.ascontiguousarray(L[:n])).cuda()
    right = torch.from_numpy(np.ascontiguousarray(R[:n])).cuda()
    forms = {
        "detect_and_describe": (features.detect_and_describe,
                                features.detect_and_describe_batch, {}),
        "detect_and_describe_multiscale": (
            features.detect_and_describe_multiscale,
            features.detect_and_describe_multiscale_batch, {}),
        "detect_and_describe_akaze": (akaze.detect_and_describe_akaze,
                                      akaze.detect_and_describe_akaze_batch,
                                      {}),
        "detect_and_describe_sift": (sift.detect_and_describe_sift,
                                     sift.detect_and_describe_sift_batch,
                                     {"octaves": 4}),
        "detect_and_describe_orb": (orb.detect_and_describe_orb,
                                    orb.detect_and_describe_orb_batch, {}),
    }
    batched = {}
    for name, (one, many, kw) in forms.items():
        a, batched[name] = one(left[i], **kw), many(left, **kw)
        differ = [k for k in a if not torch.equal(a[k], batched[name][k][i])]
        if differ:
            fail(f"per-image {name}: {differ} differ from row {i} of the "
                 f"batched form")
    ck.reset_counters()
    det = features.detect(left[i])
    torch.cuda.synchronize()
    b4, plain = ck.LAUNCHES["harris_response"], dict(ck.PLAIN_CALLS)
    if b4 != 1 or any(plain.values()):
        fail(f"per-image detect: B4 launches {b4}, plain calls {plain}")
    full = batched["detect_and_describe"]
    if not (torch.equal(det["xy"], full["xy"][i])
            and torch.equal(det["valid"], full["valid"][i])):
        fail(f"per-image detect (B4): xy or valid differ from row {i} of "
             f"detect_and_describe_batch (B1)")
    r4, n4 = ck.harris_response(left[i:i + 1])
    r1, n1, _ = ck.detect_maps(left)
    d_resp = float((r4[0] - r1[i]).abs().max())
    same_nms = bool(torch.equal(n4[0], n1[i]))
    win, _ = frontend.search_windows(cfg.matching)
    gate = cfg.matching.max_desc_dist
    feats_r = features.detect_and_describe_batch(right)
    pair = matching.match_stereo_pair(
        {k: v[i] for k, v in full.items()},
        {k: v[i] for k, v in feats_r.items()}, win, gate)
    rows = matching.match_stereo_pair_batched(full, feats_r, win, gate)
    if any(not torch.equal(v, rows[k][i]) for k, v in pair.items()):
        fail(f"per-image match_stereo_pair differs from row {i} of the "
             f"batched matcher")
    log(f"[per-image] row {i} of {n} frames {HW} on the card: "
        f"{', '.join(forms)} and match_stereo_pair ({int(pair['matched'].sum())}"
        f" stereo matches) equal bit for bit to the batched forms' row; "
        f"detect on B4 ({b4} launch, no plain call): {int(det['valid'].sum())}"
        f" keypoints, xy and valid equal to detect_and_describe_batch's on "
        f"B1; B4's response {d_resp:.3e} from B1's at most, NMS map "
        f"{'equal' if same_nms else 'differs'} ({card})")
    return b4


# phase 4o: the main path's graphed functions (runtime.graphs), each of
# which must replay in a warm run of the main path
MAIN_GRAPHS = ("models.frontend._chunk", "ops.ba.solve_windows",
               "models.loop_closure._verify_candidates",
               "ops.pose_graph.optimize", "ops.pose_graph.gate_matrix")
GRAPH_RUNS = 5
# find_loops' split of the loop-closure stage: its child spans
# (PipelineResult.timings and counts, "loop_closure.<name>")
LOOP_SPLIT = ("gate", "optimize", "refine", "verify")
# KITTI 00's keyframe count: the dense pose graph's 704-node bucket
KITTI00_KEYFRAMES = 652
# a graphed pose-graph op against eager (graphs_phase): nodes in m, cost
# and gate distances relative, a distance under 0.01 taken as 0.01
PG_TOL = {"nodes": 1e-3, "cost": 1e-3, "gate": 1e-3}
# solve_windows' rel_cov against a float64 inverse of the same S:
# relative Frobenius norm of each window's block, the largest
COV_TOL = 1e-3


def wall_ms(fn, runs: int = GRAPH_RUNS, warm: int = 2) -> float:
    """Median host ms of fn() up to a synchronize, after ``warm`` calls
    (a graphed function's first call runs eagerly, its second captures)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def enqueue_ms(fn, runs: int = GRAPH_RUNS) -> float:
    """Median host ms of fn() without waiting for the device: what the
    caller's thread spends to launch it (a warm call; the device drained
    before each)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def busy_ms(fn, runs: int = 3):
    """Device busy ms per call of fn(): the union of the device events'
    intervals in a torch.profiler trace of ``runs`` warm calls (after a
    lead call, ``traced_window``); None when the trace holds no device
    event."""
    _, dev = traced_window(lambda: [fn() for _ in range(runs)], fn)
    if not dev:
        return None
    merged = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    return _covered(merged, -float("inf"), float("inf")) * 1e-3 / runs


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def tensors_of(x) -> list:
    """The tensors of a nest of dicts, tuples and lists, in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors_of(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(v)]
    return []


def stats_delta(after: dict, before: dict) -> dict:
    keys = ("warmups", "captures", "replays")
    return {name: {k: st[k] - before.get(name, {}).get(k, 0) for k in keys}
            for name, st in after.items()
            if any(st[k] != before.get(name, {}).get(k, 0) for k in keys)}


def graphs_phase(pipeline, ck, graphs, L, R, scene, cfg, card) -> None:
    """Phase 4o (module docstring): the main path's CUDA graphs against
    eager runs, per function and end to end."""
    from slam_tpu_torch.models import bundle, frontend, loop_closure
    from slam_tpu_torch.ops import ba, se3
    from slam_tpu_torch.ops import pose_graph as pg_ops
    from slam_tpu_torch.ops import ransac as ransac_ops
    from slam_tpu_torch.ops import stereo as stereo_ops

    t_phase = time.perf_counter()
    calib_t = torch.tensor(scene.calib, device="cuda")
    graphs.clear()

    # ---- (c), (e) the main path under eager() and with graphs ------------
    inv_ex = torch.linalg.inv_ex
    inv_calls = [0]

    def counted_inv_ex(*a, **kw):
        # Python calls only: a graph's replay calls no Python
        inv_calls[0] += 1
        return inv_ex(*a, **kw)

    def run(trace=False):
        torch.cuda.synchronize()
        ck.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        before = graphs.stats()
        inv_calls[0] = 0
        torch.linalg.inv_ex = counted_inv_ex
        try:
            t0 = time.perf_counter()
            res, traced, names = traced_launches(
                lambda: pipeline.run_pipeline(L, R, scene.calib, cfg,
                                              verbose=False, device="cuda"),
                ck.reset_counters) if trace \
                else (pipeline.run_pipeline(L, R, scene.calib, cfg,
                                            verbose=False, device="cuda"),
                      None, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.linalg.inv_ex = inv_ex
        rep = pipeline.evaluate(res, scene.T_w2c)
        return {"result": res, "wall": wall, "launches": dict(ck.LAUNCHES),
                "traced": traced, "names": names,
                "plain": dict(ck.PLAIN_CALLS),
                "peak": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved(),
                "stats": stats_delta(graphs.stats(), before),
                "inv_ex": inv_calls[0],
                "split": {k: (res.timings.get(f"loop_closure.{k}", 0.0),
                              res.counts["spans"].get(f"loop_closure.{k}", 0))
                          for k in LOOP_SPLIT},
                "ates": {k: rep[k]["ate_rmse_m"] for k in STAGE_ATES
                         if k in rep},
                "closures": [(c.frame_i, c.frame_j) for c in res.closures]}

    with graphs.eager():
        run()
        eager = run()
    # warm-ups, captures, replays; then one more under torch.profiler
    graphed = [run() for _ in range(3)] + [run(trace=True)]
    warm, traced = graphed[2:]
    n_frames = L.shape[0]
    labels = ["eager"] + [f"graphed run {i + 1}" for i in range(3)] + [
        "graphed runs 4 and 5 (under torch.profiler, launches of run 5)"]
    for label, r in zip(labels, [eager] + graphed):
        t = r["result"].timings
        log(f"[graphs] (c) main path {label}: wall {r['wall']:.3f} s, stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
            + f"; frontend {n_frames / t['frontend']:.1f} frames/s; ATE m "
            f"{json.dumps(r['ates'])}; closures {r['closures']}; launches "
            f"{r['launches']}; graphs {json.dumps(r['stats'])} ({card})")
        log(f"[graphs] (c) loop closure split {label} (find_loops' "
            f"spans): " + ", ".join(f"{k} {s:.4f} s x{n}"
                                    for k, (s, n) in r["split"].items())
            + f"; torch.linalg.inv_ex called from Python {r['inv_ex']} "
            f"times ({card})")
        if any(r["plain"].values()):
            fail(f"graphs (c) {label}: a plain version ran: {r['plain']}")
        if r["launches"] != eager["launches"]:
            fail(f"graphs (c) {label}: launches {r['launches']}, under "
                 f"eager() {eager['launches']}")
        for k, v in r["ates"].items():
            if not (np.isfinite(v) and v < 1.0):
                fail(f"graphs (c) {label}: ATE {k} = {v} m (limit 1.0 m)")
        if r["closures"] != eager["closures"] or not r["closures"]:
            fail(f"graphs (c) {label}: closures {r['closures']}, under "
                 f"eager() {eager['closures']}")
        d_ate = max(abs(r["ates"][k] - v) for k, v in eager["ates"].items())
        if not d_ate <= 0.01:
            fail(f"graphs (c) {label}: ATE {r['ates']} vs eager "
                 f"{eager['ates']} (limit 0.01 m apart)")
    n_closures = len(warm["closures"])
    # per run: the window batch and each closure's pair; the initial gate
    # and one refresh and one re-optimisation per closure
    needs = {"ops.ba.solve_windows": 1 + n_closures,
             "ops.pose_graph.gate_matrix": 1 + n_closures,
             "ops.pose_graph.optimize": n_closures}
    for name in MAIN_GRAPHS:
        st = warm["stats"].get(name, {})
        need = needs.get(name, 1)
        if st.get("replays", 0) < need:
            fail(f"graphs (c): {name} replayed {st.get('replays', 0)} times "
                 f"in the warm run (want >= {need}): {warm['stats']}")
    if any(st["warmups"] or st["captures"]
           for st in traced["stats"].values()):
        fail(f"graphs (c): the traced run warmed up or captured: "
             f"{traced['stats']}")
    if warm["inv_ex"] or traced["inv_ex"]:
        fail(f"graphs (c): torch.linalg.inv_ex ran outside a graph in the "
             f"warm runs ({warm['inv_ex']}, {traced['inv_ex']} calls)")
    if any(traced["traced"][k] != traced["launches"][k]
           for k in TRACE_NAMES):
        fail(f"graphs (c): the traced run counted {traced['launches']}, its "
             f"trace holds {traced['traced']} ({traced['names']})")
    log(f"[graphs] (c) graphed runs 4 and 5, every graph replaying, under "
        f"torch.profiler: run 5's launches counted {traced['launches']}, in "
        f"the trace by device function {traced['names']} ({card})")
    pools = {n: st["pool_bytes"] for n, st in graphs.stats().items()
             if st["pool_bytes"]}
    log(f"[graphs] (c) warm run: every main-path function replayed "
        f"({', '.join(MAIN_GRAPHS)}); launches equal under eager() and "
        f"with graphs: {eager['launches']}; graphs.stats() "
        f"{json.dumps(graphs.stats())} ({card})")
    gib = 2.0 ** 30
    log(f"[graphs] (e) peak device memory of the main path: eager "
        f"{eager['peak'] / gib:.3f} GiB allocated, "
        f"{eager['reserved'] / gib:.3f} GiB reserved; graphed (warm run) "
        f"{warm['peak'] / gib:.3f} GiB "
        f"allocated, {warm['reserved'] / 2**30:.3f} GiB reserved; capture "
        f"pools {sum(pools.values()) / 2**30:.3f} GiB in all, by function "
        f"{json.dumps({k: round(v / 2**20, 1) for k, v in pools.items()})} "
        f"MiB ({card})")

    # ---- (a), (b) per function: graph against eager, times ----------------
    res = eager["result"]
    fe, db = res.frontend, res.db

    def timed(label, fn, fn_new, check, busy_runs=3):
        """fn under eager() and graphed (two calls, then warm), each
        compared by ``check``; fn_new, new inputs of the same shapes, the
        same; then the times (device busy over ``busy_runs`` calls: a
        trace of several eager LM runs, ~12k launches each, lost a
        marker kernel)."""
        with graphs.eager():
            want, want_new = fn(), fn_new()
        got = [fn() for _ in range(3)]
        got_new = fn_new()
        diffs = [check(g, want) for g in got] + [check(got_new, want_new)]
        with graphs.eager():
            e_wall = wall_ms(fn, warm=1)
            e_host = enqueue_ms(fn)
            e_busy = busy_ms(fn, runs=busy_runs)
        g_wall = wall_ms(fn)
        g_busy = busy_ms(fn, runs=busy_runs)
        g_host = enqueue_ms(fn)
        log(f"[graphs] (a) {label}: graphed against eager {diffs[-2]}, on "
            f"new inputs {diffs[-1]}; (b) median of {GRAPH_RUNS} wall: eager "
            f"{e_wall:.3f} ms (host to launch {e_host:.3f} ms), graphed "
            f"{g_wall:.3f} ms (host to launch {g_host:.3f} ms); device busy "
            f"eager {fmt_ms(e_busy)}, graphed {fmt_ms(g_busy)} ({card})")

    def bitwise(a, b):
        ta, tb = tensors_of(a), tensors_of(b)
        if len(ta) != len(tb) or not all(
                x.shape == y.shape and torch.equal(x, y)
                for x, y in zip(ta, tb)):
            fail("graphs (a): a frontend output differs from eager (limit: "
                 "equal bit for bit, as same_frontend)")
        return f"equal bit for bit ({len(ta)} tensors; limit: equal)"

    chunk = cfg.runtime.chunk_frames

    def chunk_imgs(i):
        sl = slice(i * chunk, (i + 1) * chunk)
        return tuple(torch.from_numpy(np.ascontiguousarray(x[sl])).cuda()
                     for x in (L, R))

    def process(imgs, carry, i):
        # a generator made anew per call: eager and graphed draw the same
        return frontend.process_chunk(*imgs, carry, calib_t, cfg,
                                      frontend.chunk_generator(cfg, i,
                                                               "cuda"))

    c0, c1 = chunk_imgs(0), chunk_imgs(1)
    with graphs.eager():
        _, carry0 = process(c0, None, 0)
        _, carry1 = process(c1, carry0, 1)
    timed(f"frontend chunk (process_chunk, {chunk} frames {HW}, with a "
          f"carry)", lambda: process(c1, carry0, 1),
          lambda: process(c0, carry1, 2), bitwise)
    timed(f"recompute_descriptors ({chunk} frames)",
          lambda: frontend.recompute_descriptors(*c1, cfg),
          lambda: frontend.recompute_descriptors(*c0, cfg), bitwise)

    def windows_close(a, b):
        d_pose = float((a[0] - b[0]).abs().max())
        d_rel = float((a[5] - b[5]).abs().max())
        d_cost = float(((a[3] - b[3]).abs() / b[3].abs().clamp(
            min=1e-12)).max())
        d_cov = float((a[6] - b[6]).norm() / b[6].norm())
        if not (max(d_pose, d_rel) <= SLICE_TOL["poses"]
                and d_cost <= SLICE_TOL["cost"]):
            fail(f"graphs (a): windows poses {d_pose:.3e} / rel_T "
                 f"{d_rel:.3e} (limit {SLICE_TOL['poses']}), cost "
                 f"{d_cost:.3e} relative (limit {SLICE_TOL['cost']})")
        return (f"poses {d_pose:.3e}, rel_T {d_rel:.3e} (limit "
                f"{SLICE_TOL['poses']}), cost {d_cost:.3e} relative (limit "
                f"{SLICE_TOL['cost']}), rel_cov {d_cov:.3e} relative "
                f"Frobenius (no limit)")

    bc = cfg.bundle
    batch = bundle.build_windows(db, fe.T_w2c, res.bundles.keyframes, bc)
    bundle.init_landmarks(batch, scene.calib)
    B = batch.num_windows
    step = bundle.window_step(scene.calib, torch.device("cuda"),
                              iters=bc.lm_iters, min_depth=bc.min_depth,
                              max_depth=bc.max_depth,
                              huber_delta=bc.huber_delta_px)
    inp = bundle.window_inputs(batch, 0, B, B)
    inp_new = tuple(np.ascontiguousarray(a[::-1]) for a in inp)
    timed(f"window BA (window_step: solve_windows, {B} windows, P="
          f"{bc.max_poses}, L={bc.max_landmarks}, M={bc.max_obs}, 2 x "
          f"{bc.lm_iters} LM iterations and the covariances)",
          lambda: step(*inp), lambda: step(*inp_new), windows_close,
          busy_runs=1)

    # the whole solve_windows on the batch's device inputs (no uploads)
    win_t = tuple(torch.as_tensor(np.ascontiguousarray(a), device="cuda",
                                  dtype=torch.int64 if k in (2, 3, 6)
                                  else None)
                  for k, a in enumerate(inp[:6] + (inp[6] - 1,)))

    def solve(w_):
        return ba.solve_windows(*w_, calib_t, iters=bc.lm_iters,
                                min_depth=bc.min_depth,
                                max_depth=bc.max_depth,
                                huber_delta=bc.huber_delta_px)

    win_new = tuple(t.flip(0) for t in win_t)
    timed(f"solve_windows alone ({B} windows on the device: the LM, the "
          f"depth prunes, the covariances' LU inverses and the "
          f"gathers, one graph)", lambda: solve(win_t),
          lambda: solve(win_new), windows_close, busy_runs=1)

    def recorded_solve(call):
        """The arguments of the one ba.solve_windows call in call()."""
        seen, orig = [], ba.solve_windows

        def rec(*a, **kw):
            seen.append((a, kw))
            return orig(*a, **kw)

        ba.solve_windows = rec
        try:
            call()
        finally:
            ba.solve_windows = orig
        return seen[0]

    def cov_against_float64(label, call):
        """solve_windows' rel_cov from its graph against the float64
        inverse of the same S (ba._covariance_system at the graph's
        result, eager, outside any graph); beside it, the eager
        _marginals of that S (the graph's algorithm: an LU inverse per
        window) and a float32 Cholesky inverse (cholesky_ex, then
        solve_triangular(L, I)), against the same float64 inverse."""
        a, kw = recorded_solve(call)
        out = ba.solve_windows(*a, **kw)
        _, _, ci, li, meas, _, last, cal = a
        S = ba._covariance_system(out[0], out[1], ci, li, meas, out[2], cal)
        Bw, P = S.shape[0], S.shape[1] // 6
        b = torch.arange(Bw, device=S.device)

        def blocks(C):
            return C.reshape(Bw, P, 6, P, 6)[b, last, :, last, :].double()

        want = blocks(torch.linalg.inv(S.double()))

        def err(got):
            return float(((got.double() - want).flatten(1).norm(dim=1)
                          / want.flatten(1).norm(dim=1)).max())

        e_graph = err(out[6])
        e_lu = err(ba._marginals(S)[b, last])
        L_, info = torch.linalg.cholesky_ex(S)
        X = torch.linalg.solve_triangular(
            L_, torch.eye(6 * P, device=S.device).expand_as(S), upper=False)
        e_ch = err(blocks(X.transpose(-1, -2) @ X))
        finite = bool(torch.isfinite(out[6]).all())
        line = (f"{label} {tuple(S.shape)}: rel_cov against float64 "
                f"inv(S), largest relative Frobenius: graphed {e_graph:.3e}"
                f", eager _marginals(S) {e_lu:.3e} (limit {COV_TOL} each), "
                f"float32 Cholesky {e_ch:.3e} (no limit; fails on "
                f"{int((info > 0).sum())} of {Bw}); finite {finite}")
        if not (finite and e_graph <= COV_TOL and e_lu <= COV_TOL):
            fail(f"graphs (a): {line}")
        log(f"[graphs] (a) {line} ({card})")

    cov_against_float64(f"window BA ({B} windows)", lambda: solve(win_t))

    # the pose graph's two graphed ops on the main path, at the scene's
    # bucket, then at KITTI 00's (N = 652: the 704-node bucket)
    def pose_graph_timed(g, nodes_new, where, unpadded=False):
        args, n_valid = g._dense_args()
        N = g.num_nodes
        nodes_p = args[0].clone()
        nodes_p[:N] = torch.as_tensor(nodes_new, device="cuda")
        new = (nodes_p,) + tuple(args[1:])
        ii, jj = np.tril_indices(N, k=-1)
        P = len(ii)
        pairs = tuple(torch.as_tensor(x, device="cuda")
                      for x in g._padded_pairs(jj, ii))
        cap = len(pairs[0])
        before = graphs.stats()

        def opt(a, nv=n_valid):
            return pg_ops.optimize(*a, iters=15, n_valid=nv)

        def gate(a):
            return pg_ops.gate_matrix(*a, *pairs, n_valid=n_valid)

        def opt_diff(a, b):
            return (float((a[0][:N] - b[0][:N]).abs().max()),
                    float((a[1] - b[1]).abs() / b[1].abs().clamp(min=1e-12)))

        def gate_diff(a, b):
            fa, fb = torch.isfinite(a[:P]), torch.isfinite(b[:P])
            f = fa & fb
            return (int((fa != fb).sum()),
                    float(((a[:P][f] - b[:P][f]).abs()
                           / b[:P][f].abs().clamp(min=1e-2)).max()))

        # H is assembled in a fixed order (ops/pose_graph.py _assemble):
        # graphed is held to eager at PG_TOL and the same pairs failing
        # closed, the spread of two eager runs printed beside it
        with graphs.eager():
            sp_o = [opt_diff(opt(x), opt(x)) for x in (args, new)]
            sp_g = [gate_diff(gate(x), gate(x)) for x in (args, new)]
        spread = (f"two eager runs: nodes {max(d[0] for d in sp_o):.3e}, "
                  f"cost {max(d[1] for d in sp_o):.3e}, "
                  f"{max(d[0] for d in sp_g)} pairs failing closed in one "
                  f"only, distances {max(d[1] for d in sp_g):.3e}")

        def nodes_close(a, b):
            d, c = opt_diff(a, b)
            if not (d <= PG_TOL["nodes"] and c <= PG_TOL["cost"]):
                fail(f"graphs (a): pose graph {where}: nodes {d:.3e} (limit "
                     f"{PG_TOL['nodes']}), cost {c:.3e} relative (limit "
                     f"{PG_TOL['cost']}; {spread})")
            return (f"nodes {d:.3e} (limit {PG_TOL['nodes']}), cost {c:.3e} "
                    f"relative (limit {PG_TOL['cost']}; {spread})")

        def dist_close(a, b):
            flips, d = gate_diff(a, b)
            if not (flips == 0 and d <= PG_TOL["gate"]):
                fail(f"graphs (a): gate {where}: {flips} pairs fail closed "
                     f"on one side only (limit 0), distances {d:.3e} "
                     f"relative (limit {PG_TOL['gate']}; {spread})")
            return (f"{flips} of {P} pairs fail closed on one side only "
                    f"(limit 0), {int((~torch.isfinite(b[:P])).sum())} in "
                    f"eager's; distances {d:.3e} relative (limit "
                    f"{PG_TOL['gate']})")

        e_cap = int(args[1].shape[0])
        timed(f"pose graph LM (ops.pose_graph.optimize, {where}: N={N} in "
              f"the {len(args[0])}-node bucket, E={g.num_edges} in the "
              f"{e_cap}-edge bucket, 15 LM iterations)", lambda: opt(args),
              lambda: opt(new), nodes_close, busy_runs=1)
        if unpadded:
            # the same LM with the nodes unpadded (the edges still in their
            # bucket): what the node bucket costs on the device
            args_u, nv_u = (args[0][:N],) + tuple(args[1:]), n_valid[:N]
            d_u, c_u = opt_diff(opt(args_u, nv=nv_u), opt(args))
            u_wall = wall_ms(lambda: opt(args_u, nv=nv_u))
            u_busy = busy_ms(lambda: opt(args_u, nv=nv_u), runs=1)
            p_wall = wall_ms(lambda: opt(args))
            p_busy = busy_ms(lambda: opt(args), runs=1)
            log(f"[graphs] (a) pose graph LM {where}, graphed, 15 LM "
                f"iterations: nodes unpadded (N={N}, E bucket {e_cap}) "
                f"{u_wall:.3f} ms wall, device busy {fmt_ms(u_busy)}; in "
                f"the {len(args[0])}-node bucket {p_wall:.3f} ms wall, "
                f"device busy {fmt_ms(p_busy)} (median of {GRAPH_RUNS}); "
                f"unpadded against bucket: nodes {d_u:.3e}, cost {c_u:.3e} "
                f"relative ({card})")
        timed(f"posterior refresh + gate (ops.pose_graph.gate_matrix, "
              f"{where}: {P} pairs in the {cap}-pair bucket)",
              lambda: gate(args), lambda: gate(new), dist_close)
        after = graphs.stats()
        grew = {n: after[n]["pool_bytes"] - before.get(n, {}).get(
            "pool_bytes", 0) for n in ("ops.pose_graph.optimize",
                                       "ops.pose_graph.gate_matrix")}
        log(f"[graphs] (a) pose graph {where}: capture pools grew by "
            f"{json.dumps({k: round(v / 2**20, 1) for k, v in grew.items()})}"
            f" MiB; keys {json.dumps({n: after[n]['keys'] for n in grew})} "
            f"({card})")

    g_lc = res.pose_graph_pre_lc.copy()
    for c_ in res.closures:
        g_lc.add_edge(c_.kf_i, c_.kf_j, c_.rel_T, c_.rel_cov, loop=True)
    pose_graph_timed(g_lc, res.pose_graph.nodes,
                     "the scene's graph with its closures", unpadded=True)
    g_k = stiff_loop_graph(KITTI00_KEYFRAMES, "cuda",
                           loops=((100, 600), (300, 640)))
    xi = np.zeros((KITTI00_KEYFRAMES, 6), np.float32)
    xi[1:, 3:] = np.random.default_rng(SEED).normal(
        0, 0.01, (KITTI00_KEYFRAMES - 1, 3))
    pose_graph_timed(g_k, se3.retract(torch.from_numpy(g_k.nodes),
                                      torch.from_numpy(xi)).numpy(),
                     f"KITTI 00's {KITTI00_KEYFRAMES} keyframes")

    kfs = list(res.bundles.keyframes)
    C, Q = cfg.loop.max_candidates, loop_closure.SPEC_Q
    K = cfg.features.max_kp

    def verify_args(q_frames, c_frames):
        f_q = np.repeat(q_frames, C)
        f_c = np.resize(np.asarray(c_frames), Q * C)
        u = ransac_ops.hypothesis_uniforms(
            Q * C, K, cfg.ransac.num_hypotheses,
            torch.Generator(device="cuda").manual_seed(SEED), "cuda")

        def dev(x):
            return torch.as_tensor(x, device="cuda")

        return (fe.desc[f_q], dev(fe.valid[f_q]), dev(db.links[f_q]),
                dev(db.link_valid[f_q]), fe.desc[f_c], dev(fe.valid[f_c]),
                dev(db.links[f_c]), dev(db.link_valid[f_c]), calib_t, u,
                cfg.ransac.threshold_px)

    v_args = verify_args(kfs[-Q:], kfs[:C])
    v_new = verify_args(kfs[-2 * Q:-Q], kfs[1:C + 1])

    def verify_close(a, b):
        same = all(torch.equal(a[k], b[k])
                   for k in ("num_inliers", "ok", "match_tgt", "inliers"))
        d_T = float((a["T"] - b["T"]).abs().max())
        if not same or not d_T <= SLICE_TOL["poses"]:
            fail(f"graphs (a): verification inliers equal {same}, T "
                 f"{d_T:.3e} (limit {SLICE_TOL['poses']})")
        return (f"inliers and matches equal, T {d_T:.3e} (limit "
                f"{SLICE_TOL['poses']})")

    timed(f"loop verification (_verify_candidates, {Q} x {C} pairs, K={K}, "
          f"{cfg.ransac.num_hypotheses} hypotheses)",
          lambda: loop_closure._verify_candidates(*v_args),
          lambda: loop_closure._verify_candidates(*v_new), verify_close)

    # the pair refinement on the first closure's own correspondences
    cl = res.closures[0]
    with graphs.eager():
        vr = loop_closure._verify_candidates(*verify_args(
            [cl.frame_j] * Q, [cl.frame_i] * C))
    inl, tgt = vr["inliers"][0].cpu().numpy(), vr["match_tgt"][0].cpu().numpy()
    T0 = vr["T"][0].cpu().numpy()
    T0_new = T0.copy()
    T0_new[:3, 3] += 0.05

    def refine(T_init):
        return loop_closure._refine_pair(
            db.links[cl.frame_i], db.links[cl.frame_j], inl, tgt, T_init,
            scene.calib, calib_t, max_landmarks=bc.max_landmarks)

    def pair_close(a, b):
        d_T = float(np.abs(a[0] - b[0]).max())
        d_cov = float(np.linalg.norm(a[1] - b[1]) / np.linalg.norm(b[1]))
        if not d_T <= SLICE_TOL["poses"]:
            fail(f"graphs (a): pair rel_T {d_T:.3e} (limit "
                 f"{SLICE_TOL['poses']})")
        return (f"rel_T {d_T:.3e} (limit {SLICE_TOL['poses']}), rel_cov "
                f"{d_cov:.3e} relative Frobenius (no limit)")

    timed(f"pair refinement (_refine_pair: solve_windows at (1, 2, "
          f"{bc.max_landmarks}), 2 x 15 LM iterations, {int(inl.sum())} "
          f"inliers; with its uploads and read-back)", lambda: refine(T0),
          lambda: refine(T0_new), pair_close)
    cov_against_float64("pair refinement", lambda: refine(T0))

    # ---- (d) phase 4e's optimize_bundle at B = 64 --------------------------
    win = synthetic_windows(se3, stereo_ops, calib_t, 64, bc.max_poses,
                            bc.max_landmarks, bc.max_obs, SEED)
    it = bc.lm_iters

    def ob():
        return ba.optimize_bundle(*win, calib_t, iters=it)

    with graphs.eager():
        want = ob()
        e_ms = wall_ms(ob, runs=3, warm=1) / it
        e_host = enqueue_ms(ob, runs=3) / it
        e_busy = busy_ms(ob, runs=1)
    got = [ob() for _ in range(3)]
    d_cost = float(((got[-1][2] - want[2]).abs() / want[2]).max())
    d_pose = float((got[-1][0] - want[0]).abs().max())
    if not (d_cost <= SLICE_TOL["cost"] and d_pose <= SLICE_TOL["poses"]):
        fail(f"graphs (d): optimize_bundle graphed vs eager: cost "
             f"{d_cost:.3e} relative (limit {SLICE_TOL['cost']}), poses "
             f"{d_pose:.3e} (limit {SLICE_TOL['poses']})")
    g_ms = wall_ms(ob, runs=3) / it
    g_host = enqueue_ms(ob, runs=3) / it
    g_busy = busy_ms(ob, runs=1)
    e_busy, g_busy = (None if b_ is None else b_ / it
                      for b_ in (e_busy, g_busy))
    log(f"[graphs] (d) optimize_bundle (64, P={bc.max_poses}, "
        f"L={bc.max_landmarks}, M={bc.max_obs}), {it} iterations, ms per LM "
        f"iteration (median of 3): eager {e_ms:.3f} wall, {e_host:.3f} host "
        f"to launch, device busy {fmt_ms(e_busy)}; graphed {g_ms:.3f} wall, "
        f"{g_host:.3f} host to launch, device busy {fmt_ms(g_busy)}; graphed "
        f"vs eager "
        f"cost {d_cost:.3e} relative (limit {SLICE_TOL['cost']}), poses "
        f"{d_pose:.3e} (limit {SLICE_TOL['poses']}) ({card})")
    del win, got, want
    graphs.clear()
    log(f"[graphs] phase 4o took {time.perf_counter() - t_phase:.1f} s "
        f"({card})")


# the benchmark's configurations (slambench/configs), each at its own K,
# and the replays of each one's chunk graph that phase 4p times
BENCH_CONFIGS = ("kitti00_harris", "kitti00_akaze", "kitti00_sift")
STAMP_RUNS = 5


def bench_config(name: str):
    """The port's SlamConfig of one benchmark configuration file."""
    from slam_tpu_torch.config import SlamConfig

    spec = json.loads((Path(__file__).resolve().parent / "slambench"
                       / "configs" / f"{name}.json").read_text())
    return SlamConfig.from_json(json.dumps(spec["settings"]))


def stamp_phase(ck, frontend, graphs, L, R, scene, card) -> None:
    """Phase 4p (module docstring): the frontend chunk's clock stamps in
    its replayed graph against CUDA events, at each benchmark
    configuration's chunk."""
    from slam_tpu_torch.ops import ransac as ransac_ops

    calib_t = torch.tensor(scene.calib, device="cuda")
    for name in BENCH_CONFIGS:
        graphs.clear()
        cfg = bench_config(name)
        n, fc = cfg.runtime.chunk_frames, cfg.features
        c0, c1 = (tuple(torch.from_numpy(np.ascontiguousarray(
            x[i * n:(i + 1) * n])).cuda() for x in (L, R)) for i in (0, 1))
        u = ransac_ops.hypothesis_uniforms(
            n, fc.max_kp, cfg.ransac.num_hypotheses,
            torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        _, carry, _ = frontend._chunk(*c0, None, calib_t, u, cfg)
        args = (*c1, carry, calib_t, u, cfg)
        for _ in range(2):  # the warm-up, then the capture
            frontend._chunk(*args)
        torch.cuda.synchronize()
        ck.reset_counters()
        replays = frontend._chunk.replays
        spans, feats, events = [], [], []
        for _ in range(STAMP_RUNS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            st = frontend._chunk(*args)[2]
            ev[1].record()
            torch.cuda.synchronize()
            st = st.cpu()
            if not bool((st[1:] > st[:-1]).all()):
                fail(f"stamp {name}: the stamps {st.tolist()} do not rise "
                     f"within a replay")
            spans.append(int(st[2] - st[0]))
            feats.append(int(st[1] - st[0]))
            events.append(ev[0].elapsed_time(ev[1]) * 1e6)
        replays = frontend._chunk.replays - replays
        if replays != STAMP_RUNS or ck.LAUNCHES["stamp"] != 3 * replays:
            fail(f"stamp {name}: {ck.LAUNCHES['stamp']} stamps in "
                 f"{replays} replays of {STAMP_RUNS} calls (want 3 each)")
        span_ms = float(np.median(spans)) * 1e-6
        event_ms = float(np.median(events)) * 1e-6
        log(f"[stamp] {name} chunk ({n} frames {HW}, K {fc.max_kp}, "
            f"{fc.detector}) median of {STAMP_RUNS} replays: stamps "
            f"{span_ms:.3f} ms (features "
            f"{float(np.median(feats)) * 1e-6:.3f} ms, "
            f"{100.0 * np.median(feats) / np.median(spans):.1f} %), "
            f"CUDA events {event_ms:.3f} ms, stamps / events "
            f"{span_ms / event_ms:.4f} (limit 0.9-1.1); launches "
            f"{ck.LAUNCHES['stamp']} ({card})")
        if not abs(span_ms - event_ms) <= 0.1 * event_ms:
            fail(f"stamp {name}: the stamps' span {spans} ns against CUDA "
                 f"events {events} ns (limit 10 % of the events)")
        del c0, c1, u, carry, args
    graphs.clear()


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
    from slam_tpu_torch.runtime import graphs
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
        {"name": "schur_reduce", "route": "cuda",
         "source": "slam_tpu_torch/csrc/schur_reduce.cu",
         "replaces": "no TPU kernel (plain jnp in slam_tpu/ops/ba.py)",
         "max_abs_err": b7_err, "ms": b7_ms, "plain_ms": b7_plain_ms},
    ]
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k.setdefault("library_ms", None)
    if args.kernels_only:
        # no main-path run, so no launch counts to report
        log(json.dumps({"ok": True, "kernels_only": True}))
        return 0

    # ---- 4. main path -------------------------------------------------------
    # the default SlamConfig(), from CUDA graphs; ba._spd_solve is wrapped
    # to count the counted pass's LM iterations by shape, each of which
    # launches B6 once. The graphs are captured calling the wrapper, with
    # its counter in graphs.COUNTERS, so each replay adds its capture's
    # counts to it as to the launches (the wrapper launches what B6 does).
    # ba._covariance_system is counted the same way: B7 launches once per
    # LM iteration and once per covariance system
    solves = collections.Counter()
    covs = collections.Counter()
    b6_solve = ba._spd_solve
    cov_system = ba._covariance_system

    def counting(S, g):
        solves[tuple(S.shape)] += 1
        return b6_solve(S, g)

    def counting_covs(*a, **kw):
        covs["systems"] += 1
        return cov_system(*a, **kw)

    chunk_replays = [0]

    def reset_counts():
        solves.clear()
        covs.clear()
        chunk_replays[0] = frontend._chunk.replays

    graphs.clear()
    ba._spd_solve = counting
    ba._covariance_system = counting_covs
    graphs.COUNTERS.extend((solves, covs))
    try:
        main_path = drive_path(
            pipeline, ck, L, R, scene, cfg,
            ("detect_maps", "mutual_nearest", "cholesky_solve",
             "schur_reduce"), "path", card, on_reset=reset_counts,
            trace=True)
    finally:
        ba._spd_solve = b6_solve
        ba._covariance_system = cov_system
        graphs.COUNTERS.remove(solves)
        graphs.COUNTERS.remove(covs)
    b6_launches = main_path["launches"]["cholesky_solve"]
    if b6_launches != sum(solves.values()):
        fail(f"path: {b6_launches} B6 launches for {dict(solves)} LM "
             f"iterations")
    b7_launches = main_path["launches"]["schur_reduce"]
    if b7_launches != b6_launches + covs["systems"]:
        fail(f"path: {b7_launches} B7 launches for {b6_launches} LM "
             f"iterations and {covs['systems']} covariance systems")
    log(f"[B7] main path: {b7_launches} launches, one per LM iteration "
        f"({b6_launches}) and per covariance system ({covs['systems']}) "
        f"({card})")
    # the launches of the last counted pass (the traced one: equal to the
    # measured pass's) against its chunk graph's replays
    n_chunks = frontend._chunk.replays - chunk_replays[0]
    stamps = main_path["launches"]["stamp"]
    if n_chunks == 0 or stamps != 3 * n_chunks:
        fail(f"path: {stamps} clock stamps for {n_chunks} replays of the "
             f"frontend chunk's graph (want 3 per replay)")
    log(f"[stamp] main path: {stamps} launches, 3 per replay of the "
        f"frontend chunk's graph ({n_chunks}) ({card})")
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
         "cholesky_solve"), "path akaze", card, trace=True)["launches"]
    graphs.clear()  # AKAZE's graphs: none of the later phases

    # ---- 4c. multiscale Harris ----------------------------------------------
    # B1 at every pyramid level; the level shapes are recorded through the
    # wrapper, which features looks up at each call
    cfg_ms = SlamConfig(features=FeatureConfig(num_levels=2))
    shapes = set()
    detect_maps = ck.detect_maps

    def recording(imgs, *a, **kw):
        shapes.add(tuple(imgs.shape))
        return detect_maps(imgs, *a, **kw)

    # eagerly: a graph's replay would not call the recording wrapper
    ck.detect_maps = recording
    try:
        with graphs.eager():
            frontend.run_frontend(L, R, scene.calib, cfg_ms, device="cuda")
            torch.cuda.synchronize()
            shapes.clear()
            ck.reset_counters()
            t0 = time.perf_counter()
            fr = frontend.run_frontend(L, R, scene.calib, cfg_ms,
                                       device="cuda")
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
    at_tp, mesh_b, overlap_med = mesh_phase(pipeline, ck, ba, bundle, L, R,
                                            scene, cfg, main_path, card)
    # ---- 4m. the mesh over ranks --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        mesh_ranks_phase(ck, L, R, scene, cfg, mesh_b, overlap_med, card,
                         Path(tmp))

    # ---- 4n. entry() and the per-image forms --------------------------------
    entry_phase(ck, card)
    b4_detect = per_image_phase(ck, L, R, cfg, card)

    # ---- 4o. the CUDA graphs ------------------------------------------------
    graphs_phase(pipeline, ck, graphs, L, R, scene, cfg, card)

    # ---- 4p. the frontend chunk's clock stamps ------------------------------
    stamp_phase(ck, frontend, graphs, L, R, scene, card)

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
    # each kernel's launches in the path that runs it; B4's on the
    # per-image detect path, beside its launches in phase 2b
    counts = dict(main_path["launches"], orientation_maps=launches_akaze[
        "orientation_maps"], akaze_octave=launches_akaze["akaze_octave"],
        harris_response=b4_detect)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["name"] == "harris_response":
            k["launches_phase_2b"] = b4_launches
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
