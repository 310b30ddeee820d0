"""GPU smoke test of slam_tpu_torch: kernels against their plain versions,
then the pipeline's main path end to end on the card.

    python3 chip_smoke.py                # every phase (one CUDA card)
    python3 chip_smoke.py --kernels-only # phases 1-3: build + kernel checks
    python3 chip_smoke.py --profile DIR  # + phase 5, written to DIR

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device: a CUDA card is required; prints the card's name and power
     limit, builds the kernels from csrc/ with nvcc and times the build;
  2. kernel B1 (detect_maps) against its plain version on the card, at
     the frontend's shape (64 rendered images of 376x1241), on 4 of them
     and at an odd size, with stated tolerances, then the median time of
     20 runs of each at the frontend's shape;
  3. kernel B2 (mutual_nearest) against its plain version on the card at
     every call the main path makes: (32, 2048, 128) with the stereo and
     the temporal window of SlamConfig().matching, and loop verification's
     (SPEC_Q * max_candidates = 60, 2048, 128) float16 batch without a
     window; also without a window at (32, 2048, 128) and a ragged
     (3, 1500, 128) x (3, 1777, 128); then median times;
  4. main path: run_pipeline + evaluate on an 80-frame 376x1241 loop
     scene (157 m, 8000 landmarks) on the card, with both kernels'
     launch counters checked and every stage's ATE under 1 m;
  5. with --profile DIR: one more warm main-path run under
     torch.profiler; wall time, device busy time (union of the device
     events' intervals) and idle share of that one run, per stage and in
     all, and device time by kernel, into DIR/profile.json.
The second line from the end is the kernels' JSON record (after a full
run only), the last line the device record. Nothing here imports JAX.
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

SEED = 0
HW = (376, 1241)
TIMING_RUNS = 20


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
    keep_k, keep_p = torch.isfinite(n_k), torch.isfinite(n_p)
    mism = keep_k != keep_p
    if mism.any():
        # runner-up of each 5x5 window (the center itself excluded)
        pad = torch.nn.functional.pad(r_p[:, None], (2, 2, 2, 2),
                                      value=-float("inf"))
        win = pad.unfold(2, 5, 1).unfold(3, 5, 1).reshape(*r_p.shape, 25)
        win = win.clone()
        win[..., 12] = -float("inf")
        runner = win.max(dim=-1).values
        tie = (r_p - runner).abs() <= 1e-6 * r_scale
        if (mism & ~tie).any():
            fail(f"B1 {label}: {int((mism & ~tie).sum())} NMS decisions "
                 f"differ away from ties")
    both = keep_k & keep_p
    if float((n_k[both] - n_p[both]).abs().max()) > 1e-5 * r_scale:
        fail(f"B1 {label}: nms values differ")
    log(f"[B1] {label} {tuple(frames.shape)}: resp err {r_err:.3e} "
        f"(scale {r_scale:.3e}), maps max err {float(m_diff.max()):.3e} "
        f"(scale {m_scale:.3e}, share beyond tol {m_bad:.2e}), "
        f"nms mismatches {int(mism.sum())}")
    return max(r_err, float(m_diff.max()))


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


def profile_path(pipeline, L, R, calib, cfg, out_dir, card) -> None:
    """One more warm run of the main path under torch.profiler. From that
    run alone: its wall time, the device's busy time (the union of the
    device events' intervals, so overlapping kernels count once), the
    idle share, the same per pipeline stage (device busy inside the
    stage's host span), and device time by kernel name. Host overhead of
    the profiler lengthens this run, so its idle share is an upper bound
    for an unprofiled run. Written to out_dir/profile.json."""
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
    (out / "profile.json").write_text(json.dumps(report, indent=1))
    log(f"[profile] one profiled run: wall {wall_s:.3f} s, device busy "
        f"{busy_us * 1e-6:.4f} s over {len(dev)} device events, idle share "
        f"{report['idle_share']:.3f} ({card})")
    for name, st in stages.items():
        log(f"[profile] stage {name}: host {st['host_s']:.3f} s, device busy "
            f"{st['device_busy_s']:.4f} s, idle share {st['idle_share']:.3f}")
    for n, (c, us) in top[:12]:
        log(f"[profile] {us * 1e-3:9.3f} ms  x{c:<6d} {n[:90]}")
    log(f"[profile] written to {out / 'profile.json'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after the main path, profile one more run of it "
                         "and write DIR/profile.json (phase 5)")
    args = ap.parse_args(argv)

    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from slam_tpu.config import SlamConfig
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.models import frontend, loop_closure
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.utils import synthetic

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
    build_s = time.perf_counter() - t0
    log(f"[build] kernels built in {build_s:.2f} s")
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
    b1_ms = median_ms(lambda: ck.detect_maps(path))
    b1_plain_ms = median_ms(lambda: ck.detect_maps_plain(path))
    log(f"[B1] {tuple(path.shape)} median of {TIMING_RUNS}: kernel "
        f"{b1_ms:.3f} ms, plain {b1_plain_ms:.3f} ms ({card})")
    del path

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
    del stereo, temporal, verify
    b2_ms, b2_plain_ms = b2_times["stereo"]

    kernels = [
        {"name": "detect_maps", "route": "cuda",
         "source": "slam_tpu_torch/csrc/detect_maps.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:621",
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "mutual_nearest", "route": "cuda",
         "source": "slam_tpu_torch/csrc/mutual_nearest.cu",
         "replaces": "slam_tpu/ops/pallas_kernels.py:105",
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms},
    ]
    if args.kernels_only:
        # no main-path run, so no launch counts to report
        log(json.dumps({"ok": True, "kernels_only": True}))
        return 0

    # ---- 4. main path -------------------------------------------------------
    T_gt = scene.T_w2c
    # the default SlamConfig(); a warm-up pass (cuDNN / cuBLAS / cuSOLVER
    # handles, allocator), then the measured pass with the counters
    # zeroed just before it
    pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                          device="cuda")
    torch.cuda.synchronize()
    ck.reset_counters()
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    plain = dict(ck.PLAIN_CALLS)
    report = pipeline.evaluate(res, T_gt)
    if launches["detect_maps"] == 0 or launches["mutual_nearest"] == 0:
        fail(f"a kernel of the path was not launched: {launches}")
    if any(plain.values()):
        fail(f"a plain version ran during the CUDA main path: {plain}")
    n_frames = L.shape[0]
    if res.T_frontend.shape != (n_frames, 4, 4) or not np.isfinite(
            res.T_frontend).all():
        fail("frontend trajectory malformed")
    ates = {k: report[k]["ate_rmse_m"]
            for k in ("frontend", "bundles_kf", "pose_graph_kf",
                      "pose_graph_lc_kf") if k in report}
    for k, v in ates.items():
        if not (np.isfinite(v) and v < 1.0):
            fail(f"ATE {k} = {v} m (limit 1.0 m)")
    if report["num_closures"] < 1:
        fail("no loop closure found on the loop scene")
    t = res.timings
    log(f"[path] {n_frames} frames {HW}: wall {wall:.2f} s, stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
        + f"; frontend {n_frames / t['frontend']:.1f} frames/s ({card})")
    log(f"[path] closures {[(c.frame_i, c.frame_j, c.num_inliers) for c in res.closures]}"
        f"; ATE m {json.dumps(ates)}; pose failures "
        f"{report['num_pose_failures']}; launches {launches} ({card})")

    # ---- 5. profile (optional) ---------------------------------------------
    if args.profile:
        profile_path(pipeline, L, R, scene.calib, cfg, args.profile, card)

    if "jax" in sys.modules:
        fail("JAX was imported")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
