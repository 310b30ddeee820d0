"""Command line of the port, on the card unless ``--cpu``.

Counterpart of ``python -m slam_tpu``, with the same flags and outputs:

  # a KITTI sequence from disk (PNGs streamed by the native prefetcher)
  python -m slam_tpu_torch --kitti-root /data/dataset --seq 00 --out runs/00

  # a synthetic run (no dataset needed)
  python -m slam_tpu_torch --synthetic loop --frames 100 --out runs/demo

  # several sequences, padded to one shared image bucket
  python -m slam_tpu_torch --kitti-root /data/dataset --seq 00 02 05 08 \\
      --out runs/all

Writes ``config.json`` and ``reports.json`` into ``--out`` and, per
sequence, ``cache/`` (the stage cache), ``report.json`` (with the stages'
and their spans' seconds, ``timings_s``, and ``counts``: the spans'
entries and the CUDA graphs' warm-ups, captures, replays and evictions)
and, with ground truth, ``graphs/`` (the analysis suite). Without a card
it raises unless ``--cpu`` is given; it never falls back to the CPU by
itself.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser("slam_tpu_torch")
    p.add_argument("--kitti-root", type=Path, default=None,
                   help="KITTI odometry dataset root (contains sequences/)")
    p.add_argument("--seq", nargs="+", default=["00"],
                   help="sequence id(s), e.g. 00 02 05 08")
    p.add_argument("--limit", type=int, default=None,
                   help="max frames per sequence")
    p.add_argument("--synthetic", choices=["straight", "loop"], default=None,
                   help="run on a synthetic scene instead of KITTI")
    p.add_argument("--frames", type=int, default=100,
                   help="synthetic sequence length")
    p.add_argument("--out", type=Path, required=True, help="output directory")
    p.add_argument("--config", type=Path, default=None,
                   help="SlamConfig JSON (see slam_tpu_torch/config.py)")
    p.add_argument("--no-loop-closure", action="store_true")
    p.add_argument("--no-analysis", action="store_true")
    p.add_argument("--no-prefetch", action="store_true",
                   help="load KITTI images eagerly into memory instead of "
                        "streaming them through the native prefetcher")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--trace", type=Path, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the runs "
                        "into DIR")
    args = p.parse_args(argv)

    from . import pipeline
    from .config import SlamConfig
    from .ops.cuda_kernels import resolve_device
    from .utils import analysis, kitti, synthetic
    from .utils.profiling import device_trace, log

    # no card and no --cpu: raise here, before any work
    device = str(resolve_device("cpu" if args.cpu else "cuda"))
    cfg = SlamConfig.load(args.config) if args.config else SlamConfig()
    args.out.mkdir(parents=True, exist_ok=True)
    cfg.save(args.out / "config.json")

    sequences = {}
    if args.synthetic:
        scene = synthetic.make_scene(seed=cfg.seed, num_frames=args.frames,
                                     num_landmarks=8000,
                                     trajectory=args.synthetic)
        L, R = synthetic.render_sequence(scene)
        sequences["synthetic"] = (synthetic.to_u8(L), synthetic.to_u8(R),
                                  scene.calib, scene.T_w2c)
    else:
        if args.kitti_root is None:
            p.error("--kitti-root or --synthetic is required")
        for s in args.seq:
            paths = kitti.KittiPaths(root=args.kitti_root, sequence=s)
            if not paths.exists():
                log("slam_tpu_torch: skipping", sequence=s,
                    reason=f"not found under {args.kitti_root}")
                continue
            calib = kitti.calib_vector(paths)
            gt = (kitti.read_ground_truth(paths)
                  if paths.poses_file.is_file() else None)
            if args.no_prefetch:
                L, R, _, gt = kitti.load_sequence(paths, limit=args.limit)
                sequences[s] = (L, R, calib, gt)
                continue
            # the frontend streams the PNGs through the native prefetcher
            lp = sorted(paths.left_dir.glob("*.png"))[: args.limit]
            rp = sorted(paths.right_dir.glob("*.png"))[: args.limit]
            if not lp or len(lp) != len(rp):
                log("slam_tpu_torch: skipping", sequence=s,
                    reason=f"{len(lp)} left / {len(rp)} right PNGs")
                continue
            sequences[s] = (lp, rp, calib,
                            None if gt is None else gt[: len(lp)])

    if not sequences:
        log("slam_tpu_torch: nothing to run")
        return 1

    # KITTI resolutions differ across sequences: one padded bucket for all
    image_hw = None
    if not args.synthetic:
        image_hw = kitti.bucket_for([
            kitti._imread_gray(v[0][0]).shape if isinstance(v[0], list)
            else v[0].shape[1:] for v in sequences.values()])
        log("slam_tpu_torch: image bucket", hw=image_hw,
            sequences=len(sequences))

    reports = {}
    trace = (device_trace(args.trace, device=device) if args.trace
             else contextlib.nullcontext())
    with trace:
        for name, (L, R, calib, gt) in sequences.items():
            out_dir = args.out / name
            out_dir.mkdir(parents=True, exist_ok=True)
            res = pipeline.run_pipeline(
                L, R, calib, cfg, cache_dir=out_dir / "cache",
                run_loop_closure=not args.no_loop_closure, verbose=True,
                image_hw=image_hw, device=device)
            if gt is not None:
                rep = pipeline.evaluate(res, np.asarray(gt))
                if not args.no_analysis:
                    # path mode: decode on demand, so the image probes
                    # (loop overlays, worst-factor insets) still render
                    images = (kitti.LazyImageSequence(L, image_hw)
                              if isinstance(L, list) else L)
                    rep["analysis"] = analysis.run_analysis(
                        res, np.asarray(gt), out_dir / "graphs",
                        images_left=images)
            else:
                rep = {"timings_s": res.timings, "db_stats": res.db.stats(),
                       "num_closures": len(res.closures)}
            rep["counts"] = res.counts
            reports[name] = rep
            pipeline.save_report(out_dir / "report.json", rep)
            log("slam_tpu_torch: sequence done", sequence=name,
                closures=json.dumps(rep["num_closures"]), device=device)
    pipeline.save_report(args.out / "reports.json", reports)
    log("slam_tpu_torch: done", reports=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
