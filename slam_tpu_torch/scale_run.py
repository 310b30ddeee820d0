"""Reference-scale end-to-end run on the card.

Counterpart of ``scripts/scale_run.py``. KITTI seq 00 is ~3360 stereo
frames at 376x1241 with loop closures at widely separated revisits; the
dataset is not needed here: the run renders a 3360-frame full-resolution
synthetic sequence with seq 00's multi-revisit topology (the clover of
``utils.synthetic.clover_trajectory``) and runs every stage on the card
(``--cpu``: on the CPU, for small shakedown runs), recording per-stage
wall-clock and accuracy.

Every stage keeps its artifact under ``--out``, so the run resumes:

    python -m slam_tpu_torch.scale_run --out runs/scale

Running it again loads every finished stage; ``--force <stage>``
recomputes from that stage on. The render runs on a pool of worker
processes for long sequences (the frames are independent).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np

STAGES = ["render", "frontend", "trackstore", "bundles", "posegraph",
          "loop", "analysis"]


def render_processes(num_frames: int) -> int:
    """Worker processes for the render: one per core (at most 8) for a
    long sequence, none below 200 frames, where spawning costs more than
    it saves."""
    return min(os.cpu_count() or 1, 8) if num_frames >= 200 else 1


def closures_by_revisit(closures, num_frames: int, radii) -> dict:
    """Each closure assigned to the clover's revisit event (a lap's return
    to the origin) nearest its later frame: the event frames and the
    closures per event."""
    from .utils import synthetic

    ends = synthetic.lap_end_frames(num_frames, radii)
    counts = np.zeros(len(ends), np.int64)
    for c in closures:
        counts[int(np.argmin(np.abs(ends - int(c["frame_j"]))))] += 1
    return {"event_frames": ends.tolist(), "closures_per_event":
            counts.tolist()}


def ransac_budget(cfg, fe, T_gt) -> dict:
    """What the reference's adaptive RANSAC would have drawn at each
    frame's measured inlier rate, n(w) = log(1 - p) / log(1 - w^4) with
    p = 1 - 1e-10 and w floored at 0.05, against the fixed hypothesis
    budget, and whether the frames over budget show more pose error."""
    budget = int(cfg.ransac.num_hypotheses)
    wobs = np.asarray(fe.inlier_frac[1:], np.float64)
    wfl = np.clip(wobs, 0.05, 0.999999)
    p4 = np.clip(wfl ** 4, 1e-300, 1.0 - 1e-12)
    demand = np.ceil(np.log(1e-10) / np.log1p(-p4))
    rel_est = np.einsum("fij,fjk->fik", fe.T_w2c[1:],
                        np.linalg.inv(fe.T_w2c[:-1]))
    rel_gt = np.einsum("fij,fjk->fik", T_gt[1:], np.linalg.inv(T_gt[:-1]))
    rel_err = np.linalg.norm(rel_est[:, :3, 3] - rel_gt[:, :3, 3], axis=-1)
    tail = demand > budget
    return {
        "fixed_hypotheses": budget,
        "adaptive_demand_p50": float(np.percentile(demand, 50)),
        "adaptive_demand_p99": float(np.percentile(demand, 99)),
        "adaptive_demand_max": float(demand.max()),
        "frac_frames_covered_by_budget": float((demand <= budget).mean()),
        "tail_frames_over_budget": int(tail.sum()),
        "rel_trans_err_m_median_all": float(np.median(rel_err)),
        "rel_trans_err_m_median_tail": (
            float(np.median(rel_err[tail])) if tail.any() else None),
        "inlier_frac_p01": float(np.percentile(wobs, 1)),
        "inlier_frac_median": float(np.median(wobs)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("slam_tpu_torch.scale_run")
    ap.add_argument("--frames", type=int, default=3360)
    ap.add_argument("--out", type=Path, default=Path("runs/scale"))
    ap.add_argument("--force", choices=STAGES, default=None,
                    help="recompute from this stage onward")
    ap.add_argument("--radii", type=float, nargs="+",
                    default=[100.0, 130.0, 160.0, 145.0])
    ap.add_argument("--landmarks", type=int, default=100_000)
    ap.add_argument("--corridor", type=float, default=30.0,
                    help="landmark corridor half-width [m]")
    ap.add_argument("--hw", type=int, nargs=2, default=[376, 1241])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (small shakedown runs)")
    ap.add_argument("--detector", choices=["harris", "akaze", "orb", "sift"],
                    default="harris")
    ap.add_argument("--texture", choices=["blobs", "fractal"],
                    default="blobs",
                    help="scene texture: 'fractal' = natural-image-"
                         "statistics albedo + exposure drift + sensor "
                         "noise (utils/synthetic.py)")
    ap.add_argument("--octaves", type=int, default=None,
                    help="pyramid/scale-space octaves (FeatureConfig."
                         "num_levels; reference AKAZE uses 4)")
    ap.add_argument("--render-from", type=Path, default=None,
                    help="reuse another run's rendered images/gt/calib "
                         "(hardlinked into --out) instead of re-rendering")
    ap.add_argument("--trace", type=Path, default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the stages "
                         "into DIR")
    args = ap.parse_args(argv)

    from . import pipeline as pipeline_mod
    from .config import SlamConfig
    from .models import bundle as bundle_mod
    from .models import frontend as frontend_mod
    from .models import loop_closure as lc_mod
    from .models.pose_graph import PoseGraph
    from .models.trackstore import TrackStore
    from .ops.cuda_kernels import resolve_device
    from .utils import analysis, synthetic
    from .utils.profiling import StageTimer, device_trace, log

    # no card and no --cpu: raise here, before any work
    device = str(resolve_device("cpu" if args.cpu else "cuda"))
    out: Path = args.out
    out.mkdir(parents=True, exist_ok=True)
    timings_path = out / "timings.json"
    timings: dict = (json.loads(timings_path.read_text())
                     if timings_path.exists() else {})
    force_from = STAGES.index(args.force) if args.force else len(STAGES)
    timer = StageTimer()
    ran: list[str] = []

    def fresh(stage: str, *artifacts: Path) -> bool:
        """True if the stage must run (an artifact missing or forced)."""
        if STAGES.index(stage) >= force_from:
            return True
        return not all(a.exists() for a in artifacts)

    @contextlib.contextmanager
    def running(stage: str):
        with timer.active(), timer.span(stage):
            yield
        timings[stage] = timer.seconds(stage)
        timings_path.write_text(json.dumps(timings, indent=2))
        ran.append(stage)
        log(f"scale: {stage}", seconds=f"{timings[stage]:.1f}")

    cfg = SlamConfig()
    if args.detector != "harris" or args.octaves is not None:
        fc = replace(cfg.features, detector=args.detector,
                     num_levels=args.octaves if args.octaves is not None
                     else cfg.features.num_levels)
        cfg = replace(cfg, features=fc)
        log("scale: feature config", detector=fc.detector,
            num_levels=fc.num_levels)
    cfg.save(out / "config.json")

    trace = (device_trace(args.trace, device=device) if args.trace
             else contextlib.nullcontext())
    with trace:
        # ---- render ------------------------------------------------------
        fL, fR = out / "images_L.npy", out / "images_R.npy"
        f_gt, f_calib = out / "gt_T_w2c.npy", out / "calib.npy"
        if args.render_from is not None and not fL.exists():
            for name in ("images_L.npy", "images_R.npy", "gt_T_w2c.npy",
                         "calib.npy"):
                src = args.render_from / name
                if not src.exists():
                    raise SystemExit(f"--render-from: missing {src}")
                os.link(src, out / name)
            log("scale: render reused", source=args.render_from)
        if fresh("render", fL, fR, f_gt, f_calib):
            with running("render"):
                procs = render_processes(args.frames)
                log("scale: building clover scene", frames=args.frames,
                    landmarks=args.landmarks, radii=args.radii,
                    processes=procs)
                scene = synthetic.make_scene(
                    seed=0, num_frames=args.frames,
                    num_landmarks=args.landmarks, trajectory="clover",
                    hw=tuple(args.hw), clover_radii=tuple(args.radii),
                    corridor_halfwidth=args.corridor, texture=args.texture)
                np.save(f_gt, scene.T_w2c)
                np.save(f_calib, scene.calib)
                step = max(200, args.frames // 8)
                synthetic.render_to_npy(
                    scene, fL, fR, processes=procs,
                    progress=lambda done, total: (
                        log(f"scale: render {done}/{total}")
                        if done % step < 16 or done == total else None))
        images_L = np.load(fL, mmap_mode="c")
        images_R = np.load(fR, mmap_mode="c")
        T_gt = np.load(f_gt)
        calib = np.load(f_calib)
        log("scale: images ready", shape=images_L.shape, dtype="uint8 x2")

        # ---- frontend (checkpointed, resumable) --------------------------
        ckpt = out / "frontend_ckpt.npz"
        if STAGES.index("frontend") >= force_from:
            # --force recomputes: resume=True would reload the checkpoint
            for p in out.glob("frontend_ckpt*"):
                p.unlink()
        if fresh("frontend", ckpt):
            with running("frontend"):
                fe = frontend_mod.run_frontend(
                    images_L, images_R, calib, cfg, device=device,
                    checkpoint_path=str(ckpt), checkpoint_every=1120,
                    resume=True)
        else:
            fe = frontend_mod.run_frontend(
                images_L, images_R, calib, cfg, device=device,
                checkpoint_path=str(ckpt), resume=True)
        log("scale: frontend", frames=fe.T_w2c.shape[0],
            pose_failures=fe.num_pose_failures,
            median_inliers=float(np.median(fe.num_inliers[1:])))

        # ---- track store -------------------------------------------------
        f_db = out / "trackstore.npz"
        if fresh("trackstore", f_db):
            with running("trackstore"):
                db = TrackStore.from_frontend(fe)
                db.save(f_db)
        else:
            db = TrackStore.load(f_db)
        log("scale: trackstore", tracks=db.num_tracks,
            stats=json.dumps(db.stats()))

        # ---- bundles -----------------------------------------------------
        f_bundles = out / "bundles.npz"
        if fresh("bundles", f_bundles):
            with running("bundles"):
                bundles = bundle_mod.run_bundles(db, fe.T_w2c, calib, cfg,
                                                 device=device)
                bundle_mod.save_bundles(bundles, f_bundles)
        else:
            bundles = bundle_mod.load_bundles(f_bundles)
        log("scale: bundles", windows=bundles.poses.shape[0],
            keyframes=len(bundles.keyframes),
            median_final_cost=float(np.median(bundles.cost)))

        # ---- pose graph --------------------------------------------------
        f_pg = out / "pose_graph.npz"
        if fresh("posegraph", f_pg):
            with running("posegraph"):
                pg = PoseGraph.from_bundles(bundles, device=device)
                pg.optimize()
                pg.save(f_pg)
        pg_pre = PoseGraph.load(f_pg, device=device)

        # ---- loop closure ------------------------------------------------
        f_pg_lc, f_closures = out / "pose_graph_lc.npz", out / "closures.json"
        if fresh("loop", f_pg_lc, f_closures):
            with running("loop"):
                pg = PoseGraph.load(f_pg, device=device)
                closures = lc_mod.find_loops(pg, db, fe.desc, fe.valid, calib,
                                             cfg)
                pg.save(f_pg_lc)
                f_closures.write_text(json.dumps([
                    {"kf_i": c.kf_i, "kf_j": c.kf_j, "frame_i": c.frame_i,
                     "frame_j": c.frame_j, "num_inliers": c.num_inliers,
                     "inlier_frac": c.inlier_frac,
                     "mahalanobis": c.mahalanobis} for c in closures],
                    indent=2, default=float))
        if "loop" in ran:
            log("scale: loop stage breakdown", **{
                k[len("loop."):]: f"{v:.3f}s x{timer.counts[k]}"
                for k, v in timer.report().items()
                if k.startswith("loop.")})
        pg_lc = PoseGraph.load(f_pg_lc, device=device)
        closures_meta = json.loads(f_closures.read_text())
        log("scale: loop closure", closures=len(closures_meta),
            pairs=[(c["frame_i"], c["frame_j"], c["num_inliers"])
                   for c in closures_meta])

        # ---- evaluation + analysis ---------------------------------------
        result = pipeline_mod.PipelineResult(
            frontend=fe, db=db, bundles=bundles, pose_graph=pg_lc,
            pose_graph_pre_lc=pg_pre,
            closures=[SimpleNamespace(**c) for c in closures_meta],
            timings={k: v for k, v in timings.items() if k != "render"},
            calib=np.asarray(calib, np.float32))
        report = pipeline_mod.evaluate(result, T_gt)
        f_analysis = out / "graphs" / "analysis.json"
        if fresh("analysis", f_analysis):
            with running("analysis"):
                report["analysis"] = analysis.run_analysis(
                    result, T_gt, out / "graphs", images_left=images_L)
        else:
            report["analysis"] = json.loads(f_analysis.read_text())
    report["timings_s"] = timings
    report["stages_run"] = ran
    report["num_keyframes"] = len(bundles.keyframes)
    report["num_windows"] = int(bundles.poses.shape[0])
    report["frames"] = int(args.frames)
    report["device"] = device
    report["revisits"] = closures_by_revisit(closures_meta, args.frames,
                                             args.radii)
    report["ransac_budget"] = ransac_budget(cfg, fe, T_gt)
    log("scale: ransac budget accounting",
        budget=json.dumps(report["ransac_budget"]))
    # every pass is kept in report_history.jsonl, so a later pass never
    # silently replaces a recorded one
    report["timestamp_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())
    with (out / "report_history.jsonl").open("a") as fh:
        fh.write(json.dumps({
            "ts": report["timestamp_utc"], "timings_s": timings,
            "forced_from": args.force, "stages_run": ran,
            "ate": {k: report[k]["ate_rmse_m"] for k in
                    ("frontend", "bundles_kf", "pose_graph_kf",
                     "pose_graph_lc_kf") if k in report},
            "num_closures": report.get("num_closures"),
        }, default=float) + "\n")
    pipeline_mod.save_report(out / "report.json", report)
    log("scale: report written", **{k: report[k] for k in (
        "num_closures", "num_keyframes", "num_pose_failures")},
        revisits=json.dumps(report["revisits"]), stages_run=ran)
    for stage in ("frontend", "bundles_kf", "pose_graph_kf",
                  "pose_graph_lc_kf"):
        if stage in report:
            log(f"scale:   {stage}",
                ate_rmse_m=f"{report[stage]['ate_rmse_m']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
