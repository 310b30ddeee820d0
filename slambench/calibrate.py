"""The readings that a cell's limits are set from (not run by the
benchmark's runs).

    python3 slambench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--out chiprun_out/calibrate.json]

For each seed: the cell's sequences through the program as the window
runs them (warm, from CUDA graphs; from KITTI-layout PNGs where the cell
reads them), the plain reference on each, and for the seeds of
``--control-seeds`` the reference computed with TF32 matmuls and
convolutions (the precision below the configuration's float32 with TF32
off) put in the program's place. Prints the compared numbers of both
per seed, and their largest and smallest over the seeds, with each
sequence's count of BA windows that overflow the capacities. A cell of
several ranks runs the program over its ranks (``harness/ranked.py``),
the reference and the control on card 0 while the other ranks wait.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import check, pngs, runner, spec, traffic  # noqa: E402


def look(seed, index, prog, ref) -> None:
    """Where the frontend's trajectories part: the frame whose motion
    differs most, RANSAC's inliers there on both sides, and the frames
    whose keypoints differ (a slot's position or validity)."""
    import numpy as np

    dt, dr = check.step_gaps(prog, ref)
    f = int(np.argmax(dt))
    kp = (np.any(np.abs(prog["xy"] - ref["xy"]) > 1e-3, axis=-1)
          | (prog["valid"] != ref["valid"]))
    per = kp.sum(axis=1)
    frames = np.nonzero(per)[0]
    print(json.dumps({
        "look": [seed, index], "abs_gap_m": check._gap(prog["frontend"],
                                                       ref["frontend"]),
        "step_gap_m": float(dt[f]), "step_rot_deg": float(dr[f]),
        "frame": f, "inliers": [int(prog["inliers"][f]),
                                int(ref["inliers"][f])],
        "median_step_gap_m": float(np.median(dt[1:])),
        "frames_kp_differ": len(frames),
        "first_kp_differ": int(frames[0]) if len(frames) else None,
        "kp_differ_at_frame": int(per[f]),
        "top_step_gaps": sorted(((float(x), int(i)) for i, x in
                                 enumerate(dt)), reverse=True)[:4]}),
        flush=True)


POSES = ("frontend", "keyframes", "bundles", "pose_graph", "loop_closed")


def save(path, seed, index, side, dig) -> None:
    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path / f"{seed}_{index}_{side}.npz",
                        closures=np.asarray(dig["closures"]).reshape(-1, 2),
                        **{k: dig[k] for k in POSES})


def readings(cell, seeds, control_seeds, save_dir=None,
             device: str = "cuda") -> dict:
    import numpy as np

    runner.setup_env()
    geom = cell.config["geometry"]
    calib = np.asarray(geom["calib"], np.float32)
    cfg = runner.program_config(cell)
    out = {"program": {}, "control": {}, "ate_m": {}, "overflowed": {}}
    program = group = None
    disk = cell.traffic["input"] == "disk"
    tmp = Path(tempfile.gettempdir()) / "slambench" / "calibrate"
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            seqs = traffic.make_sequences(cell.traffic, seed, device,
                                          hw=tuple(geom["image_hw"]),
                                          calib=calib)
            if disk:
                shutil.rmtree(tmp, ignore_errors=True)
                for s in seqs:
                    s.paths = pngs.write_sequence(
                        tmp, f"{s.index:02d}", s.left, s.right, calib,
                        s.scene.T_w2c)
            if group is not None:
                seqs = group.share(seqs)
            if program is None:
                if cell.ranks > 1:
                    from harness import ranked

                    group = program = ranked.Group(cell, runner.Program,
                                                   calib, device)
                    seqs = group.start(seqs)
                else:
                    program = runner.Program(cfg, calib, device, disk)
                for _ in range(2):
                    program(seqs[0])
            prog, ctrl, ates, over = [], [], [], []
            for s in seqs:
                program(s)  # a key this sequence alone may need, captured
                res = program(s)
                ates.append(runner.ate(program, res, s))
                dig = check.digest(res)
                del res
                st = {}
                ref = runner.run_reference(cell, s, calib, device, stats=st)
                over.append(st["overflowed_windows"])
                prog.append(check.compare(dig, ref))
                look(seed, s.index, dig, ref)
                if save_dir is not None:
                    save(save_dir, seed, s.index, "program", dig)
                    save(save_dir, seed, s.index, "reference", ref)
                if seed in control_seeds:
                    ctl = runner.run_reference(cell, s, calib, device, True)
                    ctrl.append(check.compare(ctl, ref))
                    if save_dir is not None:
                        save(save_dir, seed, s.index, "control", ctl)
            out["program"][seed] = check.worst(prog)
            if ctrl:
                out["control"][seed] = check.worst(ctrl)
            out["ate_m"][seed] = {k: sum(a[k] for a in ates) / len(ates)
                                  for k in ates[0]}
            out["overflowed"][seed] = over
            print(json.dumps({"seed": seed, "program": out["program"][seed],
                              "control": out["control"].get(seed),
                              "ate_m": out["ate_m"][seed],
                              "overflowed_windows": over,
                              "s": time.perf_counter() - t0}), flush=True)
    finally:
        if group is not None:
            group.close()
    _summary(out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _summary(out) -> None:
    for side in ("program", "control"):
        if out[side]:
            print(side, "largest:", json.dumps(check.worst(
                list(out[side].values()))), flush=True)
            print(side, "smallest:", json.dumps(
                {k: min(d[k] for d in out[side].values())
                 for k in check.NUMBERS}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--save", type=Path, default=None,
                    help="write each sequence's poses of every side here "
                         "(npz), to compare them again off the card")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    out = readings(cell, args.seeds, set(args.control_seeds), args.save)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
