"""Where the window BA's rel_T of the stage overlap over gloo ranks
departs from the one-process overlap's (chip_smoke.py phase 4m (e)).

Runs the 80-frame smoke scene (phase 4's, ``SlamConfig()``) through
``run_pipeline(mesh=..., overlap=True)``: in one process on a 2-shard
mesh, op by op (``graphs.eager()``) and graphed, and over 2 gloo ranks
sharing the card (each rank's cold and warm run). Every run records the
frontend's poses, each window batch's host inputs to the BA step (as
``models.bundle.window_inputs`` gives them) and the step's results. It
prints, against the first one-process run: the frontend's T_w2c, each
BA input and rel_T, as the largest entry difference. Then it solves
every run's recorded inputs again in this process, op by op and
graphed, twice each, and prints how far each re-solve lies from the
run's own rel_T: zero where the window BA gives the same answer to the
same inputs, so that a gap between runs comes from their inputs.

    python3 scripts/probe_rank_overlap_spread.py [--rank-spawns 3]

One card, ~3 min. ``--device cpu --frames 24 --hw 128 256`` runs it on
the CPU at a small size, to check the script.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from slam_tpu_torch import pipeline  # noqa: E402
from slam_tpu_torch.config import SlamConfig  # noqa: E402
from slam_tpu_torch.models import bundle as bundle_mod  # noqa: E402
from slam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_tpu_torch.parallel import ranks, stage_overlap  # noqa: E402
from slam_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from slam_tpu_torch.runtime import graphs  # noqa: E402
from slam_tpu_torch.utils import synthetic  # noqa: E402

INPUTS = bundle_mod.WINDOW_INPUTS + ("n_poses",)


def _recorder() -> dict:
    """Record every BA dispatch's host inputs and the solver's results
    into the returned dict (``inputs``, ``outputs``) from now on."""
    rec = {"inputs": [], "outputs": []}
    window_inputs = bundle_mod.window_inputs
    results = stage_overlap._BatchSolver.results

    def recorded_inputs(*a, **k):
        out = window_inputs(*a, **k)
        rec["inputs"].append(tuple(np.array(x, copy=True) for x in out))
        return out

    def recorded_results(self):
        out = results(self)
        rec["outputs"] = [tuple(np.array(x, copy=True) for x in o)
                          for o in out]
        return out

    bundle_mod.window_inputs = recorded_inputs
    stage_overlap._BatchSolver.results = recorded_results
    return rec


def _run(L, R, calib, cfg, mesh, rec) -> dict:
    rec["inputs"], rec["outputs"] = [], []
    res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, mesh=mesh,
                                overlap=True)
    return {"T_w2c": res.frontend.T_w2c.copy(),
            "rel_T": res.bundles.rel_T.copy(),
            "inputs": list(rec["inputs"]), "outputs": list(rec["outputs"])}


def rank_runs(paths, calib, cfg, device) -> list:
    """One gloo rank: the overlap's cold and warm runs, recorded."""
    rec = _recorder()
    L, R = (np.load(p) for p in paths)
    mesh = make_mesh(device=device)
    return [_run(L, R, calib, cfg, mesh, rec) for _ in range(2)]


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-spawns", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--hw", type=int, nargs=2, default=cs.HW)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 1
        ck.build()
    cfg = SlamConfig()
    scene = synthetic.make_scene(seed=cs.SEED, num_frames=args.frames,
                                 num_landmarks=8000, trajectory="loop",
                                 hw=tuple(args.hw))
    L, R = synthetic.render_sequence(scene)
    rec = _recorder()
    runs = {}
    mesh = make_mesh(2, device=device)
    with graphs.eager():
        for i in range(3):
            runs[f"one process eager {i}"] = _run(L, R, scene.calib, cfg,
                                                  mesh, rec)
    for i in range(3):
        runs[f"one process graphed {i}"] = _run(L, R, scene.calib, cfg,
                                                mesh, rec)
    with tempfile.TemporaryDirectory() as tmp:
        paths = (str(Path(tmp) / "left.npy"), str(Path(tmp) / "right.npy"))
        np.save(paths[0], L)
        np.save(paths[1], R)
        for k in range(args.rank_spawns):
            out = ranks.spawn(rank_runs, 2, "gloo", args.device,
                              args=(paths, scene.calib, cfg, args.device),
                              timeout=cs.RANKS_JOIN_S)
            for j, tag in enumerate(("cold", "warm")):
                # the BA rank (1) records the BA's inputs and results
                runs[f"ranks {k} {tag}"] = out[1][j]
    ref_tag = next(iter(runs))
    ref = runs[ref_tag]
    print(f"against {ref_tag}: largest entry difference")
    for tag, r in runs.items():
        n_b = len(r["inputs"])
        same_shapes = n_b == len(ref["inputs"]) and all(
            a.shape == b.shape for x, y in zip(r["inputs"], ref["inputs"])
            for a, b in zip(x, y))
        line = (f"  {tag:24s} batches {n_b}, frontend T_w2c "
                f"{_maxdiff(r['T_w2c'], ref['T_w2c']):.3e}")
        if same_shapes:
            for i, name in enumerate(INPUTS):
                d = max(_maxdiff(x[i], y[i])
                        for x, y in zip(r["inputs"], ref["inputs"]))
                line += f", {name} {d:.3e}"
        else:
            line += ", BA batches of other shapes"
        line += f"; rel_T {_maxdiff(r['rel_T'], ref['rel_T']):.3e}"
        print(line)
    bc = cfg.bundle
    step = bundle_mod.window_step(scene.calib, device, iters=bc.lm_iters,
                                  min_depth=bc.min_depth,
                                  max_depth=bc.max_depth,
                                  huber_delta=bc.huber_delta_px)
    print("each run's BA inputs solved again in this process: rel_T's "
          "largest entry difference from the run's own")
    for tag, r in runs.items():
        line = f"  {tag:24s}"
        for mode in ("eager", "graphed", "graphed"):
            ctx = graphs.eager() if mode == "eager" else \
                contextlib.nullcontext()
            d = 0.0
            with ctx:
                for x, y in zip(r["inputs"], r["outputs"]):
                    out = step(*x)
                    n = len(y[5])
                    d = max(d, _maxdiff(out[5][:n].cpu().numpy(), y[5]))
            line += f" {mode} {d:.3e}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
