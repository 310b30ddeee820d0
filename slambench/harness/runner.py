"""One run of a cell: inputs from the seed, set-up, the timed window, the
comparison with the reference, and the result line.

The window calls ``slam_tpu_torch.pipeline.run_pipeline`` on one whole
sequence after another (``run_loop_closure=True``, ``verbose=False``, no
stage cache) in a closed loop: each sequence is one operation, started
when the last one returned, until ``seconds`` have passed; the last one
started runs to its end. With ``trace`` the window is followed by one
more pass over the cell's sequences under torch.profiler, from which the
device metrics come; the stage metrics come from the window, which no
profiler slows. A cell whose configuration spans several ranks runs the
same set-up, window, traced pass and comparison over its ranks
(``ranked.Group``: the program and the cards in one).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import check, pngs, spec, stats, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")
MAX_WARM_PASSES = 4


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package that this process holds,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def program_config(cell: spec.Cell):
    from slam_tpu_torch.config import SlamConfig

    return SlamConfig.from_json(json.dumps(cell.config["settings"]))


def reference_config(cell: spec.Cell):
    from slamref.config import SlamConfig

    return SlamConfig.from_json(json.dumps(cell.config["settings"]))


def load_metric(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = spec.metric_file(name)
    mod_name = "slambench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def graph_totals() -> dict:
    """Warm-ups, captures, replays and evictions of the program's CUDA
    graphs so far, over all its graphed functions."""
    from slam_tpu_torch.runtime import graphs

    tot = {}
    for st in graphs.stats().values():
        for k in ("warmups", "captures", "replays", "evictions"):
            tot[k] = tot.get(k, 0) + st[k]
    return tot


def settled() -> int:
    """Warm-ups and captures so far: a pass that adds none is warm."""
    tot = graph_totals()
    return tot.get("warmups", 0) + tot.get("captures", 0)


class Program:
    """The system under test: ``run_pipeline`` on the run's sequences
    (with ``mesh``, one rank's share of the mesh's)."""

    def __init__(self, cfg, calib, device, from_disk: bool, mesh=None):
        from slam_tpu_torch import pipeline

        self.pipeline = pipeline
        self.cfg, self.calib, self.device = cfg, calib, device
        self.from_disk, self.mesh = from_disk, mesh

    def __call__(self, seq: traffic.Sequence):
        if self.from_disk:
            left, right = seq.paths
            return self.pipeline.run_pipeline(
                left, right, self.calib, self.cfg, run_loop_closure=True,
                verbose=False, image_hw=seq.left.shape[1:],
                device=self.device)
        return self.pipeline.run_pipeline(
            seq.left, seq.right, self.calib, self.cfg, run_loop_closure=True,
            verbose=False, mesh=self.mesh, device=self.device)


class OneCard:
    """The run's card, as ``_run`` asks of it besides the program's calls:
    graph warm-ups and captures so far, the profiled pass, the ``device``
    record, and the end of the program's use of the card (``ranked.Group``
    answers the same over several ranks)."""

    def __init__(self, device):
        self.device = device

    def settled(self) -> int:
        return settled()

    def traced_pass(self, program, seqs):
        return _traced_pass(program, seqs, self.device)

    def record(self, tr) -> dict:
        import torch

        cuda = str(self.device).startswith("cuda")
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        return device_record(self.device, peak, tr)

    def release(self) -> None:
        pass


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def _failed(res, frames: int) -> bool:
    T = np.asarray(res.frontend.T_w2c)
    return T.shape != (frames, 4, 4) or not np.isfinite(T).all()


def _record(res, seq, wall: float) -> dict:
    return {"index": seq.index, "frames": seq.frames, "wall_s": wall,
            "timings": dict(res.timings),
            "windows": int(np.asarray(res.bundles.rel_T).shape[0]),
            "from_disk": seq.paths is not None}


STAGES = ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")


def ate(program, res, seq) -> dict:
    """ATE RMSE per stage (``pipeline.evaluate``) against the scene's
    ground truth."""
    rep = program.pipeline.evaluate(res, seq.scene.T_w2c)
    return {k: rep[k]["ate_rmse_m"] for k in STAGES if k in rep}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float | None = None,
        program_factory=Program, tmp_root: Path | None = None) -> dict:
    """One run; returns the result line's object. A cell whose
    configuration spans several ranks runs as one rank per card, each
    with ``program_factory``'s program on its share of the mesh."""
    t_start = time.perf_counter() if t_start is None else t_start
    setup_env()
    # the imports, timed apart from the rendering
    import torch  # noqa: F401

    from slam_tpu_torch.ops import cuda_kernels  # noqa: F401

    geom = cell.config["geometry"]
    hw, calib = tuple(geom["image_hw"]), np.asarray(geom["calib"],
                                                    np.float32)
    cfg = program_config(cell)
    t_imports = time.perf_counter() - t_start
    seqs = traffic.make_sequences(cell.traffic, seed, device, hw=hw,
                                  calib=calib)
    log(f"[setup] {t_imports:.3f} s to import, {time.perf_counter() - t_start:.3f}"
        f" s with {len(seqs)} sequences rendered")
    from_disk = cell.traffic["input"] == "disk"
    if cell.ranks > 1:
        from . import ranked

        if from_disk:
            raise ValueError("a mesh takes its images in memory")
        with ranked.Group(cell, program_factory, calib, device) as group:
            seqs = group.start(seqs)
            log(f"[setup] {time.perf_counter() - t_start:.3f} s with "
                f"{group.world} ranks joined and the images shared")
            return _run(cell, seed, seconds, traced, device, t_start, group,
                        group, seqs, calib)
    tmp = None
    if from_disk:
        base = Path(tmp_root or tempfile.gettempdir())
        tmp = base / "slambench" / cell.name
        shutil.rmtree(tmp, ignore_errors=True)
        for s in seqs:
            s.paths = pngs.write_sequence(tmp, f"{s.index:02d}", s.left,
                                          s.right, calib, s.scene.T_w2c)
    program = program_factory(cfg, calib, device, from_disk)
    try:
        return _run(cell, seed, seconds, traced, device, t_start, program,
                    OneCard(device), seqs, calib)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, t_start, program, cards, seqs,
         calib):
    import torch

    cuda = str(device).startswith("cuda")
    # set-up: the first sequence twice (its graphs' eager runs, then
    # their captures), then passes over all of them until a pass warms up
    # and captures no graph
    program(seqs[0])
    program(seqs[0])
    log(f"[setup] {time.perf_counter() - t_start:.3f} s with the first "
        f"sequence warm")
    passes = 0
    for passes in range(1, MAX_WARM_PASSES + 1):
        before = cards.settled()
        for s in seqs:
            program(s)
        if cards.settled() == before:
            break
    _sync(device)
    graphs_setup = graph_totals()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s, {passes} warm passes over "
        f"{len(seqs)} sequences, graphs {graphs_setup}")

    # the window: a closed loop over the sequences
    rng = random.Random(seed)
    keep, seen = {}, {}
    records, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        seq = seqs[i % len(seqs)]
        i += 1
        attempted += 1
        ts = time.perf_counter()
        try:
            res = program(seq)
            _sync(device)
        except Exception as exc:  # a failed operation, counted
            failed += 1
            log(f"[window] sequence {seq.index} raised {exc!r}")
            continue
        wall = time.perf_counter() - ts
        if _failed(res, seq.frames):
            failed += 1
        records.append(_record(res, seq, wall))
        # one result per distinct sequence kept for the comparison, a
        # uniform draw from the seed over its completions
        seen[seq.index] = seen.get(seq.index, 0) + 1
        if rng.random() < 1.0 / seen[seq.index]:
            keep[seq.index] = res
        del res
    t_end = time.perf_counter()
    window_s = t_end - t0
    graphs_window = {k: graph_totals()[k] - graphs_setup.get(k, 0)
                     for k in graphs_setup}
    done_frames = sum(r["frames"] for r in records)
    for k in range(len(seqs)):
        walls = sorted(r["wall_s"] for r in records if r["index"] == k)
        if walls:
            log(f"[window] sequence {k}: {len(walls)} runs, median wall "
                f"{walls[len(walls) // 2]:.4f} s, max {walls[-1]:.4f} s")
    log(f"[window] {attempted} sequences ({failed} failed), {done_frames} "
        f"frames in {window_s:.3f} s; graphs in the window "
        f"{graphs_window}")

    tr = cards.traced_pass(program, seqs) if traced else None
    dev_record = cards.record(tr)
    cards.release()

    # outside the window: each kept result's ATE per stage against the
    # exact ground truth (earlier lines of the output), then the
    # comparison, once the program's state is freed
    for k, r in sorted(keep.items()):
        print(json.dumps({"ate_m": ate(program, r, seqs[k]),
                          "sequence": k}), flush=True)
    digests = {k: check.digest(r) for k, r in keep.items()}
    keep.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = compare_with_reference(cell, seqs, digests, calib, device)
    correct, compared = check.judge(values, cell.limits)
    for k, v in values.items():
        if k not in compared:
            log(f"[compare] {k} {v!r} (reported, no limit)")
    correct = correct and failed == 0 and len(digests) > 0

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        metrics = {}
        ctx = MetricContext(cell, records, tr)
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        metrics = {}
        e2e = {"seq_fps": lambda: stats.rate(done_frames, window_s),
               "seq_s_p90": lambda: stats.percentile(
                   [r["wall_s"] for r in records], 90),
               "setup_s": lambda: setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]()),
                                  "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = dev_record
    if tr is not None:
        result["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    for name, v in compared.items():
        log(f"[compare] {name} {v['value']!r} limit {v['limit']!r}")
    result["compared"] = {k: {"value": _finite(v["value"]),
                              "limit": v["limit"]}
                          for k, v in compared.items()}
    return result


def _traced_pass(program, seqs, device):
    """One pass over the sequences under torch.profiler, padded with idle
    host time at both ends (a trace can drop device events at its
    edges); the launches the program counted in it go to the log."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from slam_tpu_torch.ops import cuda_kernels

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    before = dict(cuda_kernels.LAUNCHES)
    infos = []
    with profile(activities=acts) as prof:
        time.sleep(0.3)
        for s in seqs:
            with record_function(trace.SEQ_SPAN):
                res = program(s)
                _sync(device)
            infos.append(_record(res, s, 0.0))
            del res
        time.sleep(0.3)
    tr = trace.from_profiler(prof)
    tr.sequences = infos
    launches = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    log(f"[trace] {len(tr.device)} device events over {tr.window_s:.3f} s, "
        f"busy {tr.busy_s():.4f} s; launches {launches}")
    del prof
    _sync(device)
    return tr


class MetricContext:
    """What a per-layer metric's reader gets: the cell, the window's
    sequences (``records``: frames, wall, the program's stage timings,
    windows solved) and the profiled pass (``trace``, or None; rank 0's in
    a cell of several ranks)."""

    def __init__(self, cell, records, tr):
        self.cell = cell
        self.records = records
        self.trace = tr

    @property
    def settings(self) -> dict:
        return self.cell.config["settings"]

    @property
    def image_hw(self) -> tuple:
        return tuple(self.cell.config["geometry"]["image_hw"])


def device_record(device, peak: int, tr) -> dict:
    import torch

    if str(device).startswith("cuda"):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if tr is not None:
        out["busy_s"] = tr.busy_s()
        out["window_s"] = tr.window_s
    return out


def compare_with_reference(cell, seqs, digests, calib, device) -> dict:
    """The reference on each sequence the window completed, against the
    program's kept result; the compared numbers (their worst over the
    sequences)."""
    per = []
    for s in seqs:
        if s.index not in digests:
            continue
        ref = run_reference(cell, s, calib, device)
        per.append(check.compare(digests[s.index], ref))
    if not per:
        return {k: float("inf") for k in check.NUMBERS}
    return check.worst(per)


def run_reference(cell, seq, calib, device, tf32: bool = False,
                  stats: dict | None = None) -> dict:
    """The plain reference on one sequence's images; with ``tf32`` its
    float32 matmuls and convolutions in TF32 (the control). ``stats``,
    when given, gets the reference's count of overflowed BA windows."""
    import torch

    import slamref

    cfg = reference_config(cell)
    # a mesh re-solves each capacity-overflowed window at full size
    full = {"resolve_overflow": True} if cell.ranks > 1 else {}
    if stats is not None:
        full["stats"] = stats
    if not tf32:
        return slamref.run(seq.left, seq.right, calib, cfg, device, **full)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return slamref.run(seq.left, seq.right, calib, cfg, device, **full)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    setup_env()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the card and has no "
            "other result")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 4
    for name, v in result["compared"].items():
        log(f"{name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def setup_env() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program builds its kernels into ``<checkout>/build/slam_tpu_torch``);
    the reference importable."""
    build = spec.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for p in (str(spec.ROOT), str(spec.BENCH_DIR / "reference")):
        if p not in sys.path:
            sys.path.insert(0, p)
