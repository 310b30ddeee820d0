"""What the card tests of whole paths share (``test_torch_card_paths.py``,
``test_torch_card_modes.py``): the 80-frame 376x1241 loop scene, a path
driven warm and held to its gates (``run_path``), the main path's run
(``main_path``), the kernels' device functions as a trace names them, and
the tolerances both files hold results to, and each detector's
configuration with the kernels its path must launch (``DETECTORS``,
which ``chip_smoke.py`` runs through ``run_path`` too).

The scene and the main path are computed once per process
(``functools.lru_cache``), so the two files share them in one card run.
The module imports no JAX: it runs on the card, where JAX is absent.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import numpy as np
import torch

from slam_tpu_torch.config import FeatureConfig, MatchConfig, SlamConfig

SEED = 0
HW = (376, 1241)
# the scene: 80 frames on a 25 m loop (157 m), 8000 landmarks, one revisit
SCENE = dict(seed=SEED, num_frames=80, num_landmarks=8000,
             trajectory="loop", hw=HW)
STAGE_ATES = ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")
FRONTEND_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev",
                   "match_dist", "inlier_prev", "T_rel", "T_w2c",
                   "num_inliers", "inlier_frac", "pose_ok")
# two runs of the window BA on the same windows differ by the order
# index_add_ sums in: up to ~2e-5 in a pose entry and in a relative cost
# on the scene's windows (NVIDIA H100 80GB HBM3, 700 W); the limits are
# ~10x that
SLICE_TOL = {"poses": 2e-4, "cost": 1e-4}
# every spawn of ranks (parallel.ranks.spawn) joined within this, s, or
# its ranks killed
RANKS_JOIN_S = 300.0
# solve_windows' rel_cov against a float64 inverse of the same S:
# relative Frobenius norm of each window's block, the largest
COV_TOL = 1e-3
# two results of one path on the same inputs (the library solve, the
# sparse pose graph, a mesh, the CLI): every stage's ATE this close, m
ATE_TOL = 0.01

# each kernel's device function as a trace names it: every wrapper
# launches one per call (B1, B3 and B4 are instances of one template)
TRACE_NAMES = {"detect_maps": "maps_kernel<true, true>",
               "harris_response": "maps_kernel<true, false>",
               "orientation_maps": "maps_kernel<false, true>",
               "akaze_octave": "akaze_octave_kernel<",
               "mutual_nearest": "mutual_kernel<",
               "cholesky_solve": "cholesky_solve_kernel<",
               "schur_reduce": "schur_poses_kernel",
               "sift_octave": "sift_octave_kernel<",
               "pg_system": "pg_rows_kernel",
               "pg_step": "pg_step_kernel",
               "stamp": "stamp_kernel"}
# host seconds of idle trace before the lead call and after the last
# marker, per attempt: a trace drops device events whose times, mapped to
# the host's clock, fall outside its window, and the mapping drifts
TRACE_PADS_S = (0.2, 0.5, 1.0)


@functools.lru_cache(maxsize=1)
def loop_scene():
    """(scene, left images, right images) of SCENE, rendered once."""
    from slam_tpu_torch.utils import synthetic

    scene = synthetic.make_scene(**SCENE)
    L, R = synthetic.render_sequence(scene)
    return scene, L, R


def traced_window(fn, lead, reset=None):
    """lead(), then fn() between two marker kernels, under one
    torch.profiler trace of the card: (fn()'s result, the trace's device
    events inside the markers). A trace can drop device events at its
    edges (its conversion of device times to host times drifts): the lead
    call and idle host time at both ends (TRACE_PADS_S) take that loss,
    and an attempt that lost a marker is repeated with longer pads.
    ``reset`` runs between the lead call and fn() (the launch
    counters)."""
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
        print(f"[trace] {len(marks)} of its 2 marker kernels among "
              f"{len(dev)} device events (pads {pad} s)")
    raise AssertionError(f"a marker kernel lost with every pad of "
                         f"{TRACE_PADS_S} s")


def traced_launches(fn, reset=None):
    """fn() traced after a lead call of fn() (``traced_window``): (its
    result, the launches of each kernel of TRACE_NAMES in the trace, and
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


def stage_ates(report: dict) -> dict:
    """Every stage's ATE of an evaluate() report, each finite and under
    1 m."""
    ates = {k: report[k]["ate_rmse_m"] for k in STAGE_ATES if k in report}
    assert ates and all(np.isfinite(v) and v < 1.0 for v in ates.values()), \
        ates
    return ates


def ates_close(got: dict, want: dict, tol: float = ATE_TOL) -> None:
    """The same stages, every ATE within ``tol`` m."""
    assert got.keys() == want.keys(), (got, want)
    assert max(abs(got[k] - v) for k, v in want.items()) <= tol, (got, want)


def closures_of(res) -> list:
    return [(c.frame_i, c.frame_j) for c in res.closures]


def run_path(cfg, required, *, trace=False, plain_ok=(), on_reset=None,
             **run_kw) -> dict:
    """run_pipeline + evaluate under ``cfg`` (and ``run_kw``: a mesh,
    overlap) on the loop scene on the card, every graph freed first:
    warm-up passes until one captures no new graph, then a pass with the
    counters zeroed just before it (``on_reset`` is called there too) and
    read just after. ops.ba._spd_solve and _covariance_system are wrapped
    to count LM iterations by shape and covariance systems, and
    ops.pose_graph.optimize and _covariance_full the pose graph's LM
    iterations and covariances, with their counters in graphs.COUNTERS
    while the graphs are captured, so that replays count too. With
    ``trace`` one more pass runs under torch.profiler after a lead pass
    (``traced_launches``): its launches must equal the untraced pass's
    and, kernel by kernel, the trace's.

    Holds: every kernel in ``required`` launched, no plain version run
    (but those of ``plain_ok``, put in on purpose), the frontend's
    trajectory finite, >= 1 loop closure and every stage's ATE under 1 m.
    Returns the launches, plain calls, ATEs, closure frame pairs, BA
    windows, the result, and the counted pass's LM iterations by shape
    (``solves``), covariance systems (``cov_systems``), the pose graph's
    LM iterations (``pg_iters``) and covariances (``pg_covs``) and
    replays of the frontend chunk's graph (``chunk_replays``)."""
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.models import frontend
    from slam_tpu_torch.ops import ba
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.ops import pose_graph as pg_ops
    from slam_tpu_torch.runtime import graphs

    scene, L, R = loop_scene()
    solves, covs = collections.Counter(), collections.Counter()
    spd_solve, cov_system = ba._spd_solve, ba._covariance_system
    pg_optimize, pg_cov = pg_ops.optimize, pg_ops._covariance_full
    chunk0 = [0]

    def counting(S, g):
        solves[tuple(S.shape)] += 1
        return spd_solve(S, g)

    def counting_covs(*a, **kw):
        covs["systems"] += 1
        return cov_system(*a, **kw)

    def counting_pg(*a, iters=15, **kw):  # called outside any graph
        covs["pg_iters"] += iters
        return pg_optimize(*a, iters=iters, **kw)

    def counting_pg_covs(*a, **kw):
        covs["pg_covs"] += 1
        return pg_cov(*a, **kw)

    def reset():
        ck.reset_counters()
        solves.clear()
        covs.clear()
        chunk0[0] = frontend._chunk.replays
        if on_reset is not None:
            on_reset()

    def run():
        return pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                     device="cuda", **run_kw)

    def settled():  # warm-ups and captures so far
        return sum(st["warmups"] + st["captures"]
                   for st in graphs.stats().values())

    graphs.clear()
    ba._spd_solve, ba._covariance_system = counting, counting_covs
    pg_ops.optimize, pg_ops._covariance_full = counting_pg, counting_pg_covs
    graphs.COUNTERS.extend((solves, covs))
    try:
        # the first call of a key runs eagerly, the second captures it
        for _ in range(3):
            before = settled()
            run()
            if settled() == before:
                break
        torch.cuda.synchronize()
        reset()
        res = run()
        torch.cuda.synchronize()
        launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if trace:
            _, traced, names = traced_launches(run, reset)
            assert dict(ck.LAUNCHES) == launches, (ck.LAUNCHES, launches)
            assert all(traced[k] == launches[k] for k in TRACE_NAMES), (
                launches, traced, names)
        counted = {"solves": dict(solves), "cov_systems": covs["systems"],
                   "pg_iters": covs["pg_iters"], "pg_covs": covs["pg_covs"],
                   "chunk_replays": frontend._chunk.replays - chunk0[0]}
    finally:
        ba._spd_solve, ba._covariance_system = spd_solve, cov_system
        pg_ops.optimize, pg_ops._covariance_full = pg_optimize, pg_cov
        graphs.COUNTERS.remove(solves)
        graphs.COUNTERS.remove(covs)
    report = pipeline.evaluate(res, scene.T_w2c)
    assert all(launches[k] > 0 for k in required), launches
    assert not any(n for k, n in plain.items() if k not in plain_ok), plain
    assert res.T_frontend.shape == (L.shape[0], 4, 4)
    assert np.isfinite(res.T_frontend).all()
    assert report["num_closures"] >= 1
    return {"launches": launches, "plain": plain,
            "ates": stage_ates(report), "closures": closures_of(res),
            "windows": res.bundles.poses.shape[0], "result": res, **counted}


MAIN_REQUIRED = ("detect_maps", "mutual_nearest", "cholesky_solve",
                 "schur_reduce")
CHUNK = SlamConfig().runtime.chunk_frames
# per detector: its configuration, the kernels its path must launch, and
# B1's image shapes in its frontend (a chunk's left and right images at
# each pyramid level), where B1 is its detector
DETECTORS = {
    "harris": (SlamConfig(), MAIN_REQUIRED, {(2 * CHUNK,) + HW}),
    "multiscale": (SlamConfig(features=FeatureConfig(num_levels=2)),
                   MAIN_REQUIRED,
                   {(2 * CHUNK,) + HW,
                    (2 * CHUNK, (HW[0] + 1) // 2, (HW[1] + 1) // 2)}),
    "akaze": (SlamConfig(features=FeatureConfig(detector="akaze"),
                         matching=MatchConfig(norm="hamming")),
              ("akaze_octave", "orientation_maps", "mutual_nearest",
               "cholesky_solve", "schur_reduce"), None),
    "sift": (SlamConfig(features=FeatureConfig(detector="sift")),
             ("sift_octave", "orientation_maps", "mutual_nearest",
              "cholesky_solve", "schur_reduce"), None),
    "orb": (SlamConfig(features=FeatureConfig(detector="orb"),
                       matching=MatchConfig(norm="hamming")),
            ("mutual_nearest", "cholesky_solve", "schur_reduce"), None),
}


@functools.lru_cache(maxsize=1)
def main_path() -> dict:
    """The main path (SlamConfig(), graphed, traced) through run_path,
    once per process: the result the other paths are held against."""
    return run_path(SlamConfig(), MAIN_REQUIRED, trace=True)


@functools.lru_cache(maxsize=1)
def main_windows():
    """The scene's BA windows, built on the host from the main path's
    frontend and keyframes as run_bundles builds them."""
    from slam_tpu_torch.models import bundle

    res = main_path()["result"]
    batch = bundle.build_windows(res.db, res.frontend.T_w2c,
                                 res.bundles.keyframes, SlamConfig().bundle)
    bundle.init_landmarks(batch, loop_scene()[0].calib)
    return batch


def verify_args(res, q_frames, c_frames):
    """_verify_candidates' arguments for the main path's keyframes: every
    query of ``q_frames`` against ``c_frames``, SPEC_Q x max_candidates
    pairs, seeded uniforms."""
    from slam_tpu_torch.models import loop_closure
    from slam_tpu_torch.ops import ransac as ransac_ops

    cfg = SlamConfig()
    C, Q = cfg.loop.max_candidates, loop_closure.SPEC_Q
    fe, db = res.frontend, res.db
    f_q = np.repeat(q_frames, C)
    f_c = np.resize(np.asarray(c_frames), Q * C)
    u = ransac_ops.hypothesis_uniforms(
        Q * C, cfg.features.max_kp, cfg.ransac.num_hypotheses,
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")

    def dev(x):
        return torch.as_tensor(x, device="cuda")

    return (fe.desc[f_q], dev(fe.valid[f_q]), dev(db.links[f_q]),
            dev(db.link_valid[f_q]), fe.desc[f_c], dev(fe.valid[f_c]),
            dev(db.links[f_c]), dev(db.link_valid[f_c]),
            torch.tensor(loop_scene()[0].calib, device="cuda"), u,
            cfg.ransac.threshold_px)


def recorded_solve(call):
    """The arguments of the one ba.solve_windows call in call()."""
    from slam_tpu_torch.ops import ba

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


def cov_against_float64(call) -> None:
    """solve_windows' rel_cov from its graph, and the eager _marginals of
    the same S (the graph's algorithm: an LU inverse per window), each
    finite and within COV_TOL of the float64 inverse of S
    (ba._covariance_system at the graph's result), relative Frobenius
    norm of each window's block."""
    from slam_tpu_torch.ops import ba

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

    assert torch.isfinite(out[6]).all()
    assert err(out[6]) <= COV_TOL
    assert err(ba._marginals(S)[b, last]) <= COV_TOL


@contextlib.contextmanager
def solving_with(solve):
    """ops.ba._spd_solve replaced by ``solve`` inside the block (the
    library solve, or a recorder). The block runs eagerly
    (runtime.graphs.eager()): a graph replays what its capture launched
    and calls no Python, so it would not take the replacement."""
    from slam_tpu_torch.ops import ba
    from slam_tpu_torch.runtime import graphs

    saved = ba._spd_solve
    ba._spd_solve = solve
    try:
        with graphs.eager():
            yield
    finally:
        ba._spd_solve = saved


def same_frontend(a, b, frames=None) -> None:
    """Every per-frame array of two frontend results equal bit for bit,
    and the descriptors of ``frames`` (all by default)."""
    for k in FRONTEND_ARRAYS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    idx = np.arange(len(a.xy)) if frames is None else frames
    assert torch.equal(a.desc.gather(idx), b.desc.gather(idx))


def b6_against_plain(S, g) -> None:
    """B6 against its plain version, both against the float64 solution
    of the same systems on the card: the kernel's error relative to max
    |x| (per system, the largest over the batch) at most 4x the plain
    version's + 1e-6; the systems the plain version fails to factor, and
    only they, all NaN in the kernel's result."""
    from slam_tpu_torch.ops import cuda_kernels as ck

    x_k = ck.cholesky_solve(S, g)
    x_p = ck.cholesky_solve_plain(S, g)
    x_64 = torch.linalg.solve(S.double(), g.double())
    torch.cuda.synchronize()
    failed = torch.isnan(x_p).all(-1)
    assert torch.equal(torch.isnan(x_k).all(-1), failed)
    ok = ~failed
    assert torch.isfinite(x_k[ok]).all()
    scale = x_64[ok].abs().amax(-1)
    e_k = float(((x_k[ok] - x_64[ok]).abs().amax(-1) / scale).max())
    e_p = float(((x_p[ok] - x_64[ok]).abs().amax(-1) / scale).max())
    assert e_k <= 4.0 * e_p + 1e-6, (e_k, e_p)

