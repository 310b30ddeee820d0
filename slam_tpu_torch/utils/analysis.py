"""Analysis and evaluation suite: the reference's 25 plots, two extras,
the debug probes, and every number behind them.

Counterpart of ``slam_tpu/utils/analysis.py``, with the same artifact
file names (``ARTIFACTS``, plus ``loops.png``, ``disparity_hist.png``,
``worst_factor.png``, ``loop_match_<i>_<j>.png`` and
:func:`visualize_track`'s ``track_<id>.png``) and the same numbers in
``analysis.json``. Every number is computed first; the figures are drawn
afterwards from the computed arrays, so ``analysis.json`` does not
depend on the plotting library: without matplotlib no PNG is written,
the log says so and ``analysis.json`` carries the note under ``plots``.
``analysis.json`` also lists, per artifact, its file and a summary (count,
mean, min, max) of each curve it draws (``artifacts``).

Host numpy, but for two device calls on the result's own device: the
pose graphs' marginal log-determinants (``PoseGraph.marginal_logdets``)
and the loop-match probe's matching (``ops.matching.mutual_match``,
kernel B2 on the card: one launch per closure).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import metrics
from .profiling import log

# the reference's plot registry: every name below is emitted
# (abs_poseGraph_LC_* only when closures exist)
ARTIFACTS = [
    "num_matches", "inliers_percent", "connectivity", "histogram",
    "trajectory", "mean_factor_error", "median_projection_error",
    "median_projection_vs_distance_PnP",
    "median_projection_vs_distance_bundle",
    "abs_PnP_locations", "abs_PnP_angle",
    "abs_poseGraph_locations", "abs_poseGraph_angle",
    "abs_poseGraph_LC_locations", "abs_poseGraph_LC_angle",
    "rel_error_norm_PnP_bundle", "rel_error_angle_PnP_bundle",
    "rel_error_norm_bundle", "rel_error_angle_bundle",
    "rel_sub_section_error_norm_PnP", "rel_sub_section_error_angle_PnP",
    "rel_sub_section_error_norm_bundle", "rel_sub_section_error_angle_bundle",
    "uncertainty_location", "uncertainty_rotation",
]
NO_MATPLOTLIB = "not drawn: matplotlib is not installed"

# Agg rasterization costs ~0.5 ms per polyline point, so 3360-frame curves
# are drawn as their per-column min / max envelope (every spike survives);
# the numbers always come from the full arrays
_ENVELOPE_COLS = 700


def _summary(y) -> dict:
    y = np.asarray(y, np.float64).ravel()
    y = y[np.isfinite(y)]
    if y.size == 0:
        return {"n": 0}
    return {"n": int(y.size), "mean": float(y.mean()), "min": float(y.min()),
            "max": float(y.max())}


class Figures:
    """The figures of one analysis run: per file name, the curves it
    draws (summarized into ``analysis.json``) and a function that draws
    it with pyplot. Nothing is drawn until :meth:`draw`."""

    def __init__(self) -> None:
        self.items: dict[str, tuple[dict, object]] = {}

    def add(self, name: str, series: dict, draw) -> None:
        self.items[name] = (series, draw)

    def summaries(self, drawn: bool) -> dict:
        return {Path(name).stem: {
            "file": name if drawn else None,
            "series": {k: _summary(v) for k, v in series.items()}}
            for name, (series, _) in self.items.items()}

    def draw(self, out_dir: Path) -> str:
        """Draw every figure into ``out_dir``; returns the ``plots`` note."""
        try:
            import matplotlib
        except ImportError:
            log("analysis: figures", plots=NO_MATPLOTLIB)
            return NO_MATPLOTLIB
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name, (_, draw) in self.items.items():
            draw(plt)
            plt.gcf().tight_layout()
            plt.savefig(Path(out_dir) / name, dpi=110)
            plt.close("all")
        return f"drawn: {len(self.items)} files"


def _envelope(x, y, cols: int = _ENVELOPE_COLS):
    """Per-column min / max downsample of a curve, each extreme at its true
    x; returned unchanged when already small."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = y.shape[0]
    if n <= 2 * cols:
        return x, y
    edges = np.linspace(0, n, cols + 1).astype(int)
    col = np.repeat(np.arange(cols), np.diff(edges))
    order = np.lexsort((y, col))
    imin = order[edges[:-1]]
    imax = order[edges[1:] - 1]
    first = np.minimum(imin, imax)
    second = np.maximum(imin, imax)
    xs = np.empty(2 * cols, x.dtype)
    ys = np.empty(2 * cols, y.dtype)
    xs[0::2], xs[1::2] = x[first], x[second]
    ys[0::2], ys[1::2] = y[first], y[second]
    return xs, ys


def _plot_dec(plt, x, y, *args, **kwargs):
    """plt.plot of a per-frame curve, envelope-decimated for draw speed."""
    xd, yd = _envelope(x, y)
    plt.plot(xd, yd, *args, **kwargs)


def _stride(points: np.ndarray, max_pts: int = 1500) -> np.ndarray:
    """Uniform-stride subsample of a polyline (keeps both endpoints)."""
    n = points.shape[0]
    if n <= max_pts:
        return points
    step = int(np.ceil(n / max_pts))
    out = points[::step]
    if (n - 1) % step:
        out = np.concatenate([out, points[-1:]], axis=0)
    return out


def _curve(name, x, series: dict, xlabel, ylabel, title, size=(8, 3.2),
           styles=None, legend=False, grid=False, hline=None):
    """A figure of curves over a shared x axis: (series, draw)."""
    def draw(plt):
        plt.figure(figsize=size)
        for label, y in series.items():
            xs = x[label] if isinstance(x, dict) else x
            _plot_dec(plt, xs, y, label=label,
                      **(styles or {}).get(label, {}))
        if hline is not None:
            plt.axhline(hline[1], color="black", linestyle="-.",
                        label=hline[0])
        plt.xlabel(xlabel)
        plt.ylabel(ylabel)
        if legend or hline is not None:
            plt.legend()
        if grid:
            plt.grid(True, axis="y", linestyle="--", alpha=0.7)
        plt.title(title)
    return name, series, draw


# ---------------------------------------------------------------------------
# host-side stereo camera math
# ---------------------------------------------------------------------------

def _np_project(calib, pc):
    """(N, 3) camera-frame points -> (N, 3) stereo (uL, uR, v)."""
    fx, fy, cx, cy, b = [float(v) for v in np.asarray(calib)]
    z = np.where(np.abs(pc[..., 2]) > 1e-9, pc[..., 2], 1e-9)
    uL = fx * pc[..., 0] / z + cx
    uR = fx * (pc[..., 0] - b) / z + cx
    v = fy * pc[..., 1] / z + cy
    return np.stack([uL, uR, v], axis=-1)


def _np_backproject(calib, links):
    """(N, 3) stereo (uL, uR, v) -> (N, 3) camera-frame points."""
    fx, fy, cx, cy, b = [float(v) for v in np.asarray(calib)]
    disp = np.maximum(links[..., 0] - links[..., 1], 1e-6)
    z = fx * b / disp
    x = (links[..., 0] - cx) * z / fx
    y = (links[..., 2] - cy) * z / fy
    return np.stack([x, y, z], axis=-1)


def _transform(T, X):
    """Apply (4, 4) or (N, 4, 4) extrinsics to (N, 3) points."""
    return np.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]


def _rot_angle_deg(D):
    """Rotation angle of (N, 4, 4) or (4, 4) transform errors, degrees."""
    tr = np.trace(np.asarray(D)[..., :3, :3], axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# tracking statistics
# ---------------------------------------------------------------------------

def plot_track_stats(figs: Figures, db) -> None:
    lengths = db.track_lengths()

    def hist(plt):
        plt.figure(figsize=(6, 4))
        plt.hist(lengths, bins=np.arange(2, max(lengths.max(initial=0) + 2,
                                                3)),
                 log=True)
        plt.xlabel("track length [frames]")
        plt.ylabel("count (log)")
        plt.title("Track length histogram")

    figs.add("histogram.png", {"track length": lengths}, hist)
    for name, y, ylabel, title in (
            ("connectivity.png", db.connectivity(),
             "tracks shared with next frame", "Connectivity"),
            ("num_matches.png", db.link_valid.sum(axis=1), "stereo links",
             "Matches per frame"),
            ("inliers_percent.png", db.inliers_percent, "inliers [%]",
             "RANSAC inlier percentage")):
        figs.add(*_curve(name, np.arange(len(y)), {ylabel: y}, "frame",
                         ylabel, title))


# ---------------------------------------------------------------------------
# trajectories + absolute errors
# ---------------------------------------------------------------------------

def plot_trajectories(figs: Figures, T_gt, stages: dict) -> None:
    """x-z overlay of every stage against ground truth."""
    centers = {"ground truth": metrics.camera_centers(T_gt)}
    centers.update({k: metrics.camera_centers(T) for k, T in stages.items()})

    def draw(plt):
        plt.figure(figsize=(7, 6))
        for name, c in centers.items():
            c = _stride(c)
            if name == "ground truth":
                plt.plot(c[:, 0], c[:, 2], "k-", lw=2, label=name)
            else:
                plt.plot(c[:, 0], c[:, 2], lw=1, label=name)
        plt.xlabel("x [m]")
        plt.ylabel("z [m]")
        plt.axis("equal")
        plt.legend()
        plt.title("Trajectory overlay")

    figs.add("trajectory.png", {f"{k} x": c[:, 0] for k, c in centers.items()}
             | {f"{k} z": c[:, 2] for k, c in centers.items()}, draw)


def plot_abs_errors(figs: Figures, name, T_est, T_gt, x=None) -> dict:
    """Per-axis + L2 absolute location error and the rotation-angle error
    (abs_<stage>_locations / abs_<stage>_angle)."""
    err = metrics.abs_location_error(T_est, T_gt)
    deg = metrics.rotation_error_deg(T_est, T_gt)
    x = np.arange(err.shape[0]) if x is None else x
    figs.add(*_curve(f"abs_{name}_locations.png", x,
                     {lbl: err[:, i] for i, lbl in enumerate(
                         ["x", "y", "z", "L2"])}, "frame", "abs error [m]",
                     f"Absolute location error — {name}", size=(8, 4),
                     legend=True))
    figs.add(*_curve(f"abs_{name}_angle.png", x, {"rotation error": deg},
                     "frame", "rotation error [deg]",
                     f"Absolute rotation error — {name}", size=(8, 4)))
    return {"mean_l2": float(err[:, 3].mean()),
            "max_l2": float(err[:, 3].max()),
            "mean_deg": float(deg.mean())}


# ---------------------------------------------------------------------------
# relative consecutive-keyframe errors
# ---------------------------------------------------------------------------

def plot_rel_error_pairs(figs: Figures, bundles, T_frontend, T_gt) -> dict:
    """Relative-pose error between consecutive keyframes of the PnP
    (frontend) and the bundle estimates: rel_error_{norm,angle}_PnP_bundle
    (both curves) and rel_error_{norm,angle}_bundle (bundle only)."""
    kfs = np.asarray(bundles.keyframes)
    i0, i1 = kfs[:-1], kfs[1:]
    gt_rel = T_gt[i1] @ np.linalg.inv(T_gt[i0])
    pnp_rel = T_frontend[i1] @ np.linalg.inv(T_frontend[i0])
    D_pnp = pnp_rel @ np.linalg.inv(gt_rel)
    D_b = bundles.rel_T @ np.linalg.inv(gt_rel)
    pnp_norm = np.linalg.norm(D_pnp[:, :3, 3], axis=-1)
    b_norm = np.linalg.norm(D_b[:, :3, 3], axis=-1)
    pnp_deg = _rot_angle_deg(D_pnp)
    b_deg = _rot_angle_deg(D_b)
    common = dict(size=(8, 4), legend=True, grid=True)
    figs.add(*_curve(
        "rel_error_norm_PnP_bundle.png", i1,
        {"PnP norm error [m]": pnp_norm, "bundle norm error [m]": b_norm},
        "keyframe", "error [m]",
        "Relative location error of consecutive keyframes, PnP vs bundle",
        **common))
    figs.add(*_curve(
        "rel_error_angle_PnP_bundle.png", i1,
        {"PnP angle error [deg]": pnp_deg, "bundle angle error [deg]": b_deg},
        "keyframe", "error [deg]",
        "Relative angle error of consecutive keyframes, PnP vs bundle",
        **common))
    figs.add(*_curve(
        "rel_error_norm_bundle.png", i1, {"bundle norm error [m]": b_norm},
        "keyframe", "error [m]",
        "Relative location error of consecutive keyframes, bundle",
        styles={"bundle norm error [m]": {"color": "red"}}, **common))
    figs.add(*_curve(
        "rel_error_angle_bundle.png", i1, {"bundle angle error [deg]": b_deg},
        "keyframe", "error [deg]",
        "Relative angle error of consecutive keyframes, bundle",
        styles={"bundle angle error [deg]": {"color": "orange"}}, **common))
    return {"pnp": {"mean_trans_m": float(pnp_norm.mean()),
                    "mean_rot_deg": float(pnp_deg.mean())},
            "bundle": {"mean_trans_m": float(b_norm.mean()),
                       "mean_rot_deg": float(b_deg.mean())}}


# ---------------------------------------------------------------------------
# KITTI-style sub-section errors
# ---------------------------------------------------------------------------

def plot_rel_subsection(figs: Figures, name, T_est, T_gt,
                        lengths=(100, 400, 800)) -> dict:
    """Per-start-frame relative error over fixed sub-section lengths, one
    norm and one angle artifact per stage. The summary keeps the
    reference's lengths; the curves use the lengths that fit a shorter
    sequence (or half its length)."""
    summary = metrics.relative_subsequence_error(T_est, T_gt, lengths)
    F = T_est.shape[0]
    fit = tuple(L for L in lengths if L < F) or (max(2, F // 2),)
    curves = metrics.relative_subsequence_curves(T_est, T_gt, fit)
    if not curves:
        return summary
    Ls = sorted(curves)
    for kind, key, unit, what in (("norm", "trans_m_per_m", "m/m", "location"),
                                  ("angle", "rot_deg_per_m", "deg/m",
                                   "angle")):
        series = {f"{name} {kind} err, length {L}": curves[L][key]
                  for L in Ls}
        xs = {f"{name} {kind} err, length {L}": curves[L]["x"] for L in Ls}
        mean_all = float(np.mean([curves[L][key].mean() for L in Ls]))
        figs.add(*_curve(
            f"rel_sub_section_error_{kind}_{name}.png", xs, series,
            "start frame", f"{kind} error [{unit}]",
            f"Relative {what} error vs sub-section length — {name}",
            size=(8, 4), grid=True, hline=(f"mean {what} error", mean_all)))
    return summary


# ---------------------------------------------------------------------------
# uncertainty
# ---------------------------------------------------------------------------

def plot_uncertainty(figs: Figures, pg_pre, pg_post=None) -> dict:
    """log10 det of the location / rotation marginal covariance per
    keyframe, without and with loop closures (uncertainty_location /
    uncertainty_rotation). The determinants are reduced on the graph's
    device; only 2N numbers come back."""
    def logdets(pg):
        loc, rot = pg.marginal_logdets()
        return loc[1:] / np.log(10.0), rot[1:] / np.log(10.0)

    loc_pre, rot_pre = logdets(pg_pre)
    has_post = pg_post is not None and pg_post.num_edges > pg_pre.num_edges
    x = np.asarray(pg_pre.keyframes[1:])
    series = {"location": {"without loop closures": loc_pre},
              "rotation": {"without loop closures": rot_pre}}
    if has_post:
        loc_post, rot_post = logdets(pg_post)
        series["location"]["with loop closures"] = loc_post
        series["rotation"]["with loop closures"] = rot_post
    for kind in ("location", "rotation"):
        figs.add(*_curve(
            f"uncertainty_{kind}.png", x,
            {f"log {kind} uncertainty {k}": v
             for k, v in series[kind].items()},
            "frame", f"log10 det of {kind} covariance",
            f"{kind.capitalize()} uncertainty, pose graph with/without loop "
            f"closures", size=(8, 4), legend=True,
            styles={f"log {kind} uncertainty without loop closures":
                    {"color": "blue"},
                    f"log {kind} uncertainty with loop closures":
                    {"color": "red"}}))
    return {"final_loc_logdet": float(loc_pre[-1]) if len(loc_pre) else 0.0,
            "final_loc_logdet_lc": float(loc_post[-1]) if has_post else None}


# ---------------------------------------------------------------------------
# loop-closure overlay (extra)
# ---------------------------------------------------------------------------

def plot_loops(figs: Figures, pg, T_gt_kf) -> None:
    c = metrics.camera_centers(pg.nodes)
    g = metrics.camera_centers(T_gt_kf)
    loops = [(int(i), int(j)) for i, j, is_loop in
             zip(pg.e_i, pg.e_j, pg.is_loop) if is_loop]

    def draw(plt):
        plt.figure(figsize=(7, 6))
        plt.plot(g[:, 0], g[:, 2], "k-", lw=1, label="gt")
        plt.plot(c[:, 0], c[:, 2], "b-", lw=1, label="pose graph")
        for i, j in loops:
            plt.plot([c[i, 0], c[j, 0]], [c[i, 2], c[j, 2]], "r-", lw=2)
        plt.legend()
        plt.axis("equal")
        plt.title("Loop closures")

    figs.add("loops.png", {"pose graph x": c[:, 0], "pose graph z": c[:, 2],
                           "loop edge length [m]": [
                               np.linalg.norm(c[i] - c[j]) for i, j in loops]},
             draw)


# ---------------------------------------------------------------------------
# factor / projection errors
# ---------------------------------------------------------------------------

def plot_factor_errors(figs: Figures, bundles) -> dict:
    """Mean stereo-factor error per window, before and after
    optimization."""
    n = np.maximum(bundles.num_obs, 1)
    mean_final = np.sqrt(2.0 * bundles.cost / (3.0 * n))
    mean_init = np.sqrt(2.0 * bundles.cost0 / (3.0 * n))
    figs.add(*_curve("mean_factor_error.png", np.arange(len(mean_init)),
                     {"initial": mean_init, "optimized": mean_final},
                     "keyframe window", "mean factor error [px]",
                     "Bundle factor error per window", size=(8, 4),
                     legend=True))
    return {"mean_final_px": float(mean_final.mean()),
            "mean_init_px": float(mean_init.mean())}


def plot_median_projection_error(figs: Figures, bundles, calib) -> dict:
    """Median left-camera projection error of each window's first-keyframe
    factors, initial against optimized landmarks."""
    if bundles.meas is None:
        return {}
    B = bundles.poses.shape[0]
    sel = (bundles.cam_idx == 0) & (bundles.w > 0)
    bi, ri = np.nonzero(sel)
    lm = bundles.lm_idx[bi, ri]
    meas = bundles.meas[bi, ri]
    # final: optimized landmark through the optimized first pose; initial:
    # initial landmark through the identity initial pose (window frame)
    proj_f = _np_project(calib, _transform(bundles.poses[bi, 0],
                                           bundles.points[bi, lm]))
    proj_i = _np_project(calib, bundles.points0[bi, lm])
    errf = np.linalg.norm(meas[:, [0, 2]] - proj_f[:, [0, 2]], axis=-1)
    erri = np.linalg.norm(meas[:, [0, 2]] - proj_i[:, [0, 2]], axis=-1)
    order = np.argsort(bi, kind="stable")
    bounds = np.searchsorted(bi[order], np.arange(B + 1))
    med_i, med_f, x = [], [], []
    kfs = np.asarray(bundles.keyframes)
    for b in range(B):
        a, e = bounds[b], bounds[b + 1]
        if e > a:
            med_i.append(float(np.median(erri[order[a:e]])))
            med_f.append(float(np.median(errf[order[a:e]])))
            x.append(int(kfs[b]))
    figs.add(*_curve("median_projection_error.png", np.asarray(x),
                     {"initial error": np.asarray(med_i),
                      "final error": np.asarray(med_f)},
                     "keyframe", "median projection error [px]",
                     "Median projection error vs first keyframe",
                     size=(8, 4), legend=True, grid=True))
    return {"median_init_px": float(np.median(med_i)) if med_i else 0.0,
            "median_final_px": float(np.median(med_f)) if med_f else 0.0}


def plot_disparity_histogram(figs: Figures, db) -> None:
    """Histogram of the stereo disparities of all valid links (extra)."""
    links = db.links[db.link_valid]
    disp = links[:, 0] - links[:, 1]

    def draw(plt):
        plt.figure(figsize=(6, 4))
        plt.hist(disp, bins=60, log=True)
        plt.xlabel("disparity [px]")
        plt.ylabel("count (log)")
        plt.title("Stereo disparity histogram")

    figs.add("disparity_hist.png", {"disparity [px]": disp}, draw)


def plot_reproj_vs_track_length(figs: Figures, name, db, T_frames, calib,
                                max_tracks: int = 500, seed: int = 0) -> dict:
    """Median reprojection error against the distance in frames from the
    triangulation frame, over a seeded sample of tracks of length >= 3:
    each track is backprojected at its largest-disparity frame, lifted to
    the world with ``T_frames`` and reprojected into every frame it spans
    (median_projection_vs_distance_{PnP,bundle})."""
    rng = np.random.default_rng(seed)
    lengths = db.track_lengths()
    ids = np.nonzero(lengths >= 3)[0]
    if len(ids) == 0:
        return {}
    sample = rng.choice(ids, size=min(max_tracks, len(ids)), replace=False)
    by_dist: dict[int, list] = {}
    inv_T = np.linalg.inv(T_frames)
    for t in sample:
        frs, slots = db.track_slots(int(t))
        links = db.links[frs, slots]
        k = int(np.argmax(links[:, 0] - links[:, 1]))
        pc = _np_backproject(calib, links[k])
        pw = inv_T[frs[k]] @ np.append(pc, 1.0)
        pred = _np_project(calib, _transform(T_frames[frs], pw[:3][None]
                                             .repeat(len(frs), 0)))
        errs = np.linalg.norm(pred - links, axis=-1)
        for i, f in enumerate(frs):
            by_dist.setdefault(abs(int(f) - int(frs[k])), []).append(errs[i])
    dists = sorted(by_dist)
    med = [float(np.median(by_dist[d])) for d in dists]
    figs.add(*_curve(f"median_projection_vs_distance_{name}.png",
                     np.asarray(dists), {"median reprojection error": med},
                     "frames from triangulation frame",
                     "median reprojection error [px]",
                     f"Projection error vs distance — {name}", size=(7, 4),
                     styles={"median reprojection error": {"marker": "o"}}))
    return {str(d): m for d, m in zip(dists, med)}


# ---------------------------------------------------------------------------
# debug probes: worst factor, loop match, one track
# ---------------------------------------------------------------------------

def plot_worst_factor(figs: Figures, bundles, calib,
                      images_left=None) -> dict:
    """The single worst stereo factor after optimization: measured against
    projected track across its window, and with ``images_left`` the
    measurement on its image patch. Nothing without an active factor."""
    active = None if bundles.meas is None else bundles.w > 0
    if active is None or not active.any():
        return {}
    bi, ri = np.nonzero(active)
    lm = bundles.lm_idx[bi, ri]
    ci = bundles.cam_idx[bi, ri]
    proj = _np_project(calib, _transform(bundles.poses[bi, ci],
                                         bundles.points[bi, lm]))
    meas = bundles.meas[bi, ri]
    err = np.linalg.norm((proj - meas) * bundles.w[bi, ri][:, None], axis=-1)
    worst = int(np.argmax(err))
    wb, wl = int(bi[worst]), int(lm[worst])
    rows = np.nonzero(active[wb] & (bundles.lm_idx[wb] == wl))[0]
    cams = bundles.cam_idx[wb, rows]
    m = bundles.meas[wb, rows]
    p = _np_project(calib, _transform(bundles.poses[wb, cams],
                                      bundles.points[wb, wl][None]
                                      .repeat(len(rows), 0)))
    frames = bundles.frames[wb, cams]
    per_frame = np.linalg.norm(p[:, [0, 2]] - m[:, [0, 2]], axis=-1)
    patch = None
    if images_left is not None and len(frames):
        k = int(np.argmax(per_frame))
        u, v = m[k][[0, 2]]
        H, W = images_left.shape[1:3]
        y0 = int(np.clip(v - 40, 0, H - 80))
        x0 = int(np.clip(u - 40, 0, W - 80))
        patch = (np.asarray(images_left[int(frames[k]), y0:y0 + 80,
                                        x0:x0 + 80]), u - x0, v - y0)

    def draw(plt):
        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].plot(m[:, 0], m[:, 2], "go-", label="measured (uL, v)")
        ax[0].plot(p[:, 0], p[:, 2], "rx--", label="projected")
        ax[0].invert_yaxis()
        ax[0].set_xlabel("u [px]")
        ax[0].set_ylabel("v [px]")
        ax[0].legend()
        ax[0].set_title(f"worst factor: window {wb}, landmark {wl}, err "
                        f"{err[worst]:.1f}px")
        ax[1].plot(frames, per_frame, "o-")
        ax[1].set_xlabel("frame")
        ax[1].set_ylabel("left-cam error [px]")
        ax[1].set_title("per-frame projection error of the worst factor")
        if patch is not None:
            axin = ax[0].inset_axes([0.65, 0.05, 0.33, 0.45])
            axin.imshow(patch[0], cmap="gray")
            axin.scatter([patch[1]], [patch[2]], c="r", s=14)
            axin.axis("off")

    figs.add("worst_factor.png", {"left-cam error [px]": per_frame}, draw)
    return {"worst_factor_err_px": float(err[worst]), "window": wb,
            "landmark": wl}


def loop_matches(result, closure):
    """Mutual nearest-neighbour matches of a closure's two keyframes,
    recomputed from the frontend's descriptors on their device (kernel B2
    on the card): (source slots, target slots)."""
    from ..ops import matching

    fe = result.frontend
    fi, fj = int(closure.frame_i), int(closure.frame_j)
    desc = fe.desc.gather(np.array([fi, fj])).to(torch.float32)
    valid = torch.as_tensor(np.asarray(fe.valid)[[fi, fj]],
                            device=desc.device)
    m = matching.mutual_match(desc[:1], desc[1:], valid[:1], valid[1:])
    tgt = m["target_idx"][0].cpu().numpy()
    src = np.nonzero(m["matched"][0].cpu().numpy())[0]
    return src, tgt[src]


def plot_loop_match(figs: Figures, result, closure, images_left,
                    max_lines: int = 60) -> int:
    """Side-by-side loop-pair picture with matched-feature lines; returns
    the number of matches."""
    fe = result.frontend
    fi, fj = int(closure.frame_i), int(closure.frame_j)
    src, tgt = loop_matches(result, closure)
    H = images_left.shape[1]
    canvas = np.concatenate([np.asarray(images_left[fi]),
                             np.asarray(images_left[fj])], axis=0)
    a = fe.xy[fi, src[:max_lines]]
    b = fe.xy[fj, tgt[:max_lines]]

    def draw(plt):
        plt.figure(figsize=(10, 7))
        plt.imshow(canvas, cmap="gray")
        for (x0, y0), (x1, y1) in zip(a, b):
            plt.plot([x0, x1], [y0, y1 + H], "-", lw=0.5, color="lime")
        plt.scatter(a[:, 0], a[:, 1], s=4, c="r")
        plt.scatter(b[:, 0], b[:, 1] + H, s=4, c="r")
        plt.axis("off")
        plt.title(f"loop match {fi} <-> {fj}: {closure.num_inliers} inliers "
                  f"({closure.inlier_frac:.2f})")

    figs.add(f"loop_match_{fi}_{fj}.png", {"source slot": src}, draw)
    return int(len(src))


def visualize_track(out_dir, db, images_left, track_id: int, crop: int = 10,
                    max_frames: int = 12) -> bool:
    """Patch strip of one feature track across its frames, drawn at once
    into ``out_dir/track_<id>.png``; False (nothing drawn) without
    matplotlib."""
    frs, slots = db.track_slots(track_id)
    frs, slots = frs[:max_frames], slots[:max_frames]
    H, W = images_left.shape[1:3]
    patches = []
    for f, s in zip(frs, slots):
        x, y = db.xy[f, s]
        x0 = int(np.clip(x - crop, 0, W - 2 * crop))
        y0 = int(np.clip(y - crop, 0, H - 2 * crop))
        patches.append((int(f), np.asarray(
            images_left[f, y0:y0 + 2 * crop, x0:x0 + 2 * crop]),
            x - x0, y - y0))

    def draw(plt):
        n = len(patches)
        fig, axes = plt.subplots(1, n, figsize=(1.2 * n, 1.8))
        axes = [axes] if n == 1 else axes
        for ax, (f, img, u, v) in zip(axes, patches):
            ax.imshow(img, cmap="gray")
            ax.scatter([u], [v], c="r", s=12)
            ax.set_title(str(f), fontsize=7)
            ax.axis("off")
        fig.suptitle(f"track {track_id}")

    figs = Figures()
    figs.add(f"track_{track_id}.png", {}, draw)
    return figs.draw(Path(out_dir)) != NO_MATPLOTLIB


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_analysis(result, T_gt: np.ndarray, out_dir, images_left=None) -> dict:
    """Every number of the suite (returned, and written to
    ``out_dir/analysis.json``), then every figure. With ``images_left``
    the image probes run too (the loop-match probe per closure)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    figs = Figures()
    db = result.db
    kfs = result.pose_graph.keyframes
    T_gt_kf = T_gt[kfs]
    T_pnp = result.T_frontend
    T_bund = result.T_bundled_frames
    report: dict = {"db_stats": db.stats()}

    plot_track_stats(figs, db)
    stages = {"frontend (PnP)": T_pnp, "bundle-adjusted": T_bund,
              "pose graph": result.pose_graph_pre_lc.nodes}
    if result.closures:
        stages["pose graph + LC"] = result.pose_graph.nodes
    plot_trajectories(figs, T_gt, stages)
    report["abs_error"] = {
        "PnP": plot_abs_errors(figs, "PnP", T_pnp, T_gt),
        "bundle": plot_abs_errors(figs, "bundle", T_bund, T_gt),
        "poseGraph": plot_abs_errors(figs, "poseGraph",
                                     result.pose_graph_pre_lc.nodes, T_gt_kf,
                                     x=np.asarray(kfs)),
    }
    if result.closures:
        report["abs_error"]["poseGraph_LC"] = plot_abs_errors(
            figs, "poseGraph_LC", result.pose_graph.nodes, T_gt_kf,
            x=np.asarray(kfs))
    report["rel_consecutive"] = plot_rel_error_pairs(
        figs, result.bundles, T_pnp, T_gt)
    report["rel_subseq"] = {
        "PnP": plot_rel_subsection(figs, "PnP", T_pnp, T_gt),
        "bundle": plot_rel_subsection(figs, "bundle", T_bund, T_gt),
    }
    report["uncertainty"] = plot_uncertainty(
        figs, result.pose_graph_pre_lc,
        result.pose_graph if result.closures else None)
    plot_loops(figs, result.pose_graph, T_gt_kf)
    plot_disparity_histogram(figs, db)
    report["factor_errors"] = plot_factor_errors(figs, result.bundles)
    if getattr(result, "calib", None) is not None:
        calib = result.calib
        report["median_projection"] = plot_median_projection_error(
            figs, result.bundles, calib)
        report["reproj_vs_dist"] = {
            "PnP": plot_reproj_vs_track_length(figs, "PnP", db, T_pnp, calib,
                                               max_tracks=200),
            "bundle": plot_reproj_vs_track_length(figs, "bundle", db, T_bund,
                                                  calib, max_tracks=200),
        }
        report["worst_factor"] = plot_worst_factor(
            figs, result.bundles, calib, images_left=images_left)
        if images_left is not None:
            report["loop_match"] = {
                f"{c.frame_i}_{c.frame_j}": plot_loop_match(
                    figs, result, c, images_left)
                for c in result.closures}
    report["ate_rmse"] = {
        "frontend": metrics.ate_rmse(T_pnp, T_gt),
        "bundled": metrics.ate_rmse(T_bund, T_gt),
        "pose_graph": metrics.ate_rmse(result.pose_graph_pre_lc.nodes,
                                       T_gt_kf),
    }
    if result.closures:
        report["ate_rmse"]["pose_graph_lc"] = metrics.ate_rmse(
            result.pose_graph.nodes, T_gt_kf)
    report["num_closures"] = len(result.closures)

    report["plots"] = figs.draw(out_dir)
    report["artifacts"] = figs.summaries(report["plots"] != NO_MATPLOTLIB)
    (out_dir / "analysis.json").write_text(
        json.dumps(report, indent=2, default=float))
    return report
