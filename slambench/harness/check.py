"""The comparison that decides ``correct``.

The program's outputs of a sequence (a digest of its ``PipelineResult``)
are held against the plain reference's outputs of the same sequence
(``reference/slamref``, run on the same uint8 images, calibration and
configuration), layer by layer:

  frontend_step_median_m    the median over frames of the gap between
  frontend_step_median_deg  the two sides' frame-to-frame motions (from
                            the frontend's ``T_w2c``), translation and
                            rotation;
  bundles_gap_m             the widest centre gap of the window BA's
                            keyframe poses (``T_w2c_keyframes``) over the
                            keyframes both sides chose;
  pose_graph_gap_m          the same for the pose graph before loop
                            closure,
  loop_closed_gap_m         and for the loop-closed graph;
  loop_correction_rel       how far the program's loop-closure moves (a
                            keyframe's centre after loop closure less
                            before) lie from the reference's, over the
                            reference's largest move (at least 1 mm): 1
                            when the program closes no loop that the
                            reference closes.

Each is the worst over the sequences compared and is judged against its
limit in ``limits/<cell>.json``; a pose that is not finite gives an
infinite gap. Reported beside them and not judged (PERF.md, section 4,
says why): ``frontend_gap_m``, the widest gap of the frontend's chained
extrinsics, and the keyframes and closures that only one side chose.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("frontend_gap_m", "frontend_step_median_m",
           "frontend_step_median_deg",
           "keyframes_differ", "bundles_gap_m", "pose_graph_gap_m",
           "closures_differ", "loop_closed_gap_m", "loop_correction_rel")
MIN_CORRECTION_M = 1e-3


def digest(res) -> dict:
    """What the comparison reads of the program's ``PipelineResult``,
    copied to the host."""
    fe = res.frontend
    return {"frontend": np.asarray(fe.T_w2c, np.float64),
            "inliers": np.asarray(fe.num_inliers),
            "xy": np.asarray(fe.xy), "valid": np.asarray(fe.valid),
            "keyframes": np.asarray(res.bundles.keyframes, np.int64),
            "bundles": np.asarray(res.bundles.T_w2c_keyframes, np.float64),
            "pose_graph": np.asarray(res.pose_graph_pre_lc.nodes,
                                     np.float64),
            "closures": sorted((int(c.frame_i), int(c.frame_j))
                               for c in res.closures),
            "loop_closed": np.asarray(res.pose_graph.nodes, np.float64)}


def centres(T: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (N, 4, 4) world-to-camera extrinsics."""
    T = np.asarray(T, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0:
        return 0.0
    d = np.linalg.norm(centres(a) - centres(b), axis=1)
    return float(np.max(np.where(np.isfinite(d), d, np.inf)))


def _common(prog: dict, ref: dict, key: str) -> float:
    """Centre gap of a keyframe-indexed layer over the keyframes that
    both sides chose."""
    kp, kr = list(prog["keyframes"]), list(ref["keyframes"])
    both = sorted(set(kp) & set(kr))
    ip = [kp.index(k) for k in both]
    ir = [kr.index(k) for k in both]
    Tp, Tr = prog[key], ref[key]
    if len(Tp) != len(kp) or len(Tr) != len(kr):
        return float("inf")
    return _gap(Tp[ip], Tr[ir])


def motions(T: np.ndarray) -> np.ndarray:
    """Frame-to-frame motions T[f] T[f-1]^-1 of (F, 4, 4) extrinsics."""
    T = np.asarray(T, np.float64)
    return T[1:] @ np.linalg.inv(T[:-1])


def angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angles of (N, 3, 3) rotations, accurate near zero."""
    s = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], -1)
    c = np.trace(R, axis1=1, axis2=2) - 1.0
    return np.degrees(np.arctan2(np.linalg.norm(s, axis=1), c))


def step_gaps(prog: dict, ref: dict):
    """Per frame: the gap between the two sides' frame-to-frame motions
    (from the frontend's extrinsics), translation (m) and rotation
    (degrees)."""
    a, b = motions(prog["frontend"]), motions(ref["frontend"])
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    R = np.einsum("fij,fkj->fik", a[:, :3, :3], b[:, :3, :3])
    return dt, angle_deg(R)


def _median(x: np.ndarray) -> float:
    return float(np.median(np.where(np.isfinite(x), x, np.inf))) if len(x) \
        else 0.0


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers of one sequence."""
    if prog["frontend"].shape != ref["frontend"].shape:
        fe = mt = mr = float("inf")
    else:
        fe = _gap(prog["frontend"], ref["frontend"])
        dt, dr = step_gaps(prog, ref)
        mt, mr = _median(dt), _median(dr)
    return {
        "frontend_gap_m": fe,
        "frontend_step_median_m": mt,
        "frontend_step_median_deg": mr,
        "keyframes_differ": float(len(set(prog["keyframes"].tolist())
                                      ^ set(ref["keyframes"].tolist()))),
        "bundles_gap_m": _common(prog, ref, "bundles"),
        "pose_graph_gap_m": _common(prog, ref, "pose_graph"),
        "closures_differ": float(len(set(prog["closures"])
                                     ^ set(ref["closures"]))),
        "loop_closed_gap_m": _common(prog, ref, "loop_closed"),
        "loop_correction_rel": _correction(prog, ref),
    }


def _correction(prog: dict, ref: dict) -> float:
    """max |move_p - move_r| / max(max |move_r|, MIN_CORRECTION_M) over the
    keyframes both chose, a move being a keyframe's centre in the
    loop-closed graph less its centre in the pose graph."""
    kp, kr = list(prog["keyframes"]), list(ref["keyframes"])
    both = sorted(set(kp) & set(kr))
    ip = [kp.index(k) for k in both]
    ir = [kr.index(k) for k in both]
    if not both:
        return float("inf")

    def move(d, idx):
        return (centres(d["loop_closed"][idx])
                - centres(d["pose_graph"][idx]))

    mr = move(ref, ir)
    gap = np.linalg.norm(move(prog, ip) - mr, axis=1).max()
    den = max(float(np.linalg.norm(mr, axis=1).max()), MIN_CORRECTION_M)
    return float(gap / den) if np.isfinite(gap) else float("inf")


def worst(per_sequence: list) -> dict:
    return {k: max(d[k] for d in per_sequence) for k in NUMBERS}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit at most its limit (the others are reported, not judged)."""
    out = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS
           if k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return bool(ok), out
