"""Loop-closure detection and pose-graph correction.

Counterpart of ``slam_tpu/models/loop_closure.py``:

  * one Mahalanobis sweep prices every keyframe pair from the exact joint
    posterior (ops/pose_graph.py), refreshed after each accepted closure;
  * gated candidates are verified in speculative blocks of ``SPEC_Q``
    query keyframes: all their candidate pairs are matched in one call of
    kernel B2 (no window) and solved by one batched RANSAC;
  * an accepted pair is refined by a 2-pose mini-bundle (ops/ba.py), its
    edge inserted and the graph re-optimized;
  * familiar-path suppression: after a closure, keyframes that keep gating
    onto old ones are deferred; on leaving the segment they are re-verified
    from the back and exactly one more closure is committed.

Descriptors arrive as the frontend's float16 device tensor; the matcher
rounds them to bf16, as the JAX package's matcher does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from slam_tpu.config import LoopConfig, SlamConfig
from slam_tpu.models.trackstore import TrackStore

from ..ops import ba, matching, ransac, stereo
from .frontend import _pair_correspondences
from .pose_graph import PoseGraph

SPEC_Q = 4  # query keyframes verified per batched call


@dataclass
class Closure:
    kf_i: int          # earlier keyframe index (graph node)
    kf_j: int          # later keyframe index
    frame_i: int       # global frame ids
    frame_j: int
    num_inliers: int
    inlier_frac: float
    rel_T: np.ndarray  # frame_i cam -> frame_j cam extrinsic
    rel_cov: np.ndarray
    mahalanobis: float


def _verify_candidates(desc_q, valid_q, links_q, lvalid_q, desc_c, valid_c,
                       links_c, lvalid_c, calib, num_hypotheses: int,
                       threshold: float, generator=None):
    """Match + RANSAC of P (query, candidate) keyframe pairs at once, all
    inputs with a leading pair dimension. The pose maps the candidate
    (earlier) camera to the query (later) one. Returns per-pair
    num_inliers, frac, T, ok, match_tgt, inliers."""
    m = matching.mutual_match(desc_c, desc_q, valid_c, valid_q)
    pw, meas, corr_valid = _pair_correspondences(links_c, lvalid_c, links_q,
                                                 lvalid_q, m, calib)
    rr = ransac.ransac_pnp(pw, meas, corr_valid, calib,
                           num_hypotheses=num_hypotheses, threshold=threshold,
                           generator=generator)
    n_corr = corr_valid.sum(dim=1)
    return {"num_inliers": rr["num_inliers"],
            "frac": rr["num_inliers"] / torch.clamp(n_corr, min=1),
            "T": rr["T_w2c"], "ok": rr["ok"],
            "match_tgt": m["target_idx"], "inliers": rr["inliers"]}


def _refine_pair(links_i, links_j, inlier_mask, match_tgt, T_init, calib,
                 max_landmarks: int = 512, device="cpu"):
    """2-pose bundle on the inlier correspondences, padded to
    ``max_landmarks``; returns (rel_T, rel_cov) as numpy."""
    idx = np.nonzero(np.asarray(inlier_mask))[0][:max_landmarks]
    L = max_landmarks
    li = np.zeros(2 * L, np.int64)
    ci = np.zeros(2 * L, np.int64)
    meas = np.zeros((2 * L, 3), np.float32)
    w = np.zeros(2 * L, np.float32)
    n = len(idx)
    tgt = np.asarray(match_tgt)
    li[:n] = np.arange(n)
    li[L:L + n] = np.arange(n)
    ci[L:L + n] = 1
    meas[:n] = np.asarray(links_i)[idx]
    meas[L:L + n] = np.asarray(links_j)[tgt[idx]]
    w[:n] = 1.0
    w[L:L + n] = 1.0
    points0 = np.zeros((L, 3), np.float32)
    points0[:n] = stereo.backproject_np(calib, meas[:n])
    poses0 = np.stack([np.eye(4, dtype=np.float32),
                       np.asarray(T_init, np.float32)])

    def t(x):
        return torch.as_tensor(x, device=device)[None]

    calib_t = torch.tensor(np.asarray(calib, np.float32), device=device)
    ci_t, li_t, meas_t = t(ci), t(li), t(meas)
    poses, points, w2, _ = ba.optimize_bundle_pruned(
        t(poses0), t(points0), ci_t, li_t, meas_t, t(w), calib_t, iters=15)
    covs = ba.pose_covariances(poses, points, ci_t, li_t, meas_t, w2, calib_t)
    return poses[0, 1].cpu().numpy(), covs[0, 1].cpu().numpy()


def find_loops(pg: PoseGraph, db: TrackStore, desc: torch.Tensor,
               desc_valid: np.ndarray, calib, cfg: SlamConfig = SlamConfig(),
               timings: dict | None = None) -> list[Closure]:
    """Scan keyframes in order, gate by Mahalanobis distance, verify by
    batched matching + RANSAC, refine by mini-bundle, insert the edge and
    re-optimize. Mutates ``pg``; returns the accepted closures.

    ``desc`` is the frontend's (F, K, D) device tensor; every other input
    is host numpy. The verification runs on ``desc``'s device. Stage
    times (gate, verify, refine, re-optimize) accumulate into ``timings``
    when it is given."""
    lc: LoopConfig = cfg.loop
    device = desc.device
    calib_np = np.asarray(calib, np.float32)
    calib_t = torch.tensor(calib_np, device=device)
    kfs = pg.keyframes
    N = pg.num_nodes
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed + 1)

    tm = timings if timings is not None else {}
    for k_ in ("gate_s", "verify_s", "refine_s", "reopt_s", "gate_refreshes",
               "verify_calls"):
        tm.setdefault(k_, 0.0)

    def _timed(bucket, fn):
        t0 = time.perf_counter()
        out = fn()
        tm[bucket] += time.perf_counter() - t0
        return out

    def all_pairs_gate():
        ii, jj = np.tril_indices(N, k=-1)  # j < i pairs
        D_ = np.full((N, N), np.inf, np.float32)
        D_[ii, jj] = pg.gate_distances(jj, ii)
        return D_

    D = _timed("gate_s", all_pairs_gate)
    tm["gate_refreshes"] += 1
    closures: list[Closure] = []
    spec: dict[int, tuple] = {}

    def gated(n_):
        d_ = D[n_, : n_ - lc.keyframe_gap + 1]
        if d_.size == 0:
            return d_, np.zeros(0, np.int64)
        order = np.argsort(d_)
        return d_, order[d_[order] < lc.mahalanobis_thresh][:lc.max_candidates]

    def dev(x, dtype=None):
        return torch.as_tensor(x, device=device, dtype=dtype)

    def speculate_list(ns):
        """Verify the candidates of the first SPEC_Q gated keyframes of
        ``ns`` (any order) in one batched call; fill ``spec``."""
        batch = []
        for m_ in ns:
            if len(batch) >= SPEC_Q:
                break
            if m_ in spec:
                continue
            _, g = gated(m_)
            if len(g):
                gp = np.concatenate(
                    [g, np.repeat(g[:1], lc.max_candidates - len(g))])
                batch.append((m_, len(g), gp))
        if not batch:
            return
        tm["verify_calls"] += 1
        C = lc.max_candidates
        f_q = np.repeat([kfs[b[0]] for b in batch], C)
        f_c = np.asarray([kfs[int(g)] for b in batch for g in b[2]])

        def run():
            vr = _verify_candidates(
                desc[dev(f_q)], dev(desc_valid[f_q]), dev(db.links[f_q]),
                dev(db.link_valid[f_q]), desc[dev(f_c)],
                dev(desc_valid[f_c]), dev(db.links[f_c]),
                dev(db.link_valid[f_c]), calib_t, cfg.ransac.num_hypotheses,
                cfg.ransac.threshold_px, generator=gen)
            return {k: v.cpu().numpy() for k, v in vr.items()}

        vr = _timed("verify_s", run)
        for qi, (m_, n_good_, gp_) in enumerate(batch):
            sl = slice(qi * C, (qi + 1) * C)
            spec[m_] = ({k: v[sl] for k, v in vr.items()}, n_good_, gp_,
                        f_c[sl])

    def verify_one(n):
        """The first passing candidate of keyframe n in gate order, or
        None."""
        d, good = gated(n)
        if len(good) == 0:
            return None
        if n not in spec:
            speculate_list(range(n, N))
        vr, n_good, good_p, f_cands = spec.pop(n)
        n_inl = vr["num_inliers"]
        ok = vr["ok"] & (n_inl > lc.min_inliers)
        ok[n_good:] = False  # padding lanes never accepted
        if not ok.any():
            return None
        c = int(np.nonzero(ok)[0][0])
        g = int(good_p[c])
        return (g, int(f_cands[c]), int(n_inl[c]), float(vr["frac"][c]),
                vr["inliers"][c], vr["match_tgt"][c], vr["T"][c], float(d[g]))

    def commit(n, hit):
        nonlocal D
        g, fi, n_inl, frac, inliers, match_tgt, T0, maha = hit
        fj = kfs[n]
        rel_T, rel_cov = _timed("refine_s", lambda: _refine_pair(
            db.links[fi], db.links[fj], inliers, match_tgt, T0, calib_np,
            max_landmarks=cfg.bundle.max_landmarks, device=device))
        closures.append(Closure(kf_i=g, kf_j=n, frame_i=fi, frame_j=fj,
                                num_inliers=n_inl, inlier_frac=frac,
                                rel_T=rel_T, rel_cov=rel_cov,
                                mahalanobis=maha))
        pg.add_edge(g, n, rel_T, rel_cov, loop=True)
        spec.clear()  # the posterior changed; discard speculation
        _timed("reopt_s", pg.optimize)
        D = _timed("gate_s", all_pairs_gate)
        tm["gate_refreshes"] += 1

    def commit_from_back(deferred):
        """Leaving a familiar segment: re-verify the deferred keyframes
        from the back, speculating backward in blocks of SPEC_Q, and
        commit the first that passes."""
        rev = list(reversed(deferred))
        for s in range(0, len(rev), SPEC_Q):
            blk = rev[s:s + SPEC_Q]
            if any(n_ not in spec for n_ in blk):
                speculate_list(blk)
            for n_ in blk:
                hit = verify_one(n_)
                if hit is not None:
                    commit(n_, hit)
                    return

    familiar = False
    deferred: list[int] = []
    for n in range(lc.keyframe_gap, N):
        _, good = gated(n)
        if len(good) == 0:
            if deferred:
                commit_from_back(deferred)
            familiar = False
            deferred = []
            continue
        if familiar:
            deferred.append(n)
            continue
        hit = verify_one(n)
        if hit is not None:
            commit(n, hit)
            familiar = True
    if deferred:  # the sequence ended inside a familiar segment
        commit_from_back(deferred)
    return closures


def save_closures(closures: list, path) -> None:
    """Closure list as one npz, in the JAX package's format."""
    np.savez_compressed(
        str(path),
        kf_i=np.asarray([c.kf_i for c in closures], np.int32),
        kf_j=np.asarray([c.kf_j for c in closures], np.int32),
        frame_i=np.asarray([c.frame_i for c in closures], np.int32),
        frame_j=np.asarray([c.frame_j for c in closures], np.int32),
        num_inliers=np.asarray([c.num_inliers for c in closures], np.int32),
        inlier_frac=np.asarray([c.inlier_frac for c in closures], np.float32),
        rel_T=np.stack([c.rel_T for c in closures]) if closures
        else np.zeros((0, 4, 4), np.float32),
        rel_cov=np.stack([c.rel_cov for c in closures]) if closures
        else np.zeros((0, 6, 6), np.float32),
        mahalanobis=np.asarray([c.mahalanobis for c in closures], np.float32))


def load_closures(path) -> list:
    with np.load(str(path)) as z:
        return [Closure(kf_i=int(z["kf_i"][i]), kf_j=int(z["kf_j"][i]),
                        frame_i=int(z["frame_i"][i]),
                        frame_j=int(z["frame_j"][i]),
                        num_inliers=int(z["num_inliers"][i]),
                        inlier_frac=float(z["inlier_frac"][i]),
                        rel_T=z["rel_T"][i], rel_cov=z["rel_cov"][i],
                        mahalanobis=float(z["mahalanobis"][i]))
                for i in range(len(z["kf_i"]))]
