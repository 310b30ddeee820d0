"""Frontend and bundle adjustment overlapped: two stage groups of a mesh.

Counterpart of ``slam_tpu/parallel/stage_overlap.py``. The mesh's shards
split into a frontend group (steps of ``chunk_frames`` frames per shard,
parallel/sharded_frontend.py) and a BA group (window batches padded to a
multiple of its shards, parallel/sharded_ba.py). As each frontend step's
outputs reach the host, tracks are chained incrementally
(``trackstore.chain_tracks``), the greedy keyframe cut is resumed from
the last final keyframe (``select_keyframes(start=...)``), and every
window whose keyframe span is complete is built and dispatched to the BA
group without waiting for it. The only blocking point is the gather of
every pending BA batch at the end.

A cut is final once the cut condition fired inside the processed prefix:
a cut at the prefix's last frame may exist only because the prefix ended,
so it is deferred to the next flush. The keyframes and windows are then
those of the sequential pipeline.

On one card both groups share the device, and the overlap is two CUDA
streams: frontend steps on the default stream (``run_frames``, which
takes each step's outputs in one step behind the device), BA batches on a
stream of their own. BA's inputs are uploaded on that stream and its
outputs read after it is synchronised, so no tensor crosses streams.
BA's LM loop is launched from the frontend's thread, between its steps:
a worker thread of its own gained nothing on an H100 (PERF.md).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from ..config import SlamConfig
from ..models import bundle as bundle_mod
from ..models import frontend as frontend_mod
from ..models.trackstore import NO_ID, TrackStore, chain_tracks
from .mesh import Mesh, make_mesh
from .sharded_ba import ba_training_step
from .sharded_frontend import step_config

_ACC = ("xy", "links", "link_valid", "valid", "match_prev", "inlier_prev",
        "inlier_frac")


def split_mesh(mesh: Mesh | None, fe_devices: int | None = None,
               axis: str = "dp") -> tuple[Mesh, Mesh]:
    """(frontend group, BA group) of a mesh's shards: the first
    ``fe_devices`` (by default half, rounded up) and the rest. A 1-shard
    mesh, or none (a 1-shard mesh on the card), is both groups."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    devs = mesh.devices
    if len(devs) == 1:
        m = Mesh(devs, axis)
        return m, m
    n_fe = fe_devices if fe_devices is not None else (len(devs) + 1) // 2
    n_fe = max(1, min(n_fe, len(devs) - 1))
    return Mesh(devs[:n_fe], axis), Mesh(devs[n_fe:], axis)


def run_pipeline_overlapped(images_left: np.ndarray,
                            images_right: np.ndarray, calib,
                            cfg: SlamConfig = SlamConfig(),
                            mesh: Mesh | None = None,
                            fe_devices: int | None = None):
    """Frontend + bundle adjustment overlapped. Returns (FrontendResult,
    TrackStore, BundleResult), the inputs of the pose-graph and
    loop-closure stages."""
    fe_mesh, ba_mesh = split_mesh(mesh, fe_devices)
    dev = fe_mesh.device
    cuda = dev.type == "cuda"
    F, K = images_left.shape[0], cfg.features.max_kp
    bc = cfg.bundle
    ba_step = ba_training_step(ba_mesh, calib, iters=bc.lm_iters,
                               min_depth=bc.min_depth,
                               max_depth=bc.max_depth,
                               huber_delta=bc.huber_delta_px)
    ba_stream = torch.cuda.Stream(dev) if cuda else None

    # the processed prefix, filled per step (no O(F^2) concatenations)
    acc = {"xy": np.zeros((F, K, 2), np.float32),
           "links": np.zeros((F, K, 3), np.float32),
           "link_valid": np.zeros((F, K), bool),
           "valid": np.zeros((F, K), bool),
           "match_prev": np.full((F, K), -1, np.int32),
           "inlier_prev": np.zeros((F, K), bool),
           "inlier_frac": np.zeros(F, np.float32)}
    T_all = np.zeros((F, 4, 4), np.float32)
    track_ids = np.full((F, K), NO_ID, np.int32)
    st = SimpleNamespace(next_track=0, frames_done=0, last_final_kf=0)
    kfs_final = [0]
    pending = []  # (device outputs, real windows, batch)

    def flush(final: bool) -> None:
        """Finalize the new keyframe cuts of the processed prefix and
        dispatch their windows to the BA group."""
        n = st.frames_done
        if st.last_final_kf >= n - 1:
            return
        if not final and n - st.last_final_kf < cfg.keyframes.min_gap + 1:
            return
        front = SimpleNamespace(desc=None,
                                **{k: v[:n] for k, v in acc.items()})
        db = TrackStore._finalize(front, track_ids[:n], st.next_track)
        cuts = bundle_mod.select_keyframes(db, T_all[:n], cfg.keyframes,
                                           start=st.last_final_kf)[1:]
        if not final and cuts and cuts[-1] >= n - 1:
            cuts = cuts[:-1]  # a prefix-edge cut waits for more frames
        if not cuts:
            return
        batch = bundle_mod.build_windows(db, T_all[:n],
                                         [st.last_final_kf] + cuts, bc)
        bundle_mod.init_landmarks(batch, calib)
        B = batch.num_windows
        on_ba = torch.cuda.stream(ba_stream) if cuda else \
            contextlib.nullcontext()
        with on_ba:
            out = ba_step(*bundle_mod.window_inputs(
                batch, 0, B, B + (-B) % ba_mesh.size))
        pending.append((out, B, batch))
        kfs_final.extend(cuts)
        st.last_final_kf = cuts[-1]

    def on_chunk(start, n, out, T_w2c):
        T_all[start:start + n] = T_w2c
        for k in _ACC:
            acc[k][start:start + n] = out[k]
        st.next_track = chain_tracks(track_ids, st.next_track,
                                     acc["match_prev"], acc["inlier_prev"],
                                     start, start + n)
        st.frames_done = start + n
        flush(final=False)

    fe = frontend_mod.run_frames(
        frontend_mod.ArrayFrames(images_left, images_right), calib,
        step_config(cfg, fe_mesh), dev, on_chunk=on_chunk)
    flush(final=True)
    db = TrackStore._finalize(fe, track_ids, st.next_track)

    # the single blocking point: every pending BA batch
    if cuda:
        ba_stream.synchronize()
    parts = [[t[:real_B].cpu().numpy() for t in out]
             for out, real_B, _ in pending]
    batches = [b for _, _, b in pending]
    merged = bundle_mod.BundleBatch(
        keyframes=list(kfs_final),
        **{k: np.concatenate([getattr(b, k) for b in batches])
           for k in bundle_mod.WINDOW_INPUTS + ("n_poses", "frames",
                                                "track_of_lm")})
    fields = [np.concatenate([p[i] for p in parts]) for i in range(7)]
    return fe, db, bundle_mod._assemble_bundle_result(merged, *fields)
