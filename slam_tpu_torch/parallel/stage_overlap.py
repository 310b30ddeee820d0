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

In one process both groups share the device, and the overlap is two CUDA
streams: frontend steps on the default stream (``run_frames``, which
takes each step's outputs in one step behind the device), BA batches on a
stream of their own. BA's inputs are uploaded on that stream and its
outputs read after it is synchronised, so no tensor crosses streams.
BA's LM loop is launched from the frontend's thread, between its steps:
a worker thread of its own gained nothing on an H100 (PERF.md).

Over the W ranks of a process group the groups are ranks: ranks [0, n_fe)
run the frontend over their own process group (the rank frontend of
parallel/sharded_frontend.py), ranks [n_fe, W) the window BA over
theirs, each rank launching from its own host thread. Every frontend
rank holds each step's whole outputs after the step's host gather and
makes the same cuts; the first one alone streams each flush's windows to
every BA rank point to point (``dist.isend``: a header with the batch's
window count and capacities, then the window arrays; a negative count
ends the stream), on the host under gloo and on the card under nccl, and
goes on with the next step without waiting. A BA rank receives batches
until the end of the stream, solving its share of each (the batch padded
to a multiple of the BA group's shards) on a stream of its own, and the
BA group joins its results with one host gather per batch. Then one
``all_gather_object`` over every rank gives each rank what it lacks: the
frontend's host outputs, track ids and keyframes from the first frontend
rank, the BA results from the first BA rank. Every rank returns the same
result. Descriptors stay on the frontend rank that made them; every other
rank recomputes those it is asked for from the images, at the batch shape
of the frontend ranks' steps. The two process groups are made once per
(W, n_fe) and kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..models import bundle as bundle_mod
from ..models import frontend as frontend_mod
from ..models.trackstore import NO_ID, TrackStore, chain_tracks
from .mesh import Mesh, host_gather, make_mesh
from .sharded_ba import ba_training_step
from .sharded_frontend import rank_chunks, run_frontend_sharded

_ACC = ("xy", "links", "link_valid", "valid", "match_prev", "inlier_prev",
        "inlier_frac")
# what a BA rank needs of a window batch to solve it and to assemble the
# result: each array's shape in (B, P, L, M) and its dtype
_WIRE = {"poses0": (lambda B, P, L, M: (B, P, 4, 4), np.float32),
         "points0": (lambda B, P, L, M: (B, L, 3), np.float32),
         "cam_idx": (lambda B, P, L, M: (B, M), np.int32),
         "lm_idx": (lambda B, P, L, M: (B, M), np.int32),
         "meas": (lambda B, P, L, M: (B, M, 3), np.float32),
         "w": (lambda B, P, L, M: (B, M), np.float32),
         "n_poses": (lambda B, P, L, M: (B,), np.int32),
         "frames": (lambda B, P, L, M: (B, P), np.int32),
         "track_of_lm": (lambda B, P, L, M: (B, L), np.int32)}
# the process groups of each split: (default group, W, n_fe) -> groups
_GROUPS: dict = {}


def split_mesh(mesh: Mesh | None, fe_devices: int | None = None,
               axis: str = "dp") -> tuple[Mesh, Mesh]:
    """(frontend group, BA group) of a mesh's shards: the first
    ``fe_devices`` (by default half, rounded up) and the rest. A 1-shard
    mesh, or none (a 1-shard mesh on the card), is both groups. Over W > 1
    ranks the groups are ranks ``[0, n_fe)`` and ``[n_fe, W)``
    (``fe_devices`` counts ranks, one device each), each a mesh bound to a
    process group of its own; a rank gets both meshes, the other group's
    with ``rank`` -1. Every rank must call this alike: making a process
    group is collective over the default group."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n = mesh.world if mesh.world > 1 else len(mesh.devices)
    if n == 1:
        m = Mesh(mesh.devices, axis)
        return m, m
    n_fe = fe_devices if fe_devices is not None else (n + 1) // 2
    n_fe = max(1, min(n_fe, n - 1))
    if mesh.world == 1:
        devs = mesh.devices
        return Mesh(devs[:n_fe], axis), Mesh(devs[n_fe:], axis)
    world = dist.get_world_size()
    if mesh.ranks != tuple(range(world)):
        raise ValueError(
            f"the stage overlap splits the default process group's ranks; "
            f"this mesh spans ranks {mesh.ranks} of {world}")
    key = (dist.group.WORLD, world, n_fe)
    if key not in _GROUPS:  # both groups, in one order on every rank
        _GROUPS[key] = tuple(dist.new_group(list(r)) for r in (
            range(n_fe), range(n_fe, world)))
    fe_group, ba_group = _GROUPS[key]
    return (Mesh(mesh.devices, axis, fe_group, range(n_fe)),
            Mesh(mesh.devices, axis, ba_group, range(n_fe, world)))


class _BatchSolver:
    """The BA group's side: each window batch padded to a multiple of the
    group's shards and this rank's share launched on a stream of its own
    without waiting (``sharded_ba.ba_training_step``); at the end every
    batch's results, joined over the group's ranks."""

    def __init__(self, mesh: Mesh, calib, cfg: SlamConfig):
        bc = cfg.bundle
        self.mesh = mesh
        self.step = ba_training_step(mesh, calib, iters=bc.lm_iters,
                                     min_depth=bc.min_depth,
                                     max_depth=bc.max_depth,
                                     huber_delta=bc.huber_delta_px)
        cuda = mesh.device.type == "cuda"
        self.stream = torch.cuda.Stream(mesh.device) if cuda else None
        self.pending = []  # (device outputs, this rank's real windows)

    def dispatch(self, batch: bundle_mod.BundleBatch) -> None:
        B = batch.num_windows
        size = (B + (-B) % self.mesh.size) // self.mesh.world
        s = self.mesh.rank * size
        # a share that is all padding solves copies of the last window,
        # and keeps none of them
        n = max(min(s + size, B) - s, 0)
        s = min(s, B - 1)
        on_ba = (torch.cuda.stream(self.stream) if self.stream is not None
                 else contextlib.nullcontext())
        with on_ba:
            out = self.step(*bundle_mod.window_inputs(batch, s, s + max(n, 1),
                                                      size))
        self.pending.append((out, n))

    def results(self) -> list:
        """Every batch's (poses, points, w, cost, cost0, rel_T, rel_cov),
        host arrays of the whole batch (the single blocking point)."""
        if self.stream is not None:
            self.stream.synchronize()
        return [host_gather(self.mesh, tuple(t[:n].cpu().numpy()
                                             for t in out))
                for out, n in self.pending]


def _wire_device(mesh: Mesh) -> torch.device:
    """Where point-to-point tensors live: on the card under nccl, on the
    host under gloo."""
    return mesh.device if dist.get_backend() == "nccl" else \
        torch.device("cpu")


class _WindowSender:
    """The first frontend rank's stream of window batches to every BA
    rank: each send is posted and left running (``dist.isend``), its
    tensors kept until ``close``, which ends the stream and waits for
    every send."""

    def __init__(self, dsts, device: torch.device):
        self.dsts, self.device = list(dsts), device
        self.works, self.sent = [], []

    def _post(self, arrays) -> None:
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            self.sent.append(t)
            self.works += [dist.isend(t, dst) for dst in self.dsts]

    def send(self, batch: bundle_mod.BundleBatch) -> None:
        B, P = batch.frames.shape
        L, M = batch.points0.shape[1], batch.cam_idx.shape[1]
        self._post([np.array([B, P, L, M], np.int64)]
                   + [np.asarray(getattr(batch, k), dtype)
                      for k, (_, dtype) in _WIRE.items()])

    def close(self) -> None:
        self._post([np.array([-1, 0, 0, 0], np.int64)])
        for w in self.works:
            w.wait()
        self.works, self.sent = [], []


def _receive_windows(src: int, device: torch.device):
    """A BA rank's side of the stream: window batches (host arrays) from
    rank ``src`` until the end marker."""
    while True:
        header = torch.empty(4, dtype=torch.int64, device=device)
        dist.recv(header, src)
        B, P, L, M = header.tolist()
        if B < 0:
            return
        fields = {}
        for k, (shape, dtype) in _WIRE.items():
            t = torch.from_numpy(np.empty(shape(B, P, L, M), dtype)).to(
                device)
            dist.recv(t, src)
            fields[k] = t.cpu().numpy()
        yield bundle_mod.BundleBatch(keyframes=[], **fields)


_FE_HOST = tuple(f.name for f in dataclasses.fields(
    frontend_mod.FrontendResult) if f.name != "desc")


def _frontend_elsewhere(host: dict, images_left, images_right, cfg,
                        fe_mesh: Mesh,
                        device) -> frontend_mod.FrontendResult:
    """The frontend's result on a rank that did not run it: the first
    frontend rank's host outputs, and descriptors recomputed from the
    images on first access, chunk by chunk at the frontend ranks' batch
    shape."""
    frames = frontend_mod.ArrayFrames(images_left, images_right)
    rank_cfg, chunks = rank_chunks(cfg, fe_mesh, frames.num)
    recompute = functools.partial(frontend_mod._recompute_chunks, frames,
                                  rank_cfg, device)
    bank = frontend_mod.DescriptorBank([(s, n, None) for s, n in chunks],
                                       recompute, device)
    return frontend_mod.FrontendResult(desc=bank, **host)


def run_pipeline_overlapped(images_left: np.ndarray,
                            images_right: np.ndarray, calib,
                            cfg: SlamConfig = SlamConfig(),
                            mesh: Mesh | None = None,
                            fe_devices: int | None = None):
    """Frontend + bundle adjustment overlapped. Returns (FrontendResult,
    TrackStore, BundleResult), the inputs of the pose-graph and
    loop-closure stages. Over ranks every rank calls this with the same
    inputs and gets the same result."""
    fe_mesh, ba_mesh = split_mesh(mesh, fe_devices)
    ranked = not (fe_mesh.member and ba_mesh.member)
    F, K = images_left.shape[0], cfg.features.max_kp
    solver = _BatchSolver(ba_mesh, calib, cfg) if ba_mesh.member else None
    sender = None
    if ranked and dist.get_rank() == fe_mesh.ranks[0]:
        sender = _WindowSender(ba_mesh.ranks, _wire_device(fe_mesh))

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
    batches = []

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
                                         [st.last_final_kf] + cuts,
                                         cfg.bundle)
        bundle_mod.init_landmarks(batch, calib)
        batches.append(batch)
        if solver is not None:
            solver.dispatch(batch)
        elif sender is not None:
            sender.send(batch)
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

    fe = None
    if fe_mesh.member:
        fe = run_frontend_sharded(images_left, images_right, calib, fe_mesh,
                                  cfg, on_chunk=on_chunk)
        flush(final=True)
        if sender is not None:
            sender.close()
    else:
        for batch in _receive_windows(fe_mesh.ranks[0],
                                      _wire_device(ba_mesh)):
            batches.append(batch)
            solver.dispatch(batch)
    parts = solver.results() if solver is not None else None

    if ranked:
        # one exchange over every rank: the frontend from its first rank,
        # the BA results from the BA group's first
        me = dist.get_rank()
        mine = None
        if me == fe_mesh.ranks[0]:
            mine = {"fe": {k: getattr(fe, k) for k in _FE_HOST},
                    "track_ids": track_ids, "next_track": st.next_track,
                    "keyframes": kfs_final}
        elif me == ba_mesh.ranks[0]:
            mine = parts
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        front, parts = got[fe_mesh.ranks[0]], got[ba_mesh.ranks[0]]
        if fe is None:
            fe = _frontend_elsewhere(front["fe"], images_left, images_right,
                                     cfg, fe_mesh, ba_mesh.device)
            track_ids, kfs_final = front["track_ids"], front["keyframes"]
            st.next_track = front["next_track"]
    db = TrackStore._finalize(fe, track_ids, st.next_track)

    merged = bundle_mod.BundleBatch(
        keyframes=list(kfs_final),
        **{k: np.concatenate([getattr(b, k) for b in batches])
           for k in bundle_mod.WINDOW_INPUTS + ("n_poses", "frames",
                                                "track_of_lm")})
    fields = [np.concatenate([p[i] for p in parts]) for i in range(7)]
    return fe, db, bundle_mod._assemble_bundle_result(merged, *fields)
