"""The frontend over a mesh: a step of ``chunk_frames`` frames per shard.

Counterpart of ``slam_tpu/parallel/sharded_frontend.py``. The frontend
chunk is data-parallel over frames but for its cross-frame couplings (the
shifted "previous frame" arrays, the failure recovery's running maximum,
the pose chain), which the one-frame carry stitches across chunk
boundaries. The JAX package shards a step of ``chunk_frames x devices``
frames over the mesh. In one process the shards share one device, so a
step is simply a chunk of that many frames, run by
``models.frontend.run_frames`` with its pinned staging, copy stream and
overlapped read-backs. RANSAC for step s draws from
``frontend.chunk_generator(cfg, s, device)``, the port's counterpart of
``fold_in(base_key, s)``. A 1-shard mesh gives ``run_frontend``'s result
bit for bit; the descriptors stay on the device in a ``DescriptorBank``.

Over ranks, rank r takes the step's r-th contiguous share of frames and
the couplings cross ranks thus:

  1. each rank detects, describes and stereo-matches its frames
     (``frontend.chunk_features``);
  2. one host gather of every rank's last frame: rank r's first frame is
     matched against rank r - 1's last (rank 0's against the carry);
  3. temporal matching and RANSAC (``frontend.chunk_motion``), every rank
     drawing the whole step's hypotheses and keeping its rows, so that
     the draws are the one-process mesh's;
  4. one host gather of the per-frame outputs; then every rank applies
     the failure recovery's running maximum and the pose chain to the
     whole step (``frontend.chunk_poses``), as one process would.

The next step's carry is the last rank's last frame. A rank keeps its own
frames' descriptors on its device; the other ranks' are recomputed from
the images on first access (the ``DescriptorBank`` of a resumed run),
at the batch shape they were made at. The result equals the one-process
mesh's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import SlamConfig
from ..models import frontend as frontend_mod
from .mesh import Mesh, host_gather


def step_config(cfg: SlamConfig, mesh: Mesh) -> SlamConfig:
    """``cfg`` with the chunk widened to one step: ``chunk_frames`` frames
    per shard."""
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, chunk_frames=cfg.runtime.chunk_frames * mesh.size))


def frontend_training_step(mesh: Mesh, cfg: SlamConfig, calib,
                           with_carry: bool = False):
    """One frontend step on this process's device: fn(left (F, H, W),
    right (F, H, W), [carry,] generator) -> (per-frame dict, carry), F
    being ``chunk_frames * mesh.size`` in one process (a shorter last step
    is zero-padded to it by the caller, as ``run_frames`` does)."""
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=mesh.device)

    if with_carry:
        def step(left, right, carry, generator):
            return frontend_mod.process_chunk(left, right, carry, calib_t,
                                              cfg, generator=generator)
        return step

    def step0(left, right, generator):
        return frontend_mod.process_chunk(left, right, None, calib_t, cfg,
                                          generator=generator)
    return step0


def run_frontend_sharded(images_left: np.ndarray, images_right: np.ndarray,
                         calib, mesh: Mesh, cfg: SlamConfig = SlamConfig(),
                         on_chunk=None) -> frontend_mod.FrontendResult:
    """The whole-sequence frontend in steps of ``chunk_frames * mesh.size``
    frames: on the mesh's device, or over its ranks (every rank calls this
    with the same inputs, and gets the whole result). ``on_chunk(start,
    n, outputs, T_w2c)`` gets each step's host outputs as
    ``models.frontend.run_frames`` gives them (over ranks, every rank the
    whole step's, after the host gather)."""
    frames = frontend_mod.ArrayFrames(images_left, images_right)
    if mesh.world == 1:
        return frontend_mod.run_frames(frames, calib, step_config(cfg, mesh),
                                       mesh.device, on_chunk=on_chunk)
    return _run_ranks(frames, calib, cfg, mesh, on_chunk)


def rank_chunks(cfg: SlamConfig, mesh: Mesh, num_frames: int) -> tuple:
    """How the frontend over ``mesh`` makes descriptors: (the config whose
    chunk is one rank's share of a step, [(start, n)] of every rank's
    share in frame order). A rank recomputes another rank's descriptors
    chunk by chunk at that config's batch shape, the one they were made
    at, so that the bits are the same."""
    per = cfg.runtime.chunk_frames * mesh.local_size
    rank_cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, chunk_frames=per))
    return rank_cfg, [(s, min(per, num_frames - s))
                      for s in range(0, num_frames, per)]


def _run_ranks(frames, calib, cfg: SlamConfig, mesh: Mesh,
               on_chunk=None) -> frontend_mod.FrontendResult:
    """The frontend over the mesh's ranks (module docstring)."""
    device, keys = mesh.device, frontend_mod.CARRY_KEYS
    per = cfg.runtime.chunk_frames * mesh.local_size  # a rank's frames
    step = per * mesh.world
    nF = frames.num
    calib_t = torch.as_tensor(np.asarray(calib, np.float32), device=device)
    bl, br = (torch.empty((per,) + frames.hw, dtype=frames.dtype)
              for _ in range(2))
    outs, T_w2c_all, desc_chunks = [], [], []
    carry, T_carry = None, np.eye(4, dtype=np.float32)
    for s, start in enumerate(range(0, nF, step)):
        mine = start + mesh.rank * per
        frames.fill(mine, max(0, min(per, nF - mine)), bl, br)
        feats = frontend_mod.chunk_features(bl.to(device), br.to(device),
                                            cfg)
        last = host_gather(mesh, {k: feats[k][-1:].cpu().numpy()
                                  for k in keys})
        prev = carry if mesh.rank == 0 else {
            k: torch.from_numpy(last[k][mesh.rank - 1]).to(device)
            for k in keys}
        mot = frontend_mod.chunk_motion(
            feats, prev, calib_t, cfg,
            generator=frontend_mod.chunk_generator(cfg, s, device),
            draw_rows=(mesh.rank * per, step))
        local = {k: v.cpu().numpy() for k, v in mot.items()}
        local.update((k, feats[k].cpu().numpy()) for k in keys
                     if k != "desc")
        full = host_gather(mesh, local)
        T_rel, T_chain = frontend_mod.chunk_poses(
            torch.from_numpy(full.pop("T_est")).to(device),
            torch.from_numpy(full["pose_ok"]).to(device),
            None if carry is None else carry["last_T"])
        n = min(step, nF - start)
        o = {k: v[:n] for k, v in full.items()}
        o["T_rel"] = T_rel[:n].cpu().numpy()
        o["T_chain"] = T_chain[:n].cpu().numpy()
        T_w2c = o["T_chain"] @ T_carry[None]
        T_carry = T_w2c[-1]
        outs.append(o)
        T_w2c_all.append(T_w2c)
        if on_chunk is not None:
            on_chunk(start, n, o, T_w2c)
        for r in range(mesh.world):
            s_r = start + r * per
            n_r = min(per, nF - s_r)
            if n_r > 0:
                desc_chunks.append((s_r, n_r, feats["desc"][:n_r].half()
                                    if r == mesh.rank else None))
        carry = {k: torch.from_numpy(last[k][-1]).to(device) for k in keys}
        carry["last_T"] = T_rel[-1]
    recompute = functools.partial(frontend_mod._recompute_chunks, frames,
                                  rank_chunks(cfg, mesh, nF)[0], device)
    return frontend_mod._assemble_result(outs, T_w2c_all, desc_chunks,
                                         recompute, device)
