"""The frontend over a mesh: a step of ``chunk_frames`` frames per shard.

Counterpart of ``slam_tpu/parallel/sharded_frontend.py``. The frontend
chunk is data-parallel over frames but for its cross-frame couplings (the
shifted "previous frame" arrays, the failure recovery's running maximum,
the pose chain), which the one-frame carry stitches across chunk
boundaries. The JAX package shards a step of ``chunk_frames x devices``
frames over the mesh; here the shards share one device, so a step is
simply a chunk of that many frames, run by ``models.frontend.run_frames``
with its pinned staging, copy stream and overlapped read-backs. RANSAC for
step s draws from ``frontend.chunk_generator(cfg, s, device)``, the
port's counterpart of ``fold_in(base_key, s)``. A 1-shard mesh gives
``run_frontend``'s result bit for bit; the descriptors stay on the device
in a ``DescriptorBank``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig
from ..models import frontend as frontend_mod
from .mesh import Mesh


def step_config(cfg: SlamConfig, mesh: Mesh) -> SlamConfig:
    """``cfg`` with the chunk widened to one step: ``chunk_frames`` frames
    per shard."""
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, chunk_frames=cfg.runtime.chunk_frames * mesh.size))


def frontend_training_step(mesh: Mesh, cfg: SlamConfig, calib,
                           with_carry: bool = False):
    """One frontend step on the mesh's device: fn(left (F, H, W),
    right (F, H, W), [carry,] generator) -> (per-frame dict, carry), F
    being ``chunk_frames * mesh.size`` (a shorter last step is zero-padded
    to it by the caller, as ``run_frames`` does)."""
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
                         calib, mesh: Mesh,
                         cfg: SlamConfig = SlamConfig()
                         ) -> frontend_mod.FrontendResult:
    """The whole-sequence frontend in steps of ``chunk_frames * mesh.size``
    frames on the mesh's device."""
    return frontend_mod.run_frames(
        frontend_mod.ArrayFrames(images_left, images_right), calib,
        step_config(cfg, mesh), mesh.device)
