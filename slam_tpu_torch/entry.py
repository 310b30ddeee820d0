"""The single-card check: one frontend chunk on a KITTI-shaped stereo batch.

Counterpart of ``__graft_entry__.entry``: ``entry()`` returns ``(step,
args)``, where ``step(left, right, generator)`` runs one chunk of the
frontend with no carry (detect and describe by kernel B1, stereo and
temporal matching by kernel B2, batched RANSAC and the pose chain;
``models.frontend.process_chunk``) and returns ``(T_rel (4, 4, 4) float32,
num_inliers (4,) int32)``, and ``args`` are its inputs: two 4 x 256 x 832
float32 images drawn by numpy from seeds 0 and 1, and a
``torch.Generator`` seeded 0 in place of the JAX package's
``PRNGKey(0)``. The configuration is ``SlamConfig`` with 1024 keypoints
and 256 RANSAC hypotheses. ``parallel/dryrun.py`` holds its sibling,
``dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import FeatureConfig, RansacConfig, SlamConfig
from .models import frontend
from .ops.cuda_kernels import resolve_device

CALIB = (718.856, 718.856, 607.19, 185.2, 0.5372)
SHAPE = (4, 256, 832)  # (frames, height, width): a reduced KITTI chunk
CFG = SlamConfig(features=FeatureConfig(max_kp=1024),
                 ransac=RansacConfig(num_hypotheses=256))


def entry(device="cuda"):
    """(step, (left, right, generator)) on ``device``: the card unless the
    caller names the CPU (raises without a card)."""
    dev = resolve_device(device)
    calib = torch.tensor(CALIB, dtype=torch.float32, device=dev)

    def step(left, right, generator):
        out, _ = frontend.process_chunk(left, right, None, calib, CFG,
                                        generator=generator)
        return out["T_rel"], out["num_inliers"]

    left, right = (torch.from_numpy(np.random.default_rng(seed).random(
        SHAPE, np.float32)).to(dev) for seed in (0, 1))
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    return step, (left, right, generator)
