"""The one traffic generator: a mix's parameters -> the run's sequences.

A mix (``traffic/<name>.json``) holds:

  ``sequences_per_seed``  how many distinct sequences a run cycles through,
                          in order, in a closed loop (one caller, the next
                          sequence started when the last returned);
  ``scene``               ``scenes.make_scene``'s keywords: trajectory,
                          frames, landmarks, radii, corridor;
  ``input``               ``"memory"`` (uint8 host arrays) or ``"disk"``
                          (KITTI-layout PNG sequences, passed as path
                          lists).

Sequence i of a run with seed s is the scene of seed
``sequences_per_seed * s + i``: every seed gets the same trajectory,
frame count and landmark count, so seeds change the landmarks and not
the amount of work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import scenes


@dataclass
class Sequence:
    index: int
    scene_seed: int
    scene: scenes.Scene
    left: np.ndarray          # (F, H, W) uint8
    right: np.ndarray
    paths: tuple | None = None  # (left paths, right paths) on disk

    @property
    def frames(self) -> int:
        return int(self.left.shape[0])


def scene_seeds(traffic: dict, seed: int) -> list[int]:
    n = int(traffic["sequences_per_seed"])
    return [n * int(seed) + i for i in range(n)]


def make_sequences(traffic: dict, seed: int, device,
                   hw=scenes.KITTI_HW, calib=None) -> list[Sequence]:
    """The run's sequences, rendered on ``device`` to host uint8."""
    kw = dict(traffic["scene"])
    if "clover_radii" in kw:
        kw["clover_radii"] = tuple(kw["clover_radii"])
    out = []
    for i, s in enumerate(scene_seeds(traffic, seed)):
        sc = scenes.make_scene(s, hw=tuple(hw), calib=calib, **kw)
        left, right = scenes.render_u8(sc, device)
        out.append(Sequence(i, s, sc, left, right))
    return out
