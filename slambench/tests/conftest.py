"""The benchmark's own tests: run with ``python -m pytest slambench/tests``
from the checkout's root. They need no card; those marked ``cuda`` skip
without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)


import json  # noqa: E402

import pytest  # noqa: E402

# a loop small enough for the CPU that still closes once: 48 frames at
# 120 x 400 around a 10 m circle, 512 keypoints a frame, and loop closure's
# inlier floor lowered to what so few keypoints give
TINY = {"hw": [120, 400], "frames": 48, "landmarks": 3000, "radius": 10.0,
        "max_kp": 512, "min_inliers": 40}


def tiny(name: str = "harris.loop80", frames: int = TINY["frames"],
         ranks: int = 1):
    """Cell ``name`` cut to the CPU: one sequence of ``frames`` frames
    (``TINY``), its limits as they stand; with ``ranks`` > 1 its
    configuration spread over that many ranks (gloo ranks of the CPU)."""
    from harness import spec

    cell = spec.load_cell(name)
    H, W = TINY["hw"]
    sx, sy = W / 1241, H / 376
    settings = json.loads(json.dumps(cell.config["settings"]))
    settings["features"]["max_kp"] = TINY["max_kp"]
    settings["loop"]["min_inliers"] = TINY["min_inliers"]
    cell.config = dict(cell.config, settings=settings, geometry={
        "image_hw": [H, W],
        "calib": [718.856 * sx, 718.856 * sy, 607.1928 * sx, 185.2157 * sy,
                  0.5372]})
    if ranks > 1:
        cell.config["deployment"] = {"ranks": ranks, "backend": "nccl"}
    cell.traffic = {"sequences_per_seed": 1, "input": "memory",
                    "scene": {"trajectory": "loop",
                              "num_frames": frames,
                              "num_landmarks": TINY["landmarks"],
                              "loop_radius": TINY["radius"]}}
    return cell


@pytest.fixture
def tiny_cell():
    """harris.loop80's cell cut to the CPU: one sequence (``TINY``), its
    limits as they stand."""
    return tiny()
