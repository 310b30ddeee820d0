"""The benchmark's ``kitti00_sift`` configuration (the reference project's
active front end: SIFT, 2500 features, L2 matching) on the port, against
the benchmark's plain reference, ``slambench/reference/slamref``, on the
CPU.

The configuration file is the one the benchmark's cell ``sift.loop80``
runs; here its settings run at small image sizes, with the frames
rendered from a seed: detection and description of one stereo pair
under the Hamming norm, a 24-frame loop through ``run_pipeline`` held to
the cell's limits, and K = 2500, which is not a multiple of 128, through
the per-octave budgets and loop verification. The same settings are held
against the JAX package in test_torch_sift.py (detection) and
test_torch_sift_orb_slice.py (the loop, and verification at K = 2500);
B2 at K = 2500 on the card in test_torch_kernels.py.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_tpu_torch import pipeline
from slam_tpu_torch.config import KeyframeConfig, SlamConfig
from slam_tpu_torch.models import frontend, loop_closure
from slam_tpu_torch.ops import features
from slam_tpu_torch.utils import synthetic
from tests.test_torch_graphs import verify_inputs
from tests.test_torch_sift import check_paired

BENCH = Path(__file__).resolve().parents[1] / "slambench"
for _p in (str(BENCH), str(BENCH / "reference")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import slamref  # noqa: E402
from harness import check  # noqa: E402
from slamref import config as ref_config  # noqa: E402
from slamref.models import frontend as ref_frontend  # noqa: E402
from slamref.models import loop_closure as ref_loop_closure  # noqa: E402

torch.set_num_threads(2)

CONFIG = json.loads((BENCH / "configs" / "kitti00_sift.json").read_text())
HARRIS = json.loads((BENCH / "configs" / "kitti00_harris.json").read_text())
LIMITS = json.loads((BENCH / "limits" / "sift.loop80.json").read_text())
K = 2500


def both_configs(settings: dict):
    """The settings as the port's SlamConfig and as the reference's."""
    blob = json.dumps(settings)
    return SlamConfig.from_json(blob), ref_config.SlamConfig.from_json(blob)


def test_the_configuration_loads_on_both_sides():
    """kitti00_sift's settings load into the port's SlamConfig and the
    reference's with equal values: kitti00_harris's with the detector,
    K, the contrast gate and the octaves changed (cv2's SIFT_create(2500)
    under L2), and nothing else."""
    prog, ref = both_configs(CONFIG["settings"])
    assert prog.to_json() == ref.to_json()
    fc = prog.features
    assert (fc.detector, fc.max_kp, fc.num_levels) == ("sift", K, 4)
    assert fc.sift_contrast == pytest.approx(0.04 / 3, rel=1e-15)
    mc = prog.matching
    assert (mc.norm, mc.stereo_dy, mc.stereo_min_disp) == ("l2", 2.0, 2.0)
    changed = {(g, k) for g, grp in CONFIG["settings"].items()
               if isinstance(grp, dict) for k, v in grp.items()
               if HARRIS["settings"][g][k] != v}
    assert changed == {("features", "detector"), ("features", "max_kp"),
                       ("features", "sift_contrast"),
                       ("features", "num_levels")}
    assert CONFIG["geometry"] == HARRIS["geometry"]
    assert list(CONFIG["reduced"]) == ["sequence_frames"]
    # five octaves, from the x2-upsampled one down
    assert frontend.detector_levels(fc) == 5


def rendered_pair(hw=(96, 320), seed=5):
    """One rendered stereo pair, uint8 (2, H, W)."""
    sc = synthetic.make_scene(seed=seed, num_frames=1, num_landmarks=2000,
                              trajectory="straight", hw=hw)
    L, R = synthetic.render_sequence(sc)
    return torch.from_numpy(np.concatenate([L, R]))


def test_detect_describe_under_hamming_matches_the_reference():
    """The frontend's detection and description under kitti00_sift's
    settings with the Hamming norm, the binarized branch at K = 2500,
    port against the reference on a rendered 96x320 pair (check_paired's
    tolerances). The L2 branch at these settings is held against the
    JAX package (test_torch_sift.py's ``published`` case)."""
    settings = json.loads(json.dumps(CONFIG["settings"]))
    settings["matching"]["norm"] = "hamming"
    prog, ref = both_configs(settings)
    imgs = rendered_pair()
    out_p = frontend._detect_describe(imgs, prog)
    out_r = ref_frontend._detect_describe(imgs, ref)
    assert out_p["xy"].shape == (2, K, 2)
    check_paired(out_p, {k: v.numpy() for k, v in out_r.items()})


# a loop small enough for the CPU that closes once (test_torch_spans.py's
# scene); the detector, its octaves and contrast and the matching are
# kitti00_sift's, K cut to 1024 for the CPU's time (K = 2500 has tests of
# its own, below and against the JAX package), the BA, keyframe and loop settings cut to 24 frames
FRAMES, HW, CHUNK, SMALL_K = 24, (128, 256), 8, 1024


def small_loop_config(settings: dict) -> dict:
    s = json.loads(json.dumps(settings))
    s["features"]["max_kp"] = SMALL_K
    s["runtime"]["chunk_frames"] = CHUNK
    s["keyframes"].update(dataclasses.asdict(KeyframeConfig(
        min_gap=2, max_gap=6, max_dist_m=6.0, max_angle_deg=25.0)))
    s["bundle"].update(max_poses=8, max_landmarks=256, max_obs=1024,
                       lm_iters=10)
    s["loop"].update(mahalanobis_thresh=300.0, min_inliers=40,
                     keyframe_gap=5, max_candidates=8)
    return s


def test_small_loop_through_run_pipeline_within_the_cell_limits():
    """24 frames of a rendered loop through run_pipeline under
    kitti00_sift's detector, held against the reference's run of
    the same images by the comparison that decides the cell's
    ``correct``, at the cell's limits; both close the loop, and the
    keypoint counts cover the five octaves."""
    sc = synthetic.make_scene(seed=3, num_frames=FRAMES, num_landmarks=2500,
                              trajectory="loop", hw=HW, loop_radius=6.0)
    L, R = synthetic.render_sequence(sc)
    prog, ref = both_configs(small_loop_config(CONFIG["settings"]))
    res = pipeline.run_pipeline(L, R, sc.calib, prog, verbose=False,
                                device="cpu")
    want = slamref.run(L, R, sc.calib, ref, "cpu")
    got = check.digest(res)
    correct, compared = check.judge(check.compare(got, want), LIMITS)
    assert correct, compared
    assert got["closures"] and got["closures"] == want["closures"]
    kp = res.counts["keypoints"]
    assert kp["left_images"] == FRAMES and len(kp["per_level"]) == 5
    assert sum(kp["per_level"]) == int(res.frontend.valid.sum())
    assert kp["per_level"][0] > 0


def test_budgets_of_k_2500():
    """K = 2500 splits over the five octaves as the JAX package's rule
    does (full resolution half of what is left, in multiples of 128, the
    rest to the first): every slot has an octave."""
    b = features.level_budgets(K, 5)
    assert b == [1220, 640, 256, 128, 256] and sum(b) == K
    fc = SlamConfig.from_json(json.dumps(CONFIG["settings"])).features
    assert frontend.keypoint_counts(np.ones((3, K), bool), fc) == {
        "left_images": 3, "per_level": [3 * n for n in b]}


def test_loop_verification_at_k_2500():
    """Loop verification's match and RANSAC of four keyframe pairs at
    (4, 2500, 128) float16 equal the reference's bit for bit, and the
    query's slots copied from the candidate's match back to themselves."""
    args = verify_inputs(P=4, K=K, H=32)
    got = loop_closure._verify_candidates(*args)
    want = ref_loop_closure._verify_candidates(*args)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert got["match_tgt"].shape == (4, K)
    half = torch.arange(K // 2)
    valid = args[1][:, :K // 2]
    assert bool((got["match_tgt"][:, :K // 2] == half)[valid].all())
