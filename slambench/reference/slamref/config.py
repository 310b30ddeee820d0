"""Framework configuration.

The port's own copy of ``slam_tpu/config.py``: the same dataclasses,
fields, defaults and JSON form, so a config file saved by either package
loads in the other. It leaves out ``enable_compile_cache`` (a JAX
setting).

Replaces the reference's hard-coded per-machine constants module
(final_project/arguments.py:1-25 — absolute dataset paths switched on a
MAC/MICHAEL/ELYASHIV flag) and the thresholds scattered at point of use
(ransac.py:9, loop_closure.py:15-20, bundle.py:233-239) with one immutable,
serializable dataclass tree. Every stage takes an explicit config — no
module-level globals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class FeatureConfig:
    max_kp: int = 2048          # feature budget (ref: SIFT nfeatures=2500)
    grid_cell: int = 16         # gridded top-K cell size (px)
    border: int = 12            # detection border margin (px)
    min_response: float = 1e-7  # Harris response floor
    num_levels: int = 1         # pyramid octaves (ref AKAZE: 4 octaves)
    # "harris" | "akaze" (nonlinear scale space) | "orb" (FAST-9 + steered
    # BRIEF bits; pairs naturally with matching.norm="hamming") | "sift"
    # (DoG scale-space extrema — the reference's active detector family,
    # matching.py:27-35,72)
    detector: str = "harris"
    akaze_threshold: float = 8e-4  # ref matching.py:20
    fast_threshold: float = 0.06   # FAST ring contrast gate, unit-scale images
    sift_contrast: float = 0.015   # DoG contrast gate, unit-scale images


@dataclass(frozen=True)
class MatchConfig:
    stereo_dy: float = 2.0        # |y_l - y_r| gate (ref matching.py:62)
    stereo_min_disp: float = 2.0  # x_l > x_r + margin (ref matching.py:63)
    max_desc_dist: float = 0.6    # descriptor distance cutoff (sq-L2, unit
    # norm): without it, weak mutual matches occasionally outnumber true
    # correspondences and RANSAC locks onto junk (measured: 200x ATE blowup)
    # descriptor norm: "l2" (float descriptors) or "hamming" (binarized
    # MLDB-style bits matched as NORM_HAMMING via ops/binary.py — the
    # reference's headline AKAZE matcher, matching.py:21)
    norm: str = "l2"
    max_hamming: float = 40.0     # bit-distance cutoff when norm="hamming"
    # guided-matching search windows (slam_tpu addition; the reference
    # brute-forces full descriptor sets, matching.py:21-34)
    guided: bool = True
    max_disparity: float = 192.0  # stereo window: dx in [-max_disp, -min_disp]
    stereo_match_dy: float = 4.0  # window dy (looser than the final gate)
    temporal_dx: float = 300.0    # ego-motion window for frame-to-frame
    temporal_dy: float = 120.0


@dataclass(frozen=True)
class RansacConfig:
    # Fixed batched hypothesis budget. The reference's adaptive worst case
    # at its success probability 1-1e-10 and assumed 45% outliers is ~240
    # iterations of 4-point EPnP (ransac.py:59-67, ex3.py:16-19); our
    # minimal set is 3 (stereo 3D-3D triads), for which 256 hypotheses give
    # p(no all-inlier sample) = (1-0.55^3)^256 ~= 6e-21 — ten orders of
    # magnitude stronger than the reference guarantee at half the round-1
    # budget (hypothesis generation + scoring are ~0.45 ms/frame at 512).
    num_hypotheses: int = 256
    threshold_px: float = 2.0   # reprojection agreement gate (ref ransac.py:44-54)
    # GN refinement iterations per pass (two passes with a re-gate between
    # them, ransac.ransac_pnp). GN on the stereo reprojection problem
    # converges to machine identity by iteration 2 from hypothesis-quality
    # inits (measured at 30% outliers / 0.4 px noise); 3 keeps a margin.
    # Extra iterations are no-ops behind the accept gate but cost ~0.05
    # ms/frame each on chip.
    refine_iters: int = 3
    min_inliers: int = 10       # pair considered tracked if >= this


@dataclass(frozen=True)
class KeyframeConfig:
    # reference bundle.py:233-239 criteria
    min_gap: int = 5
    max_gap: int = 21
    max_dist_m: float = 8.0
    min_track_survival: float = 0.2
    max_angle_deg: float = 12.0


@dataclass(frozen=True)
class BundleConfig:
    max_poses: int = 24         # window size cap (ref max gap 21 + endpoints)
    max_landmarks: int = 512    # padded landmark slots per window
    max_obs: int = 4096         # padded (track, frame) stereo factors per window
    lm_iters: int = 20          # LM outer iterations
    meas_sigma_px: float = 1.0  # stereo factor sigma
    prior_sigma: float = 1e-3   # gauge prior on first pose
    min_depth: float = 0.1      # landmark pruning (ref z<0)
    max_depth: float = 1000.0   # landmark pruning (ref z>1000, bundle.py:184)
    huber_delta_px: float = 0.0  # >0 enables IRLS Huber robust factors
    # (slam_tpu addition; the reference uses pure Gaussian factors)
    # route windows that overflow (max_landmarks, max_obs) to the
    # landmark-sharded TP mega-bundle when a mesh is present, solving
    # them at FULL observation count (parallel/tp_megabundle.py; the
    # reference's dynamic factor graphs never drop factors,
    # bundle.py:129-169)
    tp_overflow: bool = True


@dataclass(frozen=True)
class LoopConfig:
    # reference loop_closure.py:15-20. The reference's FAR far-skip factor
    # (x7, :16,:221) is intentionally absent: it subsamples the sequential
    # per-pair Dijkstra scan when everything is far (and is a no-op bug in
    # the reference — `c_i_index += 2` inside a `for` loop); the batched
    # all-pairs Mahalanobis sweep prices every pair in one matmul, so there
    # is no scan to skip.
    mahalanobis_thresh: float = 220.0
    min_inliers: int = 120
    max_candidates: int = 15
    keyframe_gap: int = 10


@dataclass(frozen=True)
class RuntimeConfig:
    chunk_frames: int = 32      # frames per device batch in the frontend
    desc_dtype: str = "bfloat16"
    # The JAX package's persistent XLA compilation cache directory. The
    # port accepts it and does not use it (it compiles no XLA programs;
    # its CUDA kernels are built once into build/slam_tpu_torch/): the
    # field stays so that both packages read and write the same JSON.
    compile_cache_dir: str = "~/.cache/slam_tpu_xla"


@dataclass(frozen=True)
class SlamConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    matching: MatchConfig = field(default_factory=MatchConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    bundle: BundleConfig = field(default_factory=BundleConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "SlamConfig":
        raw = json.loads(text)
        sub = {
            "features": FeatureConfig,
            "matching": MatchConfig,
            "ransac": RansacConfig,
            "keyframes": KeyframeConfig,
            "bundle": BundleConfig,
            "loop": LoopConfig,
            "runtime": RuntimeConfig,
        }
        kwargs = {}
        for k, v in raw.items():
            kwargs[k] = sub[k](**v) if k in sub and isinstance(v, dict) else v
        return SlamConfig(**kwargs)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: str | Path) -> "SlamConfig":
        return SlamConfig.from_json(Path(path).read_text())


DEFAULT_CONFIG = SlamConfig()
