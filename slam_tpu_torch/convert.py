"""Stage artifacts of the JAX package, as numpy arrays, to the port's.

This system has no weights: its state is the config (``SlamConfig``,
shared by both packages) and the stage artifacts. These functions take
the JAX package's stage outputs after they have become numpy (any object
with the right attribute names, or a mapping) and build the port's, so
both packages can be fed the same input at every stage boundary. They
never import JAX: a JAX ``DescriptorBank`` is read through its
``numpy()`` method.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from .models.bundle import BundleResult
from .models.frontend import DescriptorBank, FrontendResult
from .models.loop_closure import Closure
from .models.pose_graph import PoseGraph
from .models.trackstore import TrackStore
from .ops.cuda_kernels import resolve_device

_FRONTEND_ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev",
                    "match_dist", "inlier_prev", "T_rel", "T_w2c",
                    "num_inliers", "inlier_frac", "pose_ok")
_BUNDLE_ARRAYS = ("poses", "points", "w", "cost", "cost0", "num_obs",
                  "rel_T", "rel_cov", "T_w2c_keyframes", "n_poses", "frames",
                  "track_of_lm", "meas", "cam_idx", "lm_idx", "points0")


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def frontend_result(src, device="cuda") -> FrontendResult:
    """A port FrontendResult from the JAX package's frontend output; its
    descriptors (``desc``: a numpy array, or anything with ``numpy()``
    such as the JAX DescriptorBank) become a one-chunk DescriptorBank of
    float16 on ``device`` (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    desc = _get(src, "desc")
    desc = desc.numpy() if hasattr(desc, "numpy") else np.asarray(desc)
    arrays = {k: np.array(_get(src, k)) for k in _FRONTEND_ARRAYS}
    chunk = torch.as_tensor(desc.astype(np.float16), device=device)
    return FrontendResult(
        desc=DescriptorBank([(0, chunk.shape[0], chunk)], device=device),
        **arrays)


def bundle_result(src) -> BundleResult:
    """A port BundleResult from the JAX package's (host numpy arrays)."""
    arrays = {k: (None if _get(src, k) is None else np.array(_get(src, k)))
              for k in _BUNDLE_ARRAYS}
    return BundleResult(keyframes=[int(k) for k in _get(src, "keyframes")],
                        obs_dropped=int(_get(src, "obs_dropped")),
                        obs_total=int(_get(src, "obs_total")), **arrays)


def track_store(src) -> TrackStore:
    """A port TrackStore from the JAX package's (the same numpy fields)."""
    return TrackStore(**{f.name: _get(src, f.name)
                         for f in dataclasses.fields(TrackStore)})


def pipeline_result(src, device="cuda"):
    """A port PipelineResult from the JAX package's: every stage through
    the converters above, the two pose graphs through the npz format both
    packages share (written by the JAX graph's own ``save``, read by the
    port's ``PoseGraph.load`` onto ``device``), the closures field by
    field."""
    from .pipeline import PipelineResult

    device = resolve_device(device)
    graphs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, g in enumerate((_get(src, "pose_graph"),
                               _get(src, "pose_graph_pre_lc"))):
            path = Path(tmp) / f"graph{k}.npz"
            g.save(path)
            graphs.append(PoseGraph.load(path, device=device))
    closures = [Closure(**{f.name: _get(c, f.name)
                           for f in dataclasses.fields(Closure)})
                for c in _get(src, "closures")]
    calib = _get(src, "calib")
    return PipelineResult(
        frontend=frontend_result(_get(src, "frontend"), device=device),
        db=track_store(_get(src, "db")),
        bundles=bundle_result(_get(src, "bundles")),
        pose_graph=graphs[0], pose_graph_pre_lc=graphs[1], closures=closures,
        timings=dict(_get(src, "timings")),
        calib=None if calib is None else np.asarray(calib, np.float32))
