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

import numpy as np
import torch

from .models.bundle import BundleResult
from .models.frontend import DescriptorBank, FrontendResult
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
