"""The device mesh of the mesh-sharded modes, and padding to its size.

Counterpart of ``slam_tpu/parallel/mesh.py``. The JAX package maps its
frame, window and landmark axes onto a flat ``jax.sharding.Mesh``; each
device runs one shard. Here a ``Mesh`` is a tuple of shards, each naming
the ``torch.device`` it runs on, and one axis name. Several shards may
name the same device: they then run as one batch on it, the shard axis
becoming part of the batch axis, and the JAX package's ``psum`` over the
axis becomes a sum over it. That is how the port runs a mesh on one card,
and on the CPU in the tests (the JAX tests' 8 virtual CPU devices).

Shards on more than one distinct device raise ``NotImplementedError``:
the port targets one H100, and splitting a batch across cards (one
process group per mesh, a collective per LM iteration) is not ported.
``shard_leading`` and ``replicated`` have no counterpart: there is no
sharding annotation to make.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_kernels import resolve_device


def _canonical(device) -> torch.device:
    """``device`` with the card's index made explicit ("cuda" -> "cuda:0")
    so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


class Mesh:
    """A flat mesh: one ``torch.device`` per shard, and one axis name.
    ``size`` shards, ``shape`` {axis: size} as a JAX mesh reports it, and
    ``device``, the one device every shard runs on."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        distinct = sorted(set(map(str, self.devices)))
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over more than one device ({', '.join(distinct)}) "
                f"is not ported: the port runs every shard of a mesh on one "
                f"device, as one batch")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """A flat mesh of ``n_devices`` shards (one by default) on ``device``:
    the card unless the caller names the CPU (raises without a card)."""
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return Mesh([resolve_device(device)] * n, axis)


def stage_device(mesh: Mesh | None, device) -> torch.device:
    """The device a stage runs on: the mesh's when there is a mesh
    (``device`` must then be None or name the same device), else
    ``device``, the card when it is None."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and _canonical(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros to a multiple of ``multiple``; returns
    (array, the original length)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), n
