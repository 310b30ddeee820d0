"""The device mesh of the mesh-sharded modes, its two collectives, and
padding to its size.

Counterpart of ``slam_tpu/parallel/mesh.py``. The JAX package maps its
frame, window and landmark axes onto a flat ``jax.sharding.Mesh``; each
device runs one shard. Here a ``Mesh`` is a tuple of shards and one axis
name, in one process or over the ranks of a ``torch.distributed`` process
group.

In one process, every shard names the one ``torch.device`` it runs on:
the shards then run as one batch on it, the shard axis becoming part of
the batch axis, and the JAX package's ``psum`` over the axis becomes a
sum over it. That is how the port runs a mesh on one card, and on the
CPU in the tests (the JAX tests' 8 virtual CPU devices). A process-local
mesh whose shards name two distinct devices raises ``NotImplementedError``.

Over ranks (one process per device, parallel/ranks.py starts them), a
mesh of ``size`` shards puts shard i on rank ``i // (size / W)``, W the
world size: each rank's ``devices`` are its own ``size / W`` shards, all
on its device, which again run as one batch. The JAX package's ``psum``
becomes :func:`all_sum` (the rank's local shards summed, then one
``all_reduce``) and its gathers :func:`host_gather` (numpy arrays in
shard order). Every module goes through these two; with W = 1 both are
the identity on the one-process path. ``shard_leading`` and
``replicated`` have no counterpart: there is no sharding annotation to
make.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cuda_kernels import resolve_device


def _ranked() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def _canonical(device) -> torch.device:
    """``device`` with the card's index made explicit, so that two names of
    one device compare equal: "cuda" is the current card (the rank's own,
    set from LOCAL_RANK by parallel.ranks.init_rank; card 0 otherwise)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() \
            else 0
        return torch.device("cuda", index)
    return device


class Mesh:
    """A flat mesh: ``size`` shards, one axis name, ``shape`` {axis: size}
    as a JAX mesh reports it. ``devices`` are this process's shards (one
    ``torch.device`` each, all the same: ``device``); with ``group`` (a
    process group of W ranks) the mesh spans every rank's shards, and this
    one holds shards ``rank * len(devices)`` onwards. ``ranks`` are the
    group's ranks in the default group, in order (by default asked of the
    group). A rank outside the group (the other stage group of
    parallel/stage_overlap.py) gets a mesh with ``rank`` -1 and the
    group's ``world`` and ``ranks`` as given, which it cannot ask of a
    group it is not a member of."""

    def __init__(self, devices, axis: str = "dp", group=None, ranks=None):
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        distinct = sorted(set(map(str, self.devices)))
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a process-local mesh over more than one device "
                f"({', '.join(distinct)}) is not ported: a process runs its "
                f"shards on one device, as one batch. To span several "
                f"devices, run one rank per device in a torch.distributed "
                f"process group and call make_mesh() in each (torchrun, or "
                f"parallel.ranks.spawn)")
        self.axis = axis
        self.group = group
        self.ranks = None
        self.world, self.rank = 1, 0
        if group is not None:
            self.ranks = tuple(ranks if ranks is not None
                               else dist.get_process_group_ranks(group))
            me = dist.get_rank()
            self.world = len(self.ranks)
            self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def member(self) -> bool:
        """Whether this process holds shards of the mesh."""
        return self.rank >= 0

    @property
    def local_size(self) -> int:
        """The shards this process holds."""
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local_size * self.world

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def local_shards(self) -> slice:
        """This rank's shards along the mesh axis."""
        lo = self.rank * self.local_size
        return slice(lo, lo + self.local_size)

    def with_axis(self, axis: str) -> "Mesh":
        """The same shards under another axis name."""
        return Mesh(self.devices, axis, self.group, self.ranks)


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """A flat mesh on ``device``: the card unless the caller names the CPU
    (raises without a card). Inside an initialized process group, one
    shard per rank on the rank's device (``n_devices`` must then be None
    or the world size); otherwise ``n_devices`` shards (one by default) on
    one device."""
    if _ranked():
        world = dist.get_world_size()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(
                f"inside a process group of {world} ranks a mesh has one "
                f"shard per rank: n_devices must be None or {world}, got "
                f"{n_devices}")
        return Mesh([resolve_device(device)], axis, dist.group.WORLD)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return Mesh([resolve_device(device)] * n, axis)


def stage_device(mesh: Mesh | None, device) -> torch.device:
    """The device a stage runs on: the mesh's (this rank's) when there is a
    mesh (``device`` must then be None or name the same device), else
    ``device``, the card when it is None."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and _canonical(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def all_sum(mesh: Mesh, *tensors: torch.Tensor):
    """The JAX package's ``psum``: each tensor summed over its leading axis
    (this rank's shards) with the axis kept at length 1, then summed over
    the ranks by one ``all_reduce`` of all of them together, in their own
    dtype (which they must share). Returns one tensor or a tuple, as
    given. Every rank gets the same bits, so ranks that decide on a sum
    decide alike."""
    local = [t.sum(0, keepdim=True) for t in tensors]
    if mesh.world > 1:
        dtypes = {t.dtype for t in local}
        if len(dtypes) > 1:
            raise ValueError(f"all_sum: one dtype per call, got {dtypes}")
        flat = torch.cat([t.reshape(-1) for t in local])
        dist.all_reduce(flat, group=mesh.group)
        parts = flat.split([t.numel() for t in local])
        local = [p.view(t.shape) for p, t in zip(parts, local)]
    return local[0] if len(local) == 1 else tuple(local)


def host_gather(mesh: Mesh, value):
    """Every rank's ``value`` on every rank, in shard order: a numpy array
    (or a dict, tuple or list of them) whose leading axis is this rank's
    part comes back with the ranks' parts concatenated along it, in the
    same structure. With one rank, ``value`` itself."""
    if mesh.world == 1:
        return value
    parts = [None] * mesh.world
    dist.all_gather_object(parts, value, group=mesh.group)

    def cat(arrs):
        return np.concatenate([np.asarray(a) for a in arrs])

    if isinstance(value, dict):
        return {k: cat([p[k] for p in parts]) for k in value}
    if isinstance(value, (tuple, list)):
        return type(value)(cat([p[i] for p in parts])
                           for i in range(len(value)))
    return cat(parts)


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
