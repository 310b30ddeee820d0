"""The port's device mesh (parallel/mesh.py): shards, axis and device, the
one-device rule, padding, and the stage groups of the overlap mode,
against the JAX package's mesh helpers on its 8-device CPU mesh."""

import numpy as np
import pytest
import torch

from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import stage_overlap as jstage
from slam_tpu_torch.parallel import mesh
from slam_tpu_torch.parallel.stage_overlap import split_mesh

torch.set_num_threads(2)


@pytest.mark.parametrize("n, axis", [(None, "dp"), (8, "dp"), (4, "tp")])
def test_make_mesh_matches_jax_shape(n, axis):
    """make_mesh(n, axis) has n shards (one by default; the JAX package's
    default is every device) and the JAX mesh's shape dict."""
    m = mesh.make_mesh(n, axis, device="cpu")
    ref = jmesh.make_mesh(n if n is not None else 1, axis)
    assert m.size == (n or 1) == ref.devices.size
    assert dict(m.shape) == dict(ref.shape)
    assert m.devices == (torch.device("cpu"),) * m.size
    assert m.device == torch.device("cpu")


def test_make_mesh_needs_the_card(monkeypatch):
    """Like every entry point, make_mesh takes the card unless asked for the
    CPU, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.make_mesh()
    with pytest.raises(ValueError, match=">= 1"):
        mesh.make_mesh(0, device="cpu")


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"], ["cuda:0", "cuda:1"],
                                     ["cuda", "cuda:1"]])
def test_two_distinct_devices_raise(devices):
    """A mesh over more than one distinct device is not ported: it raises
    NotImplementedError naming the devices; two names of one device
    ("cuda", "cuda:0") are one device."""
    with pytest.raises(NotImplementedError, match="more than one device"):
        mesh.Mesh(devices)
    assert mesh.Mesh(["cuda", "cuda:0"]).device == torch.device("cuda", 0)


def test_stage_device():
    """With a mesh, a stage runs on the mesh's device; a different device
    raises; without one, the given device (the card when None)."""
    m = mesh.make_mesh(2, device="cpu")
    assert mesh.stage_device(m, None) == torch.device("cpu")
    assert mesh.stage_device(m, "cpu") == torch.device("cpu")
    assert mesh.stage_device(None, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        mesh.stage_device(m, "cuda:0")


@pytest.mark.parametrize("shape, multiple", [((13, 4, 3), 8), ((16, 2), 8),
                                             ((5,), 1), ((3, 7), 4)])
def test_pad_to_multiple_equals_jax(shape, multiple):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ours, n = mesh.pad_to_multiple(x, multiple)
    ref, n_ref = jmesh.pad_to_multiple(x, multiple)
    assert n == n_ref == shape[0]
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n, fe", [(8, None), (8, 3), (8, 8), (2, None),
                                   (1, None)])
def test_split_mesh_like_jax(n, fe):
    """split_mesh gives the JAX package's group sizes (its groups are
    disjoint devices, the port's disjoint shards of one device); a 1-shard
    mesh is both groups."""
    f, b = split_mesh(mesh.make_mesh(n, device="cpu"), fe)
    jf, jb = jstage.split_mesh(jmesh.make_mesh(n), fe)
    assert (f.size, b.size) == (jf.devices.size, jb.devices.size)
    assert f.device == b.device == torch.device("cpu")
    if n > 1:
        assert f.size + b.size == n
