"""The reference of a cell over several ranks computes what the program's
mesh computes: each window that overflows BA's capacities re-solved at
its full size (``slamref`` ``resolve_overflow``), and nothing of that for
a cell of one card.

At the tiny size of ``conftest.TINY`` with BA's capacities cut
(``CAPS``) so that windows overflow: the reference of a one-card cell
equals ``slamref.run`` without the re-solve bit for bit; the reference of
a mesh cell re-solves, and lies near the program's mesh (one process, 4
shards on the CPU, its TP mega-bundle) where the reference without the
re-solve does not.
"""

import json

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import check, runner, traffic

SEED = 2**31 + 777
CAPS = {"max_landmarks": 96, "max_obs": 768}


def _capped(cell):
    settings = json.loads(json.dumps(cell.config["settings"]))
    settings["bundle"].update(CAPS)
    cell.config = dict(cell.config, settings=settings)
    return cell


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    one = _capped(tiny())
    mesh = _capped(tiny(ranks=4))
    runner.setup_env()
    geom = one.config["geometry"]
    calib = np.asarray(geom["calib"], np.float32)
    seq = traffic.make_sequences(one.traffic, SEED, "cpu",
                                 hw=tuple(geom["image_hw"]), calib=calib)[0]
    return one, mesh, seq, calib


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a) and set(a) == set(b)


def test_one_card_reference_is_unchanged(scene):
    import slamref

    one, _, seq, calib = scene
    st = {}
    got = runner.run_reference(one, seq, calib, "cpu", stats=st)
    assert st["overflowed_windows"] > 0  # so that the re-solve would show
    plain = slamref.run(seq.left, seq.right, calib,
                        runner.reference_config(one), "cpu")
    assert _same(got, plain)


def test_mesh_reference_resolves_overflowed_windows(scene):
    import slamref

    from slam_tpu_torch.parallel.mesh import make_mesh

    one, mesh, seq, calib = scene
    st = {}
    ref = runner.run_reference(mesh, seq, calib, "cpu", stats=st)
    assert st["overflowed_windows"] > 0
    plain = slamref.run(seq.left, seq.right, calib,
                        runner.reference_config(mesh), "cpu")
    assert not np.array_equal(ref["bundles"], plain["bundles"])
    # the program's mesh: every window in one batch over 4 shards, the
    # overflowed ones re-solved on its TP mega-bundle
    prog = check.digest(runner.Program(
        runner.program_config(mesh), calib, "cpu", False).pipeline
        .run_pipeline(seq.left, seq.right, calib, runner.program_config(mesh),
                      run_loop_closure=True, verbose=False,
                      mesh=make_mesh(4, device="cpu"), device="cpu"))
    near = check.compare(prog, ref)
    far = check.compare(prog, plain)
    assert near["keyframes_differ"] == 0
    assert near["bundles_gap_m"] <= mesh.limits["bundles_gap_m"], near
    assert near["bundles_gap_m"] < 0.1 * far["bundles_gap_m"], (near, far)
