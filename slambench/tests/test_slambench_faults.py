"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives ``runner.run`` on the CPU (the look for a card skipped,
the program's plain versions in place of its kernels) at the tiny size
of ``conftest.TINY``, with one fault planted in the program, and holds
the cell's limits as they stand. The faults a cell of one card can have:
a step that returns its state unchanged (the window BA with no LM
iteration), half of the batch left out (half of the BA windows with
their weights zeroed), an answer altered where it is produced (every
frame-to-frame motion of the frontend 1 % longer; loop closure's answer
dropped). There is no exchange between chips to leave out.
"""

import numpy as np
import pytest
import torch

from harness import runner

SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(cell, tmp_path):
    return runner.run(cell, SEED, 0.01, False, device="cpu",
                      tmp_root=tmp_path)


def test_sound_run_is_correct(tiny_cell, tmp_path):
    res = _run(tiny_cell, tmp_path)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def _state_unchanged(monkeypatch):
    from slam_tpu_torch.models import bundle

    orig = bundle.window_step
    monkeypatch.setattr(bundle, "window_step",
                        lambda calib, device, iters=20, **kw: orig(
                            calib, device, iters=0, **kw))


def _half_batch(monkeypatch):
    from slam_tpu_torch.models import bundle

    orig = bundle.window_step

    def window_step(*a, **kw):
        step = orig(*a, **kw)

        def half(poses0, points0, cam_idx, lm_idx, meas, w, n_poses):
            w = np.array(w)
            w[len(w) // 2:] = 0.0
            return step(poses0, points0, cam_idx, lm_idx, meas, w, n_poses)
        return half
    monkeypatch.setattr(bundle, "window_step", window_step)


def _motions_altered(monkeypatch):
    from slam_tpu_torch.models import frontend

    orig = frontend.run_frontend

    def run_frontend(*a, **kw):
        fe = orig(*a, **kw)
        T = fe.T_w2c.astype(np.float64)
        rel = T[1:] @ np.linalg.inv(T[:-1])
        rel[:, :3, 3] *= 1.01
        for f in range(1, len(T)):
            T[f] = rel[f - 1] @ T[f - 1]
        fe.T_w2c = T.astype(np.float32)
        return fe
    monkeypatch.setattr(frontend, "run_frontend", run_frontend)


def _closure_dropped(monkeypatch):
    from slam_tpu_torch.models import loop_closure

    monkeypatch.setattr(loop_closure, "find_loops",
                        lambda *a, **kw: [])


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _motions_altered, _closure_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_reads_not_correct(plant, tiny_cell, tmp_path, monkeypatch):
    plant(monkeypatch)
    res = _run(tiny_cell, tmp_path)
    assert not res["correct"], res["compared"]
