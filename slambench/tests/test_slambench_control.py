"""The control: the plain reference computed in TF32 (the precision
below the configuration's float32 with TF32 off), put in the program's
place, fails the cell's limits, at the tiny size of ``conftest.TINY``.
On the card the control turns the TF32 switches on (as ``calibrate.py``
does at the cells' size); on the CPU TF32 is emulated
(``harness/tf32.py``)."""

import numpy as np
import pytest
import torch

from harness import check, runner, tf32, traffic


def _sequence(cell, seed, device):
    runner.setup_env()
    geom = cell.config["geometry"]
    calib = np.asarray(geom["calib"], np.float32)
    seq = traffic.make_sequences(cell.traffic, seed, device,
                                 hw=tuple(geom["image_hw"]), calib=calib)[0]
    return seq, calib


def _judge(cell, side, ref):
    return check.judge(check.compare(side, ref), cell.limits)


@pytest.mark.parametrize("seed", [3, 2**32 + 9])
def test_tf32_control_fails(tiny_cell, seed):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    seq, calib = _sequence(tiny_cell, seed, "cpu")
    ref = runner.run_reference(tiny_cell, seq, calib, "cpu")
    with tf32.emulated():
        ctl = runner.run_reference(tiny_cell, seq, calib, "cpu")
    again = runner.run_reference(tiny_cell, seq, calib, "cpu")
    assert _judge(tiny_cell, again, ref)[0]
    correct, compared = _judge(tiny_cell, ctl, ref)
    assert not correct, compared


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_tf32_control_fails_on_card(tiny_cell, card):
    seq, calib = _sequence(tiny_cell, 5, card)
    ref = runner.run_reference(tiny_cell, seq, calib, card)
    ctl = runner.run_reference(tiny_cell, seq, calib, card, tf32=True)
    assert not torch.backends.cuda.matmul.allow_tf32
    correct, compared = _judge(tiny_cell, ctl, ref)
    assert not correct, compared
