"""run_pipeline of both packages under ORB + Hamming at 240x640, K = 1024: the
``orb`` configuration of ``tests/sift_orb_slice.py``, which holds the
scenes, the bounds and the tests' bodies; and loop verification at
K = 512 and at the SIFT configuration's 2500.
"""

import pytest

from tests.sift_orb_slice import slice_runs
from tests.sift_orb_slice import test_frontend_matches_agree  # noqa: F401
from tests.sift_orb_slice import test_closes_the_same_loops  # noqa: F401
from tests.sift_orb_slice import test_trajectories_agree  # noqa: F401
from tests.sift_orb_slice import test_loop_verification_matches_jax  # noqa


@pytest.fixture(scope="module")
def runs():
    return slice_runs("orb")

