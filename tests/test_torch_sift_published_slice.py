"""run_pipeline of both packages under SIFT at the benchmark's kitti00_sift settings (K = 2500, five octaves, contrast 0.04 / 3) at 160x320: the
``sift_published`` configuration of ``tests/sift_orb_slice.py``, which holds the
scenes, the bounds and the tests' bodies.
"""

import pytest

from tests.sift_orb_slice import slice_runs
from tests.sift_orb_slice import test_frontend_matches_agree  # noqa: F401
from tests.sift_orb_slice import test_closes_the_same_loops  # noqa: F401
from tests.sift_orb_slice import test_trajectories_agree  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return slice_runs("sift_published")
