"""The ThreadSanitizer gate of the port's native runtime
(``python -m slam_tpu_torch.runtime.tsan``): built with g++
-fsanitize=thread and run on its PNG fixtures, it must report no race and
pass every check of its test program (full streams equal to direct decodes,
create/destroy, destroy mid-stream, two consumers, a corrupt frame that
fails its chunk)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def test_tsan_gate_is_clean():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the gate cannot be built")
    out = subprocess.run([sys.executable, "-m", "slam_tpu_torch.runtime.tsan"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "TSAN: clean" in out.stdout
    assert "corrupt frame failed chunk 1 of 3" in out.stdout
