"""ThreadSanitizer gate for the port's native runtime.

Builds ``tsan_main.cpp`` (which includes ``native.cpp``) with
``g++ -fsanitize=thread`` (zlib, no libpng), runs it on a small set of
PNG files written here (11 frames, so the last chunk is partial, and one
file that is not a PNG), and fails on any ThreadSanitizer report or any
failed check of the test program. Needs g++ and a PNG writer (cv2 or PIL).

    python -m slam_tpu_torch.runtime.tsan      (exit 0: clean)
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FLAGS = ("-fsanitize=thread", "-O1", "-g", "-std=c++17")
F, H, W = 11, 32, 40


def write_fixtures(root: Path) -> None:
    from ..utils.kitti import _imwrite_gray

    rng = np.random.default_rng(0)
    for i in range(F):
        for side in "lr":
            _imwrite_gray(root / f"{side}{i:03d}.png",
                          rng.integers(0, 256, (H, W), dtype=np.uint8))
    (root / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n not a png")


def main() -> int:
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        write_fixtures(root)
        exe = root / "tsan_main"
        build = subprocess.run(
            ["g++", *FLAGS, str(HERE / "tsan_main.cpp"), "-o", str(exe),
             "-lz", "-pthread"], capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stdout + build.stderr, file=sys.stderr)
            print("TSAN: the test program did not build", file=sys.stderr)
            return 1
        run = subprocess.run(
            [str(exe), str(root), str(F), str(H), str(W)],
            capture_output=True, text=True, timeout=600,
            env={"TSAN_OPTIONS": "halt_on_error=0 exitcode=66"})
        print(run.stdout, end="")
        reports = run.stderr.count("WARNING: ThreadSanitizer")
        if run.returncode != 0 or reports:
            print(run.stderr[-4000:], file=sys.stderr)
            print(f"TSAN: {reports} report(s), exit {run.returncode}",
                  file=sys.stderr)
            return 1
        print("TSAN: clean (3 full streams checked against direct decodes, "
              "20 create/destroy, 5 mid-stream destroys, two consumers, a "
              "corrupt frame failing its chunk)")
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
