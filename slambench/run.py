"""The benchmark of slam_tpu_torch: one run of one cell on the card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's result as one JSON object on the last line of standard
output, and the compared numbers beside their limits as the last lines
of standard error (``slambench/README.md``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the OpenMP, MKL and OpenBLAS pools (torch's
# intra-op pool among them): one process with few threads keeps the runs
# steady (PERF.md, section 2); set before anything imports them
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(t_start=T_START))
