"""Device time of one graphed pose-graph LM call (``ops.pose_graph.
optimize``, 15 iterations) and of one gate refresh (``gate_matrix``), by
device function, on the card.

For each dense node bucket (``tests/pg_system_check.py``: a 17-keyframe
loop at 64 nodes, a 68-keyframe one at 128, KITTI 00's 652 keyframes at
704) the two ops run three times (warm-up, capture, replay), then one
more replay between two marker kernels under torch.profiler
(``tests/card_checks.traced_window``). It prints and writes, per op and
bucket: the kernels launched and their device time, split into the LU
(cuSOLVER's and cuBLAS's getrf, getrs, laswp, trsm and the like) and the
rest, the launches per LM iteration and the largest device functions.

    python3 scripts/probe_pose_graph_lm.py [--root DIR] [--out FILE]

``--root`` runs another checkout's ``slam_tpu_torch`` (the parent's,
unpacked with ``git archive`` under the gitignored ``build/``) with this
checkout's graphs and trace helpers, so both sides of a change are
measured by one script in one call. One card, ~1 min a side.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
ITERS = 15
# the LU's device functions: cuSOLVER's factorization and its solves
LU_NAMES = re.compile(r"getr|laswp|trsm|ipiv|pivot|lu_|_lu|iamax|swap",
                      re.IGNORECASE)


def split(events) -> dict:
    """Launches and device ms of the events, all and the LU's, and the
    largest device functions."""
    by = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        name = e.name
        by[name][0] += 1
        by[name][1] += e.time_range.elapsed_us() / 1e3
    lu = {k: v for k, v in by.items() if LU_NAMES.search(k)}
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:8]
    return {"launches": sum(v[0] for v in by.values()),
            "device_ms": sum(v[1] for v in by.values()),
            "lu_launches": sum(v[0] for v in lu.values()),
            "lu_ms": sum(v[1] for v in lu.values()),
            "top": [(k[:90], n, round(ms, 4)) for k, (n, ms) in top],
            "all": {k[:120]: (n, round(ms, 4)) for k, (n, ms) in by.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--buckets", type=int, nargs="*", default=[64, 128, 704])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_pose_graph_lm: no CUDA device")
        return 1
    sys.path[:0] = [str(args.root.resolve()), str(REPO / "tests")]
    import pg_system_check as pgc
    from card_checks import traced_window

    from slam_tpu_torch.ops import pose_graph as pg
    from slam_tpu_torch.runtime import graphs

    card = torch.cuda.get_device_name(0)
    out = {"root": str(args.root), "card": card, "ops": {}}
    for bucket in args.buckets:
        g = pgc.bucket_graph(bucket, "cuda")
        dense, n_valid = g._dense_args()
        ii, jj = np.tril_indices(g.num_nodes, k=-1)
        pairs = [torch.as_tensor(p, device="cuda")
                 for p in g._padded_pairs(jj, ii)]
        calls = {
            "optimize": lambda: pg.optimize(*dense, iters=ITERS,
                                            n_valid=n_valid),
            "gate_matrix": lambda: pg.gate_matrix(*dense, *pairs,
                                                  n_valid=n_valid)}
        graphs.clear()
        for name, fn in calls.items():
            for _ in range(3):  # warm-up, capture, replay
                fn()
            torch.cuda.synchronize()
            _, dev = traced_window(fn, fn)
            rec = split(dev)
            if name == "optimize":
                rec["launches_per_iter"] = rec["launches"] / ITERS
            out["ops"][f"{name}@{bucket}"] = rec
            print(f"[{name} @ {bucket} nodes] {rec['launches']} launches, "
                  f"{rec['device_ms']:.3f} ms of device time, LU "
                  f"{rec['lu_launches']} launches {rec['lu_ms']:.3f} ms, "
                  f"the rest {rec['device_ms'] - rec['lu_ms']:.3f} ms "
                  f"({card}); top {rec['top']}", flush=True)
        graphs.clear()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
