"""What a span of ``slam_tpu_torch.utils.profiling`` costs the host.

Times ``N`` entries of a span nested two deep (``stage`` open around
them, as a stage's children are), on the active ``StageTimer`` through
``profiling.span``: with no profiler recording, under ``torch.profiler``
(host activity, and the card's when there is one), and with no active
timer (the no-op a direct call of a model meets). Prints one JSON line,
microseconds per entry, the median of ``--repeats`` rounds.

    python3 scripts/probe_span_cost.py [--entries 20000] [--repeats 5]

Host only; a few seconds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from slam_tpu_torch.utils import profiling  # noqa: E402


def per_entry_us(n: int, timer) -> float:
    """Microseconds per ``profiling.span`` entry, ``timer`` active (or
    none when it is None)."""
    ctx = timer.active() if timer is not None else profiling._NULL
    with ctx:
        outer = timer.span("stage") if timer is not None else profiling._NULL
        with outer:
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with profiling.span("child"):
                    pass
            dt = time.perf_counter_ns() - t0
    return dt / n / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--entries", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    n, reps = args.entries, args.repeats
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = {"entries": n, "repeats": reps}
    out["no_timer_us"] = statistics.median(
        per_entry_us(n, None) for _ in range(reps))
    out["no_profiler_us"] = statistics.median(
        per_entry_us(n, profiling.StageTimer()) for _ in range(reps))
    profiled = []
    for _ in range(reps):
        with profile(activities=acts):
            profiled.append(per_entry_us(n, profiling.StageTimer()))
    out["profiler_us"] = statistics.median(profiled)
    out["device"] = (torch.cuda.get_device_name(0)
                     if torch.cuda.is_available() else "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
