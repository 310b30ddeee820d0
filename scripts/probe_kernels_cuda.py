"""Device-side probes of the port's kernels B6 and B2 on one CUDA card.

What ``chip_smoke.py``'s event times around the wrappers cannot separate:

  B6 (cholesky_solve) at the main path's shapes (64 | 16, 144, 144) and
     (1, 12, 12): the wrapper's time by events (median of 20, the host's
     path to the launch inside), the time per launch of 100 launches back
     to back (the host's time hidden behind the device's), and the
     kernel's own device time from a torch.profiler trace; then, from a
     copy of its source with clock64() marks after each of its eight
     barriers, the cycles of each phase in CTA 0 (load, diagonal blocks,
     panels, trailing updates, each substitution's triangles and rows).
  B2 (mutual_nearest) at the stereo shape (32, 2048, 2048, 128, the
     stereo window): the kernel's device time from a trace, and the event
     times of the C entry point (bf16 inputs, no casts) built from copies
     of its source with parts of the epilogue cut out: the column
     reduction, the row reduction, and both with the column atomics, which
     leaves the loads and the mma.sync main loop.

Run from the repository root on a machine with a card and nvcc:

    python3 scripts/probe_kernels_cuda.py [--out FILE.json]

Prints one line per measurement, with the card's name and power limit,
and writes them all to FILE.json (default build/probe_kernels.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from slam_tpu_torch.config import SlamConfig  # noqa: E402
from slam_tpu_torch.models import frontend  # noqa: E402
from slam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

CSRC = ROOT / "slam_tpu_torch" / "csrc"
OUT_DIR = ck.BUILD_DIR / "probe"
B6_PHASES = ("load", "diagonal blocks", "panels", "trailing updates",
             "forward triangles", "forward rows", "backward triangles",
             "backward rows")
B2_CUTS = {  # variant -> (text, replacement) pairs applied to the source
    "kernel": (),
    "no column reduction": (("if (dc < cbest[s]) {", "if (false) {"),),
    "no row reduction": (("if (dr < rbest[q]) {", "if (false) {"),),
    "main loop only": (
        ("if (dc < cbest[s]) {", "if (false) {"),
        ("if (dr < rbest[q]) {", "if (false) {"),
        ("atomicMin(colbest + (size_t)pair * Kb + c0 + tid, k);",
         "if (k == 0x1234ull) colbest[0] = k;")),
}


def instrumented_b6() -> str:
    """B6's source with thread 0 of CTA 0 adding the cycles since its last
    mark to prof[phase] after each barrier."""
    lines = (CSRC / "cholesky_solve.cu").read_text().split("\n")
    bars = [i for i, l in enumerate(lines) if l.strip() == "barrier<T>();"]
    assert len(bars) == len(B6_PHASES), bars
    out = []
    for i, l in enumerate(lines):
        out.append(l)
        if i in bars:
            out.append(
                "  if (blockIdx.x == 0 && threadIdx.x == 0) { long long c = "
                f"clock64(); prof[{bars.index(i)}] += c - t_last; "
                "t_last = c; }")
    src = "\n".join(out)
    start = "  const float* Sb = S + (size_t)blockIdx.x * n * n;"
    assert src.count(start) == 1 and src.count("namespace {\n") == 1
    src = src.replace(start, start + "\n  long long t_last = clock64();")
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long prof[8];\n")
    return src + (
        '\nextern "C" int slam_prof(long long* h) { return (int)'
        'cudaMemcpyFromSymbol(h, prof, sizeof(prof)); }\n'
        'extern "C" int slam_prof_reset() { long long z[8] = {0}; return '
        '(int)cudaMemcpyToSymbol(prof, z, sizeof(z)); }\n')


def b2_variant(cuts) -> str:
    src = (CSRC / "mutual_nearest.cu").read_text()
    for old, new in cuts:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def build_all(sources: dict) -> dict:
    """Compile each source into its own library, all nvcc at once; the
    loaded libraries by name."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, paths = ck._find_nvcc(), [], {}
    for k, (name, src) in enumerate(sources.items()):
        cu, so = OUT_DIR / f"probe{k}.cu", OUT_DIR / f"libprobe{k}.so"
        cu.write_text(src)
        cmds.append([nvcc, *ck.NVCC_FLAGS, "-shared", "-I", str(CSRC),
                     "-o", str(so), str(cu)])
        paths[name] = so
    ck._run_all(cmds)
    return {name: ctypes.CDLL(str(so)) for name, so in paths.items()}


def device_ms(fn, kernel: str, runs: int = cs.TIMING_RUNS) -> float:
    """Mean device time in ms of the kernels whose name holds ``kernel``,
    per call of fn(), from a torch.profiler trace of ``runs`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    assert len(us) == runs, (kernel, len(us))
    return sum(us) / runs / 1e3


def back_to_back_ms(fn, launches: int = 100) -> float:
    """Time per call of ``launches`` calls of fn() between two events."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "probe_kernels.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernels_cuda: no CUDA device")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ck.build()
    libs = build_all({"b6 phases": instrumented_b6(),
                      **{name: b2_variant(c) for name, c in B2_CUTS.items()}})
    rec = {"card": card, "b6": {}, "b2": {}}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream

    prof_lib = libs["b6 phases"]
    prof_lib.slam_cholesky_solve.argtypes = \
        ck.build().slam_cholesky_solve.argtypes
    for B, N in ((64, 144), (16, 144), (1, 12)):
        S, g = cs.spd_systems(gen, B, N)
        x = torch.empty_like(g)
        wrapper = lambda: ck.cholesky_solve(S, g)  # noqa: E731
        r = {"wrapper_event_ms": cs.median_ms(wrapper),
             "back_to_back_ms": back_to_back_ms(wrapper),
             "device_ms": device_ms(wrapper, "cholesky_solve_kernel")}

        def instrumented():
            assert prof_lib.slam_cholesky_solve(
                S.data_ptr(), g.data_ptr(), x.data_ptr(), B, N, 0, stream) == 0
        instrumented()
        torch.cuda.synchronize()
        assert prof_lib.slam_prof_reset() == 0
        for _ in range(cs.TIMING_RUNS):
            instrumented()
        torch.cuda.synchronize()
        cyc = (ctypes.c_longlong * 8)()
        assert prof_lib.slam_prof(cyc) == 0
        r["cycles_cta0"] = {p: cyc[k] / cs.TIMING_RUNS
                            for k, p in enumerate(B6_PHASES)}
        rec["b6"][f"({B}, {N}, {N})"] = r
        print(f"[B6] ({B}, {N}, {N}): {json.dumps(r)} ({card})", flush=True)

    inputs = cs.b2_inputs(gen, 32, 2048, 2048)
    win = frontend.search_windows(SlamConfig().matching)[0]
    a, b = (t.to(torch.bfloat16) for t in inputs[:2])
    va, vb, xa, xb = inputs[2:]
    B, Ka, D = a.shape
    Kb = b.shape[1]
    outs = (torch.empty((B, Kb), dtype=torch.int64, device="cuda"),
            torch.empty((B, Ka), device="cuda"),
            torch.empty((B, Ka), dtype=torch.int64, device="cuda"),
            torch.empty((B, Kb), device="cuda"),
            torch.empty((B, Kb), dtype=torch.int64, device="cuda"))
    rec["b2"]["window"] = list(win)
    rec["b2"]["device_ms"] = device_ms(
        lambda: ck.mutual_nearest(*inputs, window=win), "mutual_kernel")
    times = {name: [] for name in B2_CUTS}
    for turn in range(2):  # each variant twice, in turns
        for name in B2_CUTS:
            lib = libs[name]
            lib.slam_mutual_nearest.argtypes = \
                ck.build().slam_mutual_nearest.argtypes

            def raw():
                assert lib.slam_mutual_nearest(
                    a.data_ptr(), b.data_ptr(), va.data_ptr(), vb.data_ptr(),
                    xa.data_ptr(), xb.data_ptr(), B, Ka, Kb, D, 1, *win,
                    *(o.data_ptr() for o in outs), 0, stream) == 0
            times[name].append(cs.median_ms(raw))
    rec["b2"]["event_ms"] = times
    print(f"[B2] (32, 2048, 2048, 128) stereo window: {json.dumps(rec['b2'])} "
          f"({card})", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
