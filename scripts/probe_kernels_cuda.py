"""Device-side probes of the port's kernels B6, B2, B1 and B5 on one CUDA
card.

What ``chip_smoke.py``'s event times around the wrappers cannot separate:

  B6 (cholesky_solve) at the main path's shapes (64 | 16, 144, 144) and
     (1, 12, 12): the wrapper's time by events (median of 20, the host's
     path to the launch inside), the time per launch of 100 launches back
     to back (the host's time hidden behind the device's), and the
     kernel's own device time from a torch.profiler trace; then, from a
     copy of its source with clock64() marks after each of its ten
     barriers, the cycles of each phase in CTA 0 (load, diagonal blocks,
     panels, trailing updates, each substitution's triangles and rows,
     both passes summed, and the refinement's copy and residual).
  B2 (mutual_nearest) at the stereo shape (32, 2048, 2048, 128, the
     stereo window): the kernel's device time from a trace, and the event
     times of the C entry point (bf16 inputs, no casts) built from copies
     of its source with parts of the epilogue cut out: the column
     reduction, the row reduction, and both with the column atomics, which
     leaves the loads and the mma.sync main loop.
  B1 (detect_maps) and B5 (akaze_octave, 6 steps) at the frontend's shape
     (64, 376, 1241), on rendered frames and on the AKAZE path's blurred
     frames with their contrasts: the wrapper's time by events, and, from
     copies of the sources under --csrc called at their C entry points,
     the kernel's device time from a trace and the cycles one thread of
     one CTA (block (1, 1, 0), or (1, 0, 0) of a grid one block high)
     spends up to each __syncthreads() of the source, from clock64()
     marks after every barrier, each named by its line and its comment.
     B1 has one barrier per row: its four marks are the four iterations
     of a turn, summed over the chunk. Its stages overlap in one
     iteration, so copies of its source with parts cut out are timed at
     the C entry point as well (no global stores, no reads of the other
     threads' cells, only the global stores, no row sums, no atan2, 4
     and 16 warps a block, taller chunks), and its stores are set beside
     a fill of its 10 output planes and a width whose rows begin on
     sectors.
     B1's phases alone are B4 (harris_response) and B3
     (orientation_maps), timed the same way.

Run from the repository root on a machine with a card and nvcc:

    python3 scripts/probe_kernels_cuda.py [--out FILE.json]
        [--kernels b6,b2,b1,b5] [--csrc DIR]

--csrc names another directory of kernel sources (an older checkout's
slam_tpu_torch/csrc) for the B1 and B5 copies, to set two designs side by
side on one card in one run; B6 and B2 are always this checkout's.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from slam_tpu_torch.config import SlamConfig  # noqa: E402
from slam_tpu_torch.models import frontend  # noqa: E402
from slam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

CSRC = ROOT / "slam_tpu_torch" / "csrc"
OUT_DIR = ck.BUILD_DIR / "probe"
# B6's barriers in source order: the substitutions' four (a function
# called twice, so each sums the first solve's pass and the refinement's),
# then the kernel body's
B6_PHASES = ("forward triangles", "forward rows", "backward triangles",
             "backward rows", "load", "diagonal blocks", "panels",
             "trailing updates", "refinement copy", "refinement residual")
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
    src = src.replace(start, start + "\n  if (blockIdx.x == 0 && threadIdx.x"
                      " == 0) t_last = clock64();")
    k = len(B6_PHASES)
    src = src.replace("namespace {\n", f"namespace {{\n__device__ long long "
                      f"prof[{k}];\n__device__ long long t_last;\n")
    return src + (
        '\nextern "C" int slam_prof(long long* h) { return (int)'
        'cudaMemcpyFromSymbol(h, prof, sizeof(prof)); }\n'
        f'extern "C" int slam_prof_reset() {{ long long z[{k}] = {{0}}; '
        'return (int)cudaMemcpyToSymbol(prof, z, sizeof(z)); }\n')


PROF_SLOTS = 32
PROF_DECL = f"""
__device__ long long prof[{PROF_SLOTS}];
__shared__ long long prof_last;
#define PROF_HERE (blockIdx.x == 1 && blockIdx.y == (gridDim.y > 1) && \\
                   blockIdx.z == 0 && threadIdx.x == 0)
#define PROF_START do {{ if (PROF_HERE) prof_last = clock64(); }} while (0)
#define PROF_MARK(k) do {{ if (PROF_HERE) {{ long long c_ = clock64(); \\
    prof[k] += c_ - prof_last; prof_last = c_; }} }} while (0)
"""
PROF_ENTRY = f"""
extern "C" int slam_prof(long long* h) {{ return (int)
    cudaMemcpyFromSymbol(h, prof, sizeof(prof)); }}
extern "C" int slam_prof_reset() {{ long long z[{PROF_SLOTS}] = {{0}}; return
    (int)cudaMemcpyToSymbol(prof, z, sizeof(z)); }}
"""


def with_barrier_marks(src: str):
    """(source, labels): ``src`` with a clock64() mark after each
    __syncthreads() and before the closing brace of each __global__
    function, adding the cycles since the last mark to prof[k] in one
    thread of one CTA. Label k is the barrier's line and its trailing
    comment or the nearest comment line above it; the last is "end"."""
    lines = src.split("\n")
    out, labels, comment, in_kernel = [], [], "", None
    for n, line in enumerate(lines, 1):
        text = line.strip()
        if text.startswith("//"):
            comment = text.lstrip("/ ")
        if text.startswith("__syncthreads();"):
            tail = text.partition("//")[2].strip()
            out.append(line)
            out.append(f"PROF_MARK({len(labels)});")
            labels.append(f"L{n} {(tail or comment)[:48]}")
            continue
        if "__global__" in line:
            in_kernel = "signature"
        if in_kernel == "body" and line == "}":
            out.append(f"PROF_MARK({PROF_SLOTS - 1});")
            in_kernel = None
        out.append(line)
        if in_kernel == "signature" and text.endswith("{"):
            out.append("PROF_START;")
            in_kernel = "body"
    assert len(labels) < PROF_SLOTS, labels
    src = "\n".join(out)
    assert src.count("namespace {\n") == 1 and "PROF_START" in src
    src = src.replace("namespace {\n", "namespace {\n" + PROF_DECL)
    return src + PROF_ENTRY, labels + ["end"]


NO_STORES = (("    const bool emit = stores && j >= 0 && j < nrows;",
              "    const bool emit = stores && j >= 0 && j < nrows && "
              "n0 == 1.2345e38f;"),)
OWN_VALUES = (  # every read of a neighbour's cell becomes the thread's own
    ("    const float* rd = lines + Q2 * (NL * LINE) + PAD + q;",
     "    const float* rd = lines + Q2 * (NL * LINE) + PAD + q;\n"
     "    const float own = lines[Q2 * (NL * LINE) + PAD + q] * 3.f;"),
    *((f"{name}[{d}]", "own") for name in ("rd", "ga", "gb", "ra", "ba", "ca")
      for d in ("-2", "-1", "1", "2") if (name, d) not in
      (("ba", "-2"), ("ba", "2"), ("ca", "-2"))))
B1_CUTS = {  # B1's stages overlap: parts of it cut out, one at a time
    "kernel": (),
    "no global stores": NO_STORES,
    "no reads of the neighbours' cells": OWN_VALUES,
    "neither": (*NO_STORES, *OWN_VALUES),
    "only the global stores": (  # every output is the image row's value
        ("    if constexpr (HARRIS) {\n      // gradients of row yi-2",
         "    res_c = cur;\n    res_n = cur + 1.f;\n#pragma unroll\n"
         "    for (int ch = 0; ch < 8; ++ch) box[ch] = cur + (float)ch;\n"
         "    if constexpr (false) {\n      // gradients of row yi-2"),
        ("    if constexpr (ORIENT) {\n      // row blur of image row yi-1",
         "    if constexpr (false) {\n      // row blur of image row yi-1")),
    "no row sums": (
        ("        box[ch] = ((ca[-1] + pcs[ch]) + ca[1]) + ca[2];",
         "        box[ch] = pcs[ch];"),),
    "no atan2": (
        ("(atan2_poly(gy, gx) + kPi) * kBinsPerRad",
         "(gy + gx + kPi) * kBinsPerRad"),),
    "4 warps a block": (
        ("constexpr int WARPS = 8;", "constexpr int WARPS = 4;"),
        ("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 4)")),
    "16 warps a block": (  # 53.7 KB of lines for B1: the limit is raised
        ("constexpr int WARPS = 8;", "constexpr int WARPS = 16;"),
        ("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)"),
        ("  // the blocks the card runs at once, asked once per device",
         "  static slam::SmemOnce smem_once;\n"
         "  if (smem_once(maps_kernel<HARRIS, ORIENT>, device, smem) != "
         "cudaSuccess)\n    return 1;")),
    "chunks of at least 96 rows": (
        ("constexpr int MIN_ROWS = 32; ", "constexpr int MIN_ROWS = 96; "),),
}


def cut_variant(name: str, cuts, csrc: Path = CSRC) -> str:
    """The source csrc/name with each (text, replacement) pair applied."""
    src = (csrc / name).read_text()
    for old, new in cuts:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def b2_variant(cuts) -> str:
    return cut_variant("mutual_nearest.cu", cuts)


def build_all(sources: dict, include: Path = CSRC) -> dict:
    """Compile each source into its own library, all nvcc at once; the
    loaded libraries by name."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, paths = ck._find_nvcc(), [], {}
    for name, src in sources.items():
        stem = "probe_" + "".join(c if c.isalnum() else "_" for c in name)
        cu, so = OUT_DIR / f"{stem}.cu", OUT_DIR / f"lib{stem}.so"
        cu.write_text(src)
        cmds.append([nvcc, *ck.NVCC_FLAGS, "-shared", "-I", str(include),
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
    # a trace now and then loses launches, more of them late in a long
    # process: the mean of those kept, from the first of three traces that
    # keeps at least half
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) >= runs // 2:
            break
    assert 0 < len(us) <= runs, (kernel, len(us))
    return sum(us) / len(us) / 1e3


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


def probe_b6(rec, card, gen, stream) -> None:
    prof_lib = build_all({"b6 phases": instrumented_b6()})["b6 phases"]
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
        cyc = (ctypes.c_longlong * len(B6_PHASES))()
        assert prof_lib.slam_prof(cyc) == 0
        r["cycles_cta0"] = {p: cyc[k] / cs.TIMING_RUNS
                            for k, p in enumerate(B6_PHASES)}
        rec["b6"][f"({B}, {N}, {N})"] = r
        print(f"[B6] ({B}, {N}, {N}): {json.dumps(r)} ({card})", flush=True)


def probe_b2(rec, card, gen, stream) -> None:
    libs = build_all({name: b2_variant(c) for name, c in B2_CUTS.items()})
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


def probe_images(rec, card, stream, csrc: Path) -> None:
    """B1 (with its phases alone, B4 and B3) and B5 at the frontend's
    shape: the wrapper by events (this checkout's kernels), and device time
    by trace and cycles per barrier from copies of the sources in ``csrc``."""
    from slam_tpu_torch.ops import akaze, features
    from slam_tpu_torch.utils import synthetic

    chunk = SlamConfig().runtime.chunk_frames
    scene = synthetic.make_scene(seed=cs.SEED, num_frames=chunk,
                                 num_landmarks=8000, trajectory="loop",
                                 hw=cs.HW)
    imgs = torch.from_numpy(np.concatenate(
        synthetic.render_sequence(scene))).cuda()
    F, H, W = imgs.shape
    k = akaze._contrast_k(imgs)
    oct0 = features.gaussian_blur(imgs, 1.0, 2)
    th, to = ck._taps(1.5), ck._taps(1.0)
    outs = [torch.empty_like(imgs) for _ in range(3)]
    maps = torch.empty((F, 8, H, W), device="cuda")
    o = [t.data_ptr() for t in outs]
    # name -> (source file, kernel name in a trace, wrapper, call of a
    # library's C entry point on the same tensors)
    calls = {
        "b1": ("detect_maps.cu", "maps_kernel",
               lambda: ck.detect_maps(imgs),
               lambda lib: lib.slam_detect_maps(
                   imgs.data_ptr(), o[0], o[1], maps.data_ptr(), F, H, W,
                   0.05, th, to, 0, stream)),
        "b4": ("detect_maps.cu", "maps_kernel",
               lambda: ck.harris_response(imgs),
               lambda lib: lib.slam_harris_response(
                   imgs.data_ptr(), o[0], o[1], F, H, W, 0.05, th, 0,
                   stream)),
        "b3": ("detect_maps.cu", "maps_kernel",
               lambda: ck.orientation_maps(oct0),
               lambda lib: lib.slam_orientation_maps(
                   oct0.data_ptr(), maps.data_ptr(), F, H, W, to, 0, stream)),
        "b5": ("akaze_octave.cu", "akaze_octave_kernel",
               lambda: ck.akaze_octave(oct0, k, 6),
               lambda lib: lib.slam_akaze_octave(
                   oct0.data_ptr(), k.data_ptr(), o[0], o[1], o[2], F, H, W,
                   6, 0.2, 1.6 ** 4, 0, stream)),
    }
    files = sorted({c[0] for c in calls.values()})
    marked = {f: with_barrier_marks((csrc / f).read_text()) for f in files}
    libs = build_all({**{f: (csrc / f).read_text() for f in files},
                      **{f + " marks": marked[f][0] for f in files}}, csrc)
    own = ck.build()
    for lib in libs.values():
        for fn in ("slam_detect_maps", "slam_harris_response",
                   "slam_orientation_maps", "slam_akaze_octave"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(own, fn).argtypes
    for name, (f, kernel, wrapper, raw) in calls.items():
        plain, prof_lib = libs[f], libs[f + " marks"]

        def launch(lib=plain):
            assert raw(lib) == 0
        r = {"wrapper_event_ms": cs.median_ms(wrapper),
             "csrc": str(csrc), "entry_event_ms": cs.median_ms(launch),
             "device_ms": device_ms(launch, kernel)}
        launch(prof_lib)
        torch.cuda.synchronize()
        assert prof_lib.slam_prof_reset() == 0
        for _ in range(cs.TIMING_RUNS):
            launch(prof_lib)
        torch.cuda.synchronize()
        cyc = (ctypes.c_longlong * PROF_SLOTS)()
        assert prof_lib.slam_prof(cyc) == 0
        labels = marked[f][1]
        r["cycles_one_cta"] = {
            label: cyc[PROF_SLOTS - 1 if label == "end" else i]
            / cs.TIMING_RUNS for i, label in enumerate(labels)}
        rec[name] = r
        print(f"[{name.upper()}] ({F}, {H}, {W}): {json.dumps(r)} ({card})",
              flush=True)
    if csrc != CSRC:
        return  # the cuts below are written for this checkout's B1
    cut_libs = build_all({"b1 " + n: cut_variant("detect_maps.cu", c)
                          for n, c in B1_CUTS.items()})
    times = {k: {n: [] for n in B1_CUTS} for k in ("b1", "b4", "b3")}
    for turn in range(2):  # each variant twice, in turns
        for n in B1_CUTS:
            lib = cut_libs["b1 " + n]
            for fn in ("slam_detect_maps", "slam_harris_response",
                       "slam_orientation_maps"):
                getattr(lib, fn).argtypes = getattr(own, fn).argtypes
            for name in times:
                raw = calls[name][3]

                def launch():
                    assert raw(lib) == 0
                times[name][n].append(cs.median_ms(launch))
    rec["b1_cuts_event_ms"] = times
    print(f"[B1] cut variants, event ms at the C entry point, B1, B4, B3: "
          f"{json.dumps(times)} ({card})", flush=True)
    # what B1's stores could cost: a fill of its 10 output planes, and the
    # kernel and its stores alone at a width whose rows begin on 32-byte
    # sectors (1248) beside the frontend's (1241), on random images
    planes = torch.empty((F, 10, H, W), device="cuda")
    floor = {"fill_10_planes_ms": cs.median_ms(lambda: planes.fill_(1.0))}
    del planes
    for width in (W, 1248):
        x = torch.rand((F, H, width), device="cuda")
        r, n = torch.empty_like(x), torch.empty_like(x)
        m = torch.empty((F, 8, H, width), device="cuda")
        for name in ("kernel", "only the global stores"):
            lib = cut_libs["b1 " + name]

            def launch():
                assert lib.slam_detect_maps(
                    x.data_ptr(), r.data_ptr(), n.data_ptr(), m.data_ptr(),
                    F, H, width, 0.05, th, to, 0, stream) == 0
            floor[f"{name}, width {width}"] = cs.median_ms(launch)
    rec["b1_store_floor_event_ms"] = floor
    print(f"[B1] stores: {json.dumps(floor)} ({card})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "probe_kernels.json"))
    ap.add_argument("--kernels", default="b6,b2,b1,b5",
                    help="which probes to run (b1 and b5 run together)")
    ap.add_argument("--csrc", default=str(CSRC),
                    help="directory of the B1 and B5 sources to probe")
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
    which = set(args.kernels.split(","))
    rec = {"card": card, "b6": {}, "b2": {}}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    if "b6" in which:
        probe_b6(rec, card, gen, stream)
    if "b2" in which:
        probe_b2(rec, card, gen, stream)
    if which & {"b1", "b5"}:
        probe_images(rec, card, stream, Path(args.csrc).resolve())
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
