"""The reductions to metrics, on canned records and a canned trace: the
rate over the whole window, the p90 over every sequence, the stage
metrics from the program's timings, the idle union, and the rooflines'
counts against ``chip_smoke.py``'s formulas."""

import math

import pytest
import torch

import chip_smoke
from harness import runner, spec, stats, trace
from harness.trace import DeviceEvent, Trace


def _ctx(cell="harris.loop80", records=(), tr=None):
    return runner.MetricContext(spec.load_cell(cell), list(records), tr)


RECORDS = [
    {"index": i % 4, "frames": 80, "wall_s": w, "windows": 16,
     "from_disk": False,
     "timings": {"frontend": 0.05 + 0.001 * i, "trackstore": 0.004,
                 "bundles": 0.112, "pose_graph": 0.01, "loop_closure": 0.07}}
    for i, w in enumerate([0.25, 0.26, 0.24, 0.31, 0.25, 0.27, 0.25, 0.29,
                           0.26, 0.25])]


def test_rate_and_p90():
    assert stats.rate(800, 2.5) == 320.0
    walls = [r["wall_s"] for r in RECORDS]
    # numpy's linear percentile, over all of them
    assert stats.percentile(walls, 90) == pytest.approx(
        float(torch.quantile(torch.tensor(walls, dtype=torch.float64), 0.9)))
    assert stats.percentile([1.0], 90) == 1.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_stage_metrics():
    ctx = _ctx(records=RECORDS)
    fe = sum(r["timings"]["frontend"] for r in RECORDS) / 800 * 1e3
    assert runner.load_metric("frontend_ms_per_frame").read(ctx) == \
        pytest.approx(fe)
    assert runner.load_metric("frontend_disk_ms_per_frame").read(ctx) is None
    assert runner.load_metric("trackstore_ms_per_frame").read(ctx) == \
        pytest.approx(0.004 / 80 * 1e3)
    assert runner.load_metric("bundles_ms_per_window").read(ctx) == \
        pytest.approx(112.0 / 16)
    assert runner.load_metric("loop_closure_ms_per_seq").read(ctx) == \
        pytest.approx(80.0)
    disk = [dict(r, from_disk=True) for r in RECORDS]
    # the disk route's reader (its cell is not in BENCHMARK.json yet)
    assert runner.load_metric("frontend_disk_ms_per_frame").read(
        _ctx(records=disk)) == pytest.approx(fe)
    assert runner.load_metric("frontend_ms_per_frame").read(
        _ctx(records=disk)) is None


def _trace(events, lo=0.0, hi=100.0, spans=()):
    return Trace([DeviceEvent(*e) for e in events], list(spans), lo, hi)


def test_idle_union_and_gaps():
    tr = _trace([("k1", 10, 30), ("k2", 20, 40), ("k3", 60, 70),
                 ("k4", 95, 120)],
                spans=[("stage:frontend", 0, 45), ("stage:bundles", 45, 80),
                       ("stage:loop_closure", 80, 100)])
    # union [10, 40) + [60, 70) + [95, 100) inside [0, 100)
    assert tr.busy_s() == pytest.approx(45e-6)
    ctx = _ctx(tr=tr)
    assert runner.load_metric("device_idle_pct").read(ctx) == \
        pytest.approx(55.0)
    gaps = trace.idle_gaps(tr)
    # [70, 95) begins in bundles, [40, 60) and [0, 10) in the frontend
    assert gaps == [["stage:bundles", pytest.approx(25e-6)],
                    ["stage:frontend", pytest.approx(20e-6)],
                    ["stage:frontend", pytest.approx(10e-6)]]
    top = trace.top_device_ops(tr, 2)
    assert [t[0] for t in top] == ["k4", "k1"]
    assert runner.load_metric("device_idle_pct").read(_ctx()) is None


def test_roofline_b1_against_chip_smoke():
    ctx = _ctx(tr=_trace([("void maps_kernel<true, true>(...)", 0, 800),
                          ("void maps_kernel<true, true>(...)", 900, 1700),
                          ("void maps_kernel<false, true>(...)", 0, 5)]))
    px = 64 * 376 * 1241
    ms, by = chip_smoke.bound(4 * px * 11,
                              chip_smoke.OPS_PER_PIXEL["detect_maps"] * px)
    assert by == "bytes"
    got = runner.load_metric("roofline_pct.b1_detect_maps").read(ctx)
    assert got == pytest.approx(100 * 2 * ms * 1e-3 / 1600e-6)
    assert runner.load_metric("roofline_pct.b1_detect_maps").read(
        _ctx(tr=_trace([]))) is None


def test_roofline_b5_against_chip_smoke():
    name = "void akaze_octave_kernel<6>(...)"
    ev = [(name, 100 * i, 100 * i + 50) for i in range(8)]  # 2 chunks
    ctx = _ctx("akaze.loop80", tr=_trace(ev, hi=1000))
    want = 0.0
    H, W = 376, 1241
    for _ in range(4):
        px = 64 * H * W
        want += chip_smoke.bound(4 * px * 4 + 4 * 64, chip_smoke.OPS_PER_PIXEL[
            "akaze_octave"] * px)[0] * 1e-3
        H, W = math.ceil(H / 2), math.ceil(W / 2)
    got = runner.load_metric("roofline_pct.b5_akaze_octave").read(ctx)
    assert got == pytest.approx(100 * 2 * want / 400e-6)
    # launches that are not whole chunks' octaves read nothing
    assert runner.load_metric("roofline_pct.b5_akaze_octave").read(
        _ctx("akaze.loop80", tr=_trace(ev[:7], hi=1000))) is None


def test_roofline_b6_against_chip_smoke():
    ev = [DeviceEvent("void cholesky_solve_kernel<256>(...)", 0, 90),
          DeviceEvent("void cholesky_solve_kernel<32>(...)", 100, 108)]
    tr = Trace(ev, [], 0, 200, seq_spans=[(0, 200)],
               sequences=[{"windows": 16}])
    want = (chip_smoke.b6_bound(torch.zeros(16, 144, 144),
                                torch.zeros(16, 144))[0]
            + chip_smoke.b6_bound(torch.zeros(1, 12, 12),
                                  torch.zeros(1, 12))[0]) * 1e-3
    got = runner.load_metric("roofline_pct.b6_cholesky_solve").read(
        _ctx(tr=tr))
    assert got == pytest.approx(100 * want / 98e-6)
    tr.seq_spans = [(50, 200)]  # the window launch outside every span
    assert runner.load_metric("roofline_pct.b6_cholesky_solve").read(
        _ctx(tr=tr)) is None


class _Ev:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int(self._d * 1e3)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_trace_leaves_out_annotations_mirrored_on_the_device():
    """The profiler mirrors the host's annotations, and each collective's
    own ``nccl:`` one, on the device timeline over the kernels they hold:
    they are not device work."""
    from types import SimpleNamespace

    evs = [_Ev(trace.SEQ_SPAN, 0, 100, False),
           _Ev(trace.SEQ_SPAN, 0, 100, True),
           _Ev("stage:bundles", 5, 50, True),
           _Ev("nccl:all_reduce", 10, 40, True),
           _Ev("ncclDevKernel_AllReduce_Sum_f64_RING_LL(x)", 12, 30, True),
           _Ev("void k(...)", 60, 10, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    tr = trace.from_profiler(prof)
    assert [e.name for e in tr.device] == [
        "ncclDevKernel_AllReduce_Sum_f64_RING_LL(x)", "void k(...)"]
    assert tr.busy_s() == pytest.approx(40e-6)
