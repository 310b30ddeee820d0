"""The port's spans (``slam_tpu_torch.utils.profiling``): ``StageTimer``,
``span`` on the active timer, and the spans ``run_pipeline`` records
below its stages.

One small rendered loop (24 frames at 128x256, one closure) runs through
``run_pipeline`` on the CPU twice: once with a stub graph put in at
``runtime.graphs.GRAPH`` (so the graphed functions warm up, capture and
replay on CPU tensors) and ``record_function`` counted, and once under
``torch.profiler``. No JAX.
"""

import contextvars
import json
import threading

import numpy as np
import pytest
import torch

from slam_tpu_torch import pipeline
from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                   KeyframeConfig, LoopConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.ops import cuda_kernels
from slam_tpu_torch.runtime import graphs
from slam_tpu_torch.utils import profiling, synthetic
from tests.test_torch_graphs import StubGraph

torch.set_num_threads(2)

CHUNK = 8
FRAMES = 24
CFG = SlamConfig(
    features=FeatureConfig(max_kp=512, border=8),
    ransac=RansacConfig(num_hypotheses=192),
    runtime=RuntimeConfig(chunk_frames=CHUNK),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=6.0,
                             max_angle_deg=25.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=256, max_obs=1024,
                        lm_iters=10),
    loop=LoopConfig(mahalanobis_thresh=300.0, min_inliers=40,
                    keyframe_gap=5, max_candidates=8),
)
STAGES = {"frontend", "trackstore", "bundles", "pose_graph", "loop_closure"}
# the children every run on the CPU records (the events' waits are the
# card's, and a CPU run blocks on none)
DEVICE_SPANS = {"frontend.device:features", "frontend.device:motion"}
CHILDREN = DEVICE_SPANS | {
            "frontend.setup", "frontend.fill", "frontend.dispatch",
            "frontend.take_in", "frontend.assemble", "bundles.build",
            "bundles.upload",
            "bundles.take_in", "pose_graph.build", "pose_graph.optimize",
            "loop_closure.gate", "loop_closure.gate.wait",
            "loop_closure.verify", "loop_closure.verify.wait",
            "loop_closure.refine", "loop_closure.refine.wait",
            "loop_closure.optimize", "loop_closure.optimize.wait"}


def parent(key: str):
    return key.rsplit(".", 1)[0] if "." in key else None


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(seed=3, num_frames=FRAMES, num_landmarks=2500,
                              trajectory="loop", hw=(128, 256),
                              loop_radius=6.0)
    L, R = synthetic.render_sequence(sc)
    return L, R, sc.calib


@pytest.fixture(scope="module")
def stub_run(scene):
    """run_pipeline through the stub graph, record_function counted, and
    graphs.totals() around the call."""
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    graphs.clear()
    cuda_kernels.reset_counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "GRAPH", StubGraph)
        mp.setattr(torch.profiler, "record_function", counted)
        before = graphs.totals()
        res = pipeline.run_pipeline(*scene, CFG, verbose=False, device="cpu")
        after = graphs.totals()
    graphs.clear()
    cuda_kernels.reset_counters()
    return res, opened, {k: after[k] - before[k] for k in after}


@pytest.fixture(scope="module")
def profiled_run(scene):
    """run_pipeline under torch.profiler (CPU activity): the result and
    the (name, start_us, end_us) of its ``stage:`` annotations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pipeline.run_pipeline(*scene, CFG, verbose=False, device="cpu")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name.startswith(profiling.STAGE)]
    return res, spans


def test_stage_keys_children_and_seconds(stub_run):
    """The same top-level keys as the stages, the named children, every
    graphed call as a graph: span; each child's seconds at most its
    parent's, and the direct children's sum too, of the spans the host's
    clock timed (a device: span runs beside them)."""
    res, _, _ = stub_run
    t = res.timings
    assert {k for k in t if "." not in k} == STAGES
    assert CHILDREN <= set(t)
    assert "bundles.graph:solve_windows" in t
    assert "loop_closure.gate.graph:gate_matrix" in t
    assert "frontend.dispatch.graph:_chunk" in t
    assert set(res.counts["spans"]) == set(t)
    for k, v in t.items():
        assert v >= 0, k
        if parent(k) is not None:
            assert v <= t[parent(k)], k
    for k in t:
        kids = [v for c, v in t.items()
                if parent(c) == k and not profiling.is_device_key(c)]
        assert sum(kids) <= t[k] + 1e-9, k


def test_counts_match_the_run(stub_run):
    """frontend.fill once a chunk, loop_closure.gate once and once more a
    closure, the pose-graph stage's optimize once, loop closure's once a
    closure; every stage entered once."""
    res, _, _ = stub_run
    n = res.counts["spans"]
    closures = len(res.closures)
    assert closures >= 1
    assert n["frontend.fill"] == n["frontend.dispatch"] == -(-FRAMES // CHUNK)
    assert n["loop_closure.gate"] == 1 + closures
    assert n["loop_closure.refine"] == closures
    assert n["loop_closure.optimize"] == closures
    assert n["pose_graph.optimize"] == 1
    assert all(n[s] == 1 for s in STAGES)


def test_device_clock_spans_once_a_chunk(stub_run):
    """The frontend chunk's two device-clock spans (its stamps: on the
    CPU the host's clock inside the body) once a chunk each, not
    negative, neither a host key; the keypoint counts sum the frames'
    valid slots."""
    res, _, _ = stub_run
    n, t = res.counts["spans"], res.timings
    chunks = -(-FRAMES // CHUNK)
    for k in DEVICE_SPANS:
        assert n[k] == chunks, k
        assert t[k] >= 0.0, k
        assert profiling.is_device_key(k)
    kp = res.counts["keypoints"]
    assert kp == {"left_images": FRAMES,
                  "per_level": [int(res.frontend.valid.sum())]}


def test_counts_carry_the_graph_deltas(stub_run):
    """PipelineResult.counts["graphs"] is the call's change of
    graphs.totals(); its warm-ups and captures are the spans' warmup and
    capture entries, and every call to a graph is a graph: span."""
    res, _, delta = stub_run
    g = res.counts["graphs"]
    assert g == delta
    assert g["warmups"] > 0 and g["captures"] > 0
    n = res.counts["spans"]

    def entries(pred):
        return sum(v for k, v in n.items() if pred(k.rsplit(".", 1)[-1]))

    assert entries(lambda s: s == "warmup") == g["warmups"]
    assert entries(lambda s: s == "capture") == g["captures"]
    # a call warms up, or replays (after its capture, on the second)
    assert entries(lambda s: s.startswith("graph:")) == (
        g["warmups"] + g["replays"])


def test_no_profiler_no_annotation(stub_run):
    """With no profiler recording, no span opens a record_function."""
    _, opened, _ = stub_run
    assert opened == []


def test_profiler_sees_every_key_nested(profiled_run):
    """Under torch.profiler every key the host's clock timed is a
    stage:<key> annotation, as many times as its entries, and each
    child's lies inside one of its parent's; a device: span is none."""
    res, spans = profiled_run
    names = [s[0] for s in spans]
    host = {k for k in res.timings if not profiling.is_device_key(k)}
    assert host < set(res.timings)
    assert {n[len(profiling.STAGE):] for n in names} == host
    for k, c in res.counts["spans"].items():
        assert names.count(profiling.STAGE + k) == (
            c if k in host else 0), k
    for name, a, b in spans:
        p = parent(name[len(profiling.STAGE):])
        if p is None:
            continue
        assert any(n == profiling.STAGE + p and pa <= a and b <= pb
                   for n, pa, pb in spans), name


def test_span_without_an_active_timer_is_a_no_op():
    """profiling.span outside run_pipeline records nothing anywhere; on an
    active timer it nests under the open span, but inside unrecorded();
    the timer is inactive again after its block."""
    other = profiling.StageTimer()
    with profiling.span("a"), profiling.span("b"):
        pass
    assert other.ns == {} and other.counts == {}
    timer = profiling.StageTimer()
    with timer.active():
        with timer.span("stage"), profiling.span("child"):
            with profiling.span("wait"):
                pass
        with profiling.span("child"):
            pass
        with profiling.unrecorded(), profiling.span("hidden"):
            pass
    with profiling.span("after"):
        pass
    assert timer.counts == {"stage": 1, "stage.child": 1,
                            "stage.child.wait": 1, "child": 1}
    assert set(timer.report()) == set(timer.counts)
    assert timer.seconds("missing") == 0.0


def test_add_records_another_clock_s_time_under_the_open_span():
    """profiling.add outside run_pipeline records nothing; on an active
    timer it sums nanoseconds and entries under the spans open, opens no
    record_function, and leaves the open span's own time to the host."""
    profiling.add("x", 5)
    timer = profiling.StageTimer()
    with timer.active():
        with timer.span("stage"):
            profiling.add("x", 2_000_000_000)
            profiling.add("x", 1_000_000_000)
        profiling.add("y", 7)
    assert timer.counts == {"stage": 1, "stage.device:x": 2, "device:y": 1}
    assert timer.ns["stage.device:x"] == 3_000_000_000
    assert timer.seconds("stage") < 1.0
    assert timer.report()["device:y"] == pytest.approx(7e-9)
    assert [profiling.is_device_key(k) for k in timer.counts] == [
        False, True, True]


def test_span_records_when_the_block_raises():
    timer = profiling.StageTimer()
    with pytest.raises(ValueError), timer.active(), timer.span("stage"):
        with profiling.span("child"):
            raise ValueError("inside")
    assert timer.counts == {"stage": 1, "stage.child": 1}
    with profiling.span("after"):
        pass
    assert "after" not in timer.counts


def test_spans_of_another_thread_are_not_recorded():
    """A thread started inside the active block has no active timer; one
    started with the caller's context copied would share the timer,
    which the port never does."""
    timer = profiling.StageTimer()
    seen = []

    def work():
        seen.append(profiling._ACTIVE.get())
        with profiling.span("worker"):
            pass

    with timer.active(), timer.span("stage"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert seen == [None] and timer.counts == {"stage": 1}
    assert contextvars.copy_context().get(profiling._ACTIVE) is None


def test_stage_timer_save(tmp_path):
    timer = profiling.StageTimer()
    with timer.span("a"), timer.span("b"):
        pass
    timer.save(tmp_path / "t.json")
    rep = json.loads((tmp_path / "t.json").read_text())
    assert set(rep) == {"a", "a.b"} and np.isfinite(list(rep.values())).all()
