"""``slam_tpu_torch.runtime.graphs``, the port's counterpart of ``jax.jit``.

On the CPU every graphed function runs its body eagerly. The graph
policy itself (the key, warm-up then capture then replay, the static
buffers, the clones, the launch counts, ``eager()``, the cache bound) is
held here with a stub graph put in at the module's factory seam
(``graphs.GRAPH``): its capture runs the body once and keeps its outputs
as the "static" ones, and its replay runs the body again on the static
inputs and writes the results into those same output tensors, as a CUDA
graph's replay does. The ``cuda``-marked tests hold the real graphs
against eager runs on the card, and skip here.

The module imports no JAX: the card tests run it where JAX is absent.
"""

import ast
import collections
import functools
import importlib
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

from slam_tpu_torch.config import (FeatureConfig, RansacConfig, SlamConfig,
                                   RuntimeConfig)
from slam_tpu_torch.models import bundle, frontend, loop_closure
from slam_tpu_torch.models.pose_graph import PoseGraph
from slam_tpu_torch.ops import ba, cuda_kernels, ransac, se3, stereo
from slam_tpu_torch.ops import pose_graph as pg_ops
from slam_tpu_torch.runtime import graphs
from slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)
CFG = SlamConfig(features=FeatureConfig(max_kp=64),
                 ransac=RansacConfig(num_hypotheses=16),
                 runtime=RuntimeConfig(chunk_frames=4))


class StubPool:
    """A function's shared pool: counts the waits and fences that order
    its graphs' replays."""

    def __init__(self, device):
        self.device = device
        self.waits = self.fences = 0

    def wait(self):
        self.waits += 1

    def fence(self):
        self.fences += 1

    def drain(self):
        pass


class StubGraph:
    """A CUDA graph's contract on the CPU: capture runs the body (its
    Python counts as the capture's, which graphs takes back), replay
    reruns it on the static inputs without counting and writes into the
    static outputs in place."""

    Pool = StubPool
    made: list = []

    @staticmethod
    def supports(device):
        return device.type == "cpu"

    def __init__(self, pool):
        self.pool = pool
        self.replays = 0
        self.released = False
        StubGraph.made.append(self)

    def capture(self, body):
        self.body = body
        self.counters = list(graphs.COUNTERS)
        self.out = body()
        return self.out

    def replay(self):
        saved = [dict(c) for c in self.counters]
        graphs._STATE.depth += 1  # nested graphed calls: part of the graph
        try:
            new = self.body()
        finally:
            graphs._STATE.depth -= 1
        for c, b in zip(self.counters, saved):
            c.clear()
            c.update(b)
        dst, src = [], []
        graphs._flatten(self.out, dst, "stub", out=True)
        graphs._flatten(new, src, "stub", out=True)
        for d, s in zip(dst, src):
            d.copy_(s)
        self.replays += 1

    def release(self):
        self.released = True


@pytest.fixture
def stub(monkeypatch):
    StubGraph.made = []
    graphs.clear()
    cuda_kernels.reset_counters()
    monkeypatch.setattr(graphs, "GRAPH", StubGraph)
    yield StubGraph
    graphs.clear()
    cuda_kernels.reset_counters()


def toy(x, y=None, k: int = 1):
    """A body that launches "two B6 kernels" (counted as the wrapper
    counts them) and returns a tuple, a dict and a constant."""
    cuda_kernels.LAUNCHES["cholesky_solve"] += 2
    out = x * k + (0 if y is None else y)
    return out, {"sum": out.sum(), "neg": -out}, 7


# ---------------------------------------------------------------------------
# (b) key and policy, stats, eager(), the cache bound
# ---------------------------------------------------------------------------

def test_cpu_runs_eagerly_without_a_graph():
    """Without the stub, CPU tensors never reach a graph: the body's
    result, and nothing counted."""
    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    out = f(x, k=3)
    assert torch.equal(out[0], x * 3)
    assert f.stats() == {"warmups": 0, "captures": 0, "replays": 0,
                         "keys": 0, "evictions": 0, "pool_bytes": 0}


def test_warmup_then_capture_then_replay(stub):
    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    f(x, k=2)
    assert (f.warmups, f.captures, f.replays) == (1, 0, 0)
    assert not stub.made
    f(x, k=2)
    assert (f.warmups, f.captures, f.replays) == (1, 1, 1)
    f(x + 1, k=2)
    assert (f.warmups, f.captures, f.replays) == (1, 1, 2)
    assert len(stub.made) == 1 and stub.made[0].replays == 2
    st = graphs.stats()[f.name]
    assert st["keys"] == 1 and st["replays"] == 2
    assert f.name.endswith(".toy")


def test_graph_calls_are_spans_warmup_then_capture_then_neither(stub):
    """Under an active timer each call that reaches a graph is a span
    ``graph:<function name>`` under the open one: the first call holds a
    ``warmup`` span, the second a ``capture`` span, the third neither. A
    call under eager() and a graphed call inside a body open none."""
    f = graphs.graphed(toy, static=("k",))
    inner = graphs.graphed(lambda x: x * 2)
    outer = graphs.graphed(lambda x: inner(x) + 1)
    x = torch.arange(4.0)
    timer = profiling.StageTimer()
    seen = []
    with timer.active(), timer.span("stage"):
        for _ in range(3):
            f(x, k=2)
            seen.append(dict(timer.counts))
        with graphs.eager():
            f(x, k=2)
        for _ in range(3):
            outer(x)
    key = "stage.graph:toy"
    assert [c[key] for c in seen] == [1, 2, 3]
    assert [c.get(f"{key}.warmup", 0) for c in seen] == [1, 1, 1]
    assert [c.get(f"{key}.capture", 0) for c in seen] == [0, 1, 1]
    lam = "stage.graph:<lambda>"
    assert timer.counts == {"stage": 1, key: 3, f"{key}.warmup": 1,
                            f"{key}.capture": 1, lam: 3, f"{lam}.warmup": 1,
                            f"{lam}.capture": 1}
    assert timer.ns[f"{key}.warmup"] + timer.ns[f"{key}.capture"] <= \
        timer.ns[key] <= timer.ns["stage"]
    assert (f.warmups, f.captures, f.replays) == (1, 1, 2)


@pytest.mark.parametrize("change", ["shape", "dtype", "static", "none_arg"])
def test_the_key(stub, change):
    """A new shape, dtype, static value or argument structure is a new
    key (its own warm-up); the same call again is not."""
    f = graphs.graphed(toy, static=("k",))
    base = dict(x=torch.arange(4.0), y=None, k=2)
    f(**base)
    f(**base)
    other = dict(base)
    if change == "shape":
        other["x"] = torch.arange(5.0)
    elif change == "dtype":
        other["x"] = torch.arange(4.0, dtype=torch.float64)
    elif change == "static":
        other["k"] = 3
    else:
        other["y"] = torch.ones(4)
    f(**other)
    assert (f.warmups, f.captures, f.stats()["keys"]) == (2, 1, 2)
    f(**base)
    assert (f.warmups, f.captures, f.replays) == (2, 1, 2)


def test_dict_and_tuple_arguments(stub):
    """Dicts and tuples of tensors are flattened into the key and the
    static buffers, and rebuilt in the body."""
    def body(d, pair):
        return d["a"] + pair[0] * pair[1]

    f = graphs.graphed(body)
    d = {"a": torch.ones(3)}
    for i in range(3):
        out = f(d, (torch.full((3,), float(i)), torch.full((3,), 2.0)))
        assert torch.equal(out, 1 + 2.0 * i * torch.ones(3))
    assert (f.warmups, f.captures, f.replays) == (1, 1, 2)


def test_eager_context_runs_the_body(stub):
    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    with graphs.eager():
        for _ in range(3):
            assert torch.equal(f(x, k=2)[0], 2 * x)
        with graphs.eager():
            f(x, k=2)
    assert f.stats()["warmups"] == 0 and not stub.made
    f(x, k=2)
    f(x, k=2)
    assert f.captures == 1


def test_cache_bound_least_recently_used_out(stub, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_KEYS", 2)
    f = graphs.graphed(toy, static=("k",))
    a, b, c = (torch.arange(float(n)) for n in (3, 4, 5))
    for x in (a, a, b, b):
        f(x)
    f(a)                       # a is now the most recent
    f(c)                       # evicts b
    assert f.stats()["keys"] == 2 and f.evictions == 1
    released = [g for g in stub.made if g.released]
    assert len(released) == 1
    f(a)
    assert f.captures == 2 and f.replays == 4  # a still cached
    f(b)
    assert f.warmups == 4                      # b warms up again


def test_clear_frees_graphs_and_counts(stub):
    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    f(x)
    f(x)
    graphs.clear()
    assert all(g.released for g in stub.made)
    assert f.stats()["keys"] == 0 and f.replays == 0
    f(x)
    assert f.warmups == 1


def test_nested_graphed_call_runs_inline(stub):
    """A graphed function inside another's body is part of its graph:
    no warm-up, capture or replay of its own."""
    inner = graphs.graphed(lambda x: x * 2)
    outer = graphs.graphed(lambda x: inner(x) + 1)
    x = torch.ones(3)
    for _ in range(3):
        assert torch.equal(outer(x), torch.full((3,), 3.0))
    assert inner.stats()["warmups"] == 0 and inner.replays == 0
    assert outer.replays == 2


def test_arguments_are_checked(stub):
    with pytest.raises(ValueError, match="not its arguments"):
        graphs.graphed(toy, static=("q",))
    with pytest.raises(TypeError, match="static="):
        graphs.graphed(toy)(torch.ones(2), k=3)  # k is not named static
    with pytest.raises(ValueError, match="tensors on"):
        graphs.graphed(toy, static=("k",))(torch.ones(2),
                                           torch.ones(2, device="meta"))


def test_a_failed_capture_raises_with_the_name(stub, monkeypatch):
    """A capture that fails raises, naming the function, and leaves the
    launch counts as they were; the function never runs eagerly instead."""
    def boom(self, body):
        body()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    f(x)
    before = dict(cuda_kernels.LAUNCHES)
    monkeypatch.setattr(StubGraph, "capture", boom)
    with pytest.raises(RuntimeError, match="toy: capture failed"):
        f(x)
    assert cuda_kernels.LAUNCHES == before
    assert f.replays == 0


def test_a_function_s_graphs_share_one_pool(stub):
    """Every key of a function captures into one pool, which orders their
    replays: each waits for the last and fences after its clones.
    Another function has a pool of its own; clear() drops them."""
    f = graphs.graphed(toy, static=("k",))
    g = graphs.graphed(toy, static=("k",))
    a, b = torch.arange(3.0), torch.arange(4.0)
    for x in (a, a, b, b, a):
        f(x)
    g(a)
    g(a)
    fa, fb, ga = stub.made
    assert fa.pool is fb.pool and ga.pool is not fa.pool
    assert (fa.pool.waits, fa.pool.fences) == (3, 3)
    assert (ga.pool.waits, ga.pool.fences) == (1, 1)
    graphs.clear()
    f(a)
    f(a)
    assert stub.made[-1].pool is not fa.pool


# ---------------------------------------------------------------------------
# (c) outputs outlive the next replay; (d) launches per replay
# ---------------------------------------------------------------------------

def test_outputs_survive_later_replays(stub):
    f = graphs.graphed(toy, static=("k",))
    f(torch.zeros(4))
    first = f(torch.ones(4))           # capture + replay
    second = f(torch.full((4,), 5.0))  # replay into the same static outputs
    assert torch.equal(first[0], torch.ones(4))
    assert torch.equal(first[1]["neg"], -torch.ones(4))
    assert torch.equal(second[0], torch.full((4,), 5.0))
    assert first[2] == 7 and second[2] == 7
    # the static outputs did move: only the clones kept the first result
    static = stub.made[0].out[0]
    assert torch.equal(static, torch.full((4,), 5.0))
    assert static.data_ptr() not in (first[0].data_ptr(),
                                     second[0].data_ptr())


def test_launches_added_per_replay(stub):
    f = graphs.graphed(toy, static=("k",))
    x = torch.arange(4.0)
    counts = []
    for _ in range(4):
        f(x)
        counts.append(cuda_kernels.LAUNCHES["cholesky_solve"])
    assert counts == [2, 4, 6, 8]
    with graphs.eager():
        f(x)
    assert cuda_kernels.LAUNCHES["cholesky_solve"] == 10


def test_a_caller_s_counter_added_per_replay(stub):
    """A counter in graphs.COUNTERS at a capture gets that capture's
    counts at every replay of its graph (chip_smoke.py counts B6's
    launches by shape so), and the capture's own are taken back."""
    by_shape = collections.Counter()

    def body(x):
        by_shape[tuple(x.shape)] += 1
        return x + 1

    f = graphs.graphed(body)
    a, b = torch.ones(2), torch.ones(3)
    graphs.COUNTERS.append(by_shape)
    try:
        for x in (a, a, a, b):
            f(x)
        assert +by_shape == {(2,): 3, (3,): 1}
    finally:
        graphs.COUNTERS.remove(by_shape)
    f(a)  # counted per capture: the graph keeps adding
    assert by_shape[(2,)] == 4


# ---------------------------------------------------------------------------
# (a) every graphed function of the port through the stub, bit for bit
# ---------------------------------------------------------------------------

def windows(B=2, P=3, L=8, seed=0):
    """B windows of P poses and L landmarks, every landmark seen by every
    pose, measurements with noise: the arguments of solve_windows."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, (B, L)), rng.uniform(-1, 1, (B, L)),
                  rng.uniform(6, 20, (B, L))], -1).astype(np.float32)
    xi = np.zeros((B, P, 6), np.float32)
    xi[:, 1:, 3:] = rng.normal(0, 0.2, (B, P - 1, 3))
    xi[:, 1:, :3] = rng.normal(0, 0.01, (B, P - 1, 3))
    poses = se3.se3_exp(torch.from_numpy(xi))
    ci = np.repeat(np.arange(P), L)[None].repeat(B, 0)
    li = np.tile(np.arange(L), P)[None].repeat(B, 0)
    Tt = poses[torch.arange(B)[:, None], torch.from_numpy(ci)]
    Xo = torch.from_numpy(X)[torch.arange(B)[:, None], torch.from_numpy(li)]
    Xc = se3.mv3(Tt[..., :3, :3], Xo) + Tt[..., :3, 3]
    meas = stereo.project(torch.from_numpy(CALIB), Xc)
    meas = meas + torch.from_numpy(rng.normal(0, 0.5, meas.shape)
                                   .astype(np.float32))
    w = torch.ones(ci.shape)
    w[:, -3:] = 0.0
    X0 = torch.from_numpy(X) + torch.from_numpy(
        rng.normal(0, 0.05, X.shape).astype(np.float32))
    p0 = poses.clone()
    p0[:, 1:, :3, 3] += 0.05
    return (p0, X0, torch.from_numpy(ci), torch.from_numpy(li), meas, w,
            torch.full((B,), P - 1, dtype=torch.int64),
            torch.from_numpy(CALIB))


def textures(F, H=64, W=96, seed=0, shift=0):
    """Smooth random images, each frame ``shift`` columns on from the
    last: (left, right) float32 with the right one 6 px to the left."""
    rng = np.random.default_rng(seed)
    base = rng.random((H + 8, W + 16 + 3 * F)).astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-3, 4) / 1.5) ** 2)
    k /= k.sum()
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    base = (base - base.min()) / (base.max() - base.min())
    left = np.stack([base[4:4 + H, 8 + shift + 3 * f:8 + shift + 3 * f + W]
                     for f in range(F)])
    right = np.stack([base[4:4 + H, 14 + shift + 3 * f:14 + shift + 3 * f
                           + W] for f in range(F)])
    return (torch.from_numpy(np.ascontiguousarray(left, np.float32)),
            torch.from_numpy(np.ascontiguousarray(right, np.float32)))


def verify_inputs(P=8, K=64, D=128, H=16, seed=0):
    g = torch.Generator().manual_seed(seed)

    def desc():
        d = torch.randn((P, K, D), generator=g)
        return (d / d.norm(dim=-1, keepdim=True)).half()

    links = torch.rand((P, K, 3), generator=g) * torch.tensor(
        [1000.0, 0.0, 300.0]) + torch.tensor([100.0, 0.0, 30.0])
    links[..., 1] = links[..., 0] - 20.0
    dq = desc()
    dc = dq.clone()
    dc[:, K // 2:] = desc()[:, K // 2:]
    valid = torch.rand((P, K), generator=g) > 0.1
    return (dq, valid, links, valid, dc, valid, links.clone(), valid,
            torch.from_numpy(CALIB), torch.rand((P, H, K), generator=g), 2.0)


def pose_graph(N=6, loops=((0, 4),), seed=0):
    """A drifting chain of N keyframes with loop edges, as a PoseGraph on
    the CPU (its dense ops take it padded to the 64 buckets)."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 3] = np.arange(N) * 0.8
    xi[:, :3] = rng.normal(0, 0.02, (N, 3))
    T = se3.se3_exp(torch.from_numpy(xi))
    pairs = [(k, k + 1) for k in range(N - 1)] + list(loops)
    e_i, e_j = (torch.tensor(list(x)) for x in zip(*pairs))
    Z = se3.retract(T[e_j] @ se3.inverse(T[e_i]), torch.from_numpy(
        rng.normal(0, 0.01, (len(pairs), 6)).astype(np.float32)))
    nodes = T.clone()
    for k in range(N - 1):
        nodes[k + 1] = Z[k] @ nodes[k]
    si = np.tile(np.diag([100.0] * 3 + [20.0] * 3).astype(np.float32),
                 (len(pairs), 1, 1))
    return PoseGraph(nodes=nodes.numpy(), keyframes=list(range(N)),
                     e_i=e_i.numpy().astype(np.int32),
                     e_j=e_j.numpy().astype(np.int32), Z=Z.numpy(),
                     sqrt_info=si,
                     is_loop=np.arange(len(pairs)) >= N - 1, device="cpu")


def pose_graph_args(g):
    """(padded args, n_valid, every j < i pair padded to its bucket):
    what PoseGraph's dense methods hand the ops."""
    args, n_valid = g._dense_args()
    ii, jj = np.tril_indices(g.num_nodes, k=-1)
    pi, pj = g._padded_pairs(jj, ii)
    return tuple(args), n_valid, (torch.from_numpy(pi), torch.from_numpy(pj))


GRAPHED = ("ops.ba.optimize_bundle", "ops.ba.solve_windows",
           "models.frontend._chunk", "models.frontend.recompute_descriptors",
           "models.loop_closure._verify_candidates",
           "ops.pose_graph.optimize", "ops.pose_graph.gn_hessian_inverse",
           "ops.pose_graph.gate_matrix", "ops.pose_graph.marginal_logdets")
# and a call under a key of its own: the frontend's first chunk (no carry)
CASES = GRAPHED + ("models.frontend._chunk, first chunk",)


def chunk_carry(seed=1):
    """A previous chunk's carry: its last frame's features and a relative
    pose that is not the identity."""
    carry = {k: v[-1] for k, v in frontend.chunk_features(
        *textures(4, seed=seed), CFG).items()}
    carry["last_T"] = se3.se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.1,
                                                0.0, 0.5]))
    return carry


@functools.lru_cache(maxsize=1)
def graphed_calls():
    """(graphed function, args, kwargs) for every case of CASES, at a
    small size."""
    win = windows()
    left, right = textures(4)
    calib = torch.from_numpy(CALIB)
    u = torch.rand((4, CFG.ransac.num_hypotheses, CFG.features.max_kp),
                   generator=torch.Generator().manual_seed(3))
    pga, n_valid, pairs = pose_graph_args(pose_graph())
    nv = {"n_valid": n_valid}
    calls = (
        (ba.optimize_bundle, win[:6] + win[7:], {"iters": 3}),
        (ba.solve_windows, win, {"iters": 3, "min_depth": 0.1,
                                 "max_depth": 1000.0, "huber_delta": 0.0}),
        (frontend._chunk, (left, right, chunk_carry(), calib, u, CFG), {}),
        (frontend.recompute_descriptors, (left, right, CFG), {}),
        (loop_closure._verify_candidates, verify_inputs(), {}),
        (pg_ops.optimize, pga, {"iters": 3, "lam0": 1e-6, **nv}),
        (pg_ops.gn_hessian_inverse, pga, nv),
        (pg_ops.gate_matrix, pga + pairs, nv),
        (pg_ops.marginal_logdets, pga, nv),
        (frontend._chunk, (left, right, None, calib, u, CFG), {}),
    )
    return dict(zip(CASES, calls))


def assert_same(a, b, where=""):
    la, lb = [], []
    sa = graphs._flatten(a, la, "a", out=True)
    sb = graphs._flatten(b, lb, "b", out=True)
    assert sa == sb, where
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=1.5), torch.nan_to_num(y, nan=1.5))), where


def test_every_graphed_function_is_listed():
    """The calls below cover every graphed function the port defines."""
    names = {f.name for f in graphs.functions()
             if f.fn.__module__.startswith("slam_tpu_torch.")}
    assert names == set(GRAPHED)
    assert all(graphed_calls()[n][0].name == n for n in GRAPHED)


def timeless(f, result):
    """A graphed call's result, less the frontend chunk's clock stamps
    (``_chunk``'s third value: times, not outputs) once they are seen to
    be three int64 stamps that do not fall."""
    if f is not frontend._chunk:
        return result
    out, carry, st = result
    assert st.dtype == torch.int64 and st.shape == (3,)
    assert bool((st[1:] >= st[:-1]).all()), st
    return out, carry


@pytest.mark.parametrize("name", CASES)
def test_graphed_function_equals_its_eager_body(stub, name):
    """On CPU tensors each graphed function returns its body's result bit
    for bit: eagerly, and through warm-up, capture and two replays of the
    stub graph (the second on new inputs of the same shapes). The frontend
    chunk's clock stamps are compared apart: they rise in every call."""
    f, args, kw = graphed_calls()[name]
    want = timeless(f, f.fn(*args, **kw))
    with graphs.eager():
        assert_same(timeless(f, f(*args, **kw)), want, "eager()")
    for i in range(3):
        assert_same(timeless(f, f(*args, **kw)), want, f"call {i}")
    assert (f.warmups, f.captures, f.replays) == (1, 1, 2)
    # new inputs of the same shapes go through the same graph
    args2 = [a.flip(0) if torch.is_tensor(a) and a.dim() > 1
             and a.shape[0] > 1 else a for a in args]
    assert_same(timeless(f, f(*args2, **kw)),
                timeless(f, f.fn(*args2, **kw)), "new inputs")
    assert f.replays == 3


def test_window_step_is_solve_windows():
    """models.bundle.window_step returns what the pre-graph step computed:
    the initial cost, optimize_bundle_pruned, pose_covariances and the
    gather of each window's last pose, bit for bit."""
    p0, x0, ci, li, meas, w, last, calib = windows(B=3, P=4)
    step = bundle.window_step(CALIB, torch.device("cpu"), iters=3)
    got = step(p0.numpy(), x0.numpy(), ci.numpy().astype(np.int32),
               li.numpy().astype(np.int32), meas.numpy(), w.numpy(),
               np.full(3, 4))
    cost0 = ba._cost(p0, x0, ci, li, meas, w, calib)
    poses, points, w2, cost = ba.optimize_bundle_pruned(
        p0, x0, ci, li, meas, w, calib, iters=3)
    covs = ba.pose_covariances(poses, points, ci, li, meas, w2, calib)
    b = torch.arange(3)
    assert_same(got, (poses, points, w2, cost, cost0, poses[b, 3],
                      covs[b, 3]))


def test_marginals_against_float64_inverse():
    """_marginals (an LU inverse per window, as the JAX package's
    jnp.linalg.inv) gives the diagonal blocks of a float64 inverse of S
    within 1e-5 of each block's norm, the gauge block zero, also where S
    is not positive definite (a weakly held landmark's Schur term
    cancels); a window whose S is singular gets NaN blocks and leaves the
    others as they were."""
    rng = np.random.default_rng(3)
    B, P = 3, 4
    A = rng.normal(size=(B, 6 * P, 6 * P))
    S = A @ A.transpose(0, 2, 1) + 6 * P * np.eye(6 * P)
    S[2] -= 30.0 * np.eye(6 * P)                     # indefinite
    S[:, :6, :] = S[:, :, :6] = 0.0
    S[:, :6, :6] = np.eye(6)
    S = torch.tensor(S, dtype=torch.float32)
    assert torch.linalg.eigvalsh(S[2].double()).min() < 0
    got = ba._marginals(S)
    inv = torch.linalg.inv(S.double()).reshape(B, P, 6, P, 6)
    d = torch.arange(P)
    want = inv[:, d, :, d, :].permute(1, 0, 2, 3)
    want = 0.5 * (want + want.transpose(-1, -2))
    want[:, 0] = 0.0
    err = (got.double() - want).flatten(2).norm(dim=2)
    assert (err <= 1e-5 * want.flatten(2).norm(dim=2) + 1e-12).all()
    bad = S.clone()
    bad[1, 10, :] = bad[1, :, 10] = 0.0
    got_bad = ba._marginals(bad)
    assert torch.isnan(got_bad[1]).all()
    torch.testing.assert_close(got_bad[[0, 2]], got[[0, 2]], rtol=0.0,
                               atol=0.0)


# ---------------------------------------------------------------------------
# (f) RANSAC's uniforms drawn outside the body: today's draw, bit for bit
# ---------------------------------------------------------------------------

def draw_before(valid, H, generator, draw_rows=None):
    """The hypotheses as ransac.sample_hypotheses drew them inside
    ransac_pnp before the draw moved out of the graphed bodies."""
    B, N = valid.shape
    lo, total = (0, B) if draw_rows is None else draw_rows
    u = torch.rand((total, H, N), generator=generator)[lo:lo + B]
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    logits = torch.where(valid, 0.0, -float("inf"))[:, None, :]
    return torch.topk(logits + g, 3, dim=-1).indices


@pytest.mark.parametrize("draw_rows", [None, (2, 9)])
def test_uniforms_drawn_outside_equal_the_draw_inside(draw_rows):
    feats = frontend.chunk_features(*textures(4), CFG)
    carry = {k: v[-1] for k, v in frontend.chunk_features(
        *textures(4, seed=1), CFG).items()}
    calib = torch.from_numpy(CALIB)
    H = CFG.ransac.num_hypotheses
    # chunk_motion draws, then runs its body on the uniforms
    got = frontend.chunk_motion(feats, carry, calib, CFG,
                                torch.Generator().manual_seed(5), draw_rows)
    F, K = feats["xy"].shape[:2]
    lo, total = (0, F) if draw_rows is None else draw_rows
    u = torch.rand((total, H, K),
                   generator=torch.Generator().manual_seed(5))[lo:lo + F]
    assert_same(got, frontend._motion(feats, carry, calib, u, CFG))
    # ransac_pnp on the uniforms drawn beforehand against the hypotheses
    # as they were drawn before, and (a whole batch) against its own draw
    pw, meas, valid = (torch.randn((F, K, 3)) + torch.tensor([0, 0, 9.0]),
                       torch.rand((F, K, 3)) * 300,
                       torch.rand((F, K)) > 0.3)
    b = ransac.ransac_pnp(pw, meas, valid, calib, uniforms=(
        ransac.hypothesis_uniforms(F, K, H, torch.Generator().manual_seed(6),
                                   draw_rows=draw_rows)))
    c = ransac.ransac_pnp(pw, meas, valid, calib, hyp_idx=draw_before(
        valid, H, torch.Generator().manual_seed(6), draw_rows))
    assert_same(b, c)
    if draw_rows is None:
        a = ransac.ransac_pnp(pw, meas, valid, calib, num_hypotheses=H,
                              generator=torch.Generator().manual_seed(6))
        assert_same(a, b)


@pytest.mark.parametrize("first", [True, False])
def test_process_chunk_draws_what_chunk_motion_drew(first):
    """process_chunk draws RANSAC's uniforms before the chunk's work, at
    (F, H, max_kp): the bits chunk_motion draws after the features, so a
    chunk gives what its three steps give in turn, bit for bit."""
    left, right = textures(4)
    calib = torch.from_numpy(CALIB)
    carry = None if first else chunk_carry()
    out, new_carry = frontend.process_chunk(
        left, right, carry, calib, CFG, frontend.chunk_generator(CFG, 3,
                                                                 "cpu"))
    feats = frontend.chunk_features(left, right, CFG)
    mot = frontend.chunk_motion(feats, carry, calib, CFG,
                                frontend.chunk_generator(CFG, 3, "cpu"))
    T_rel, T_chain = frontend.chunk_poses(
        mot.pop("T_est"), mot["pose_ok"], None if first else carry["last_T"])
    assert_same({k: out[k] for k in mot}, mot)
    assert_same((out["T_rel"], out["T_chain"], new_carry["last_T"]),
                (T_rel, T_chain, T_rel[-1]))
    assert_same({k: out[k] for k in ("xy", "valid", "links", "link_valid")},
                {k: feats[k] for k in ("xy", "valid", "links",
                                       "link_valid")})


# ---------------------------------------------------------------------------
# (e) no captured body reaches a host copy or a synchronisation
# ---------------------------------------------------------------------------

FORBIDDEN_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize",
                     "nonzero"}


def _resolve(node, glb):
    """The object a call's function expression names, from the module's
    globals (a name, or attributes of one), or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name) or node.id not in glb:
        return None
    obj = glb[node.id]
    for p in reversed(parts):
        obj = getattr(obj, p, None)
        if obj is None:
            return None
    return obj


def _forbidden_calls(fn, seen: set, prefix: str = "slam_tpu_torch") -> list:
    """Forbidden calls in ``fn`` and in every function of the port it
    calls, transitively. A function under functools.lru_cache is skipped:
    its body ran at the warm-up, outside the capture, for the key the
    capture sees."""
    if isinstance(fn, graphs.GraphedFunction):
        fn = fn.fn
    if (not isinstance(fn, types.FunctionType) or fn in seen
            or not fn.__module__.startswith(prefix)):
        return []
    seen.add(fn)
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    where = f"{fn.__module__}.{fn.__qualname__}"
    names = dict(fn.__globals__)
    for node in ast.walk(tree):  # imports inside the function
        if isinstance(node, ast.ImportFrom):
            mod = importlib.import_module(
                "." * node.level + (node.module or ""),
                fn.__module__.rpartition(".")[0])
            for a in node.names:
                names[a.asname or a.name] = getattr(mod, a.name, None)
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in FORBIDDEN_METHODS:
            bad.append(f"{where}: .{f.attr}()")
        if (isinstance(f, ast.Attribute) and f.attr == "tensor"
                and isinstance(f.value, ast.Name) and f.value.id == "torch"):
            bad.append(f"{where}: torch.tensor(")
        if isinstance(f, ast.Name) and f.id == "nonzero":
            bad.append(f"{where}: nonzero(")
        callee = _resolve(f, names)
        if isinstance(callee, functools._lru_cache_wrapper):
            continue
        bad += _forbidden_calls(callee, seen, prefix)
    return bad


def test_no_captured_body_syncs_or_copies_to_the_host():
    """(e) An AST walk from every graphed body through the port's
    functions it calls: none calls .item(), .cpu(), .numpy(), .tolist(),
    nonzero, torch.tensor( or .synchronize()."""
    seen: set = set()
    bad = []
    for f in graphs.functions():
        bad += _forbidden_calls(f, seen)
    assert len(seen) > 40  # the walk reached the kernels' wrappers
    assert cuda_kernels.cholesky_solve in seen
    assert cuda_kernels.schur_reduce in seen
    assert cuda_kernels.schur_back in seen
    assert cuda_kernels.mutual_nearest in seen
    assert cuda_kernels.detect_maps in seen
    assert cuda_kernels.stamp in seen  # the frontend chunk's clock
    # the covariances' inverse and the pose graph's bodies are walked too
    assert ba._marginals in seen and pg_ops._covariance_full in seen
    assert pg_ops.mahalanobis_batched in seen
    assert not bad, bad


def _probe_helper(x):
    return x.sum().item()


def _probe_body(x):
    return x * _probe_helper(x)


def test_the_guard_sees_a_sync():
    """The walk finds a forbidden call one function down."""
    assert _forbidden_calls(_probe_body, set(), prefix=__name__) == [
        f"{__name__}._probe_helper: .item()"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


def to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to(v, device) for v in x)
    return x


# a window batch graphed against eager on the card (chip_smoke.py's
# SLICE_TOL: 2e-4 per pose entry, 1e-4 relative cost)
POSE_TOL, COST_TOL = 2e-4, 1e-4


def close_windows(a, b):
    assert torch.allclose(a[0], b[0], atol=POSE_TOL, rtol=0)
    assert torch.allclose(a[3], b[3], rtol=COST_TOL, atol=1e-6)
    assert torch.allclose(a[5], b[5], atol=POSE_TOL, rtol=0)
    assert torch.equal(a[2], b[2])
    # the covariances, inside the graph (an LU inverse per window): within
    # 1e-3 of their norm
    assert float((a[6] - b[6]).norm()) <= 1e-3 * float(b[6].norm())


@pytest.mark.cuda
def test_cuda_window_batch_graph_matches_eager(cuda):
    """solve_windows (the LM, the covariances and the gathers, one graph)
    against eager on the card, B6 counted once per LM iteration either
    way, and a replay with new inputs."""
    win = to(windows(B=4, P=4, L=16), cuda)
    with graphs.eager():
        cuda_kernels.reset_counters()
        want = ba.solve_windows(*win, iters=5)
        eager_launches = dict(cuda_kernels.LAUNCHES)
    assert eager_launches["cholesky_solve"] == 10
    for _ in range(3):
        cuda_kernels.reset_counters()
        got = ba.solve_windows(*win, iters=5)
        assert cuda_kernels.LAUNCHES == eager_launches
        close_windows(got, want)
    assert ba.solve_windows.replays == 2
    win2 = to(windows(B=4, P=4, L=16, seed=1), cuda)
    got2 = ba.solve_windows(*win2, iters=5)
    with graphs.eager():
        want2 = ba.solve_windows(*win2, iters=5)
    close_windows(got2, want2)
    close_windows(got, want)  # held past the next replay


@pytest.mark.cuda
def test_cuda_keys_sharing_a_pool_replay_in_any_order(cuda):
    """Two window batch shapes capture into solve_windows' one pool and
    reuse each other's intermediates: replayed in turns, in the order of
    their captures and against it, each gives its eager result, and every
    output held until the end stays as it was returned."""
    ws = {"a": to(windows(B=4, P=4, L=16), cuda),
          "b": to(windows(B=2, P=3, L=12, seed=2), cuda)}
    with graphs.eager():
        want = {k: ba.solve_windows(*w, iters=5) for k, w in ws.items()}
    got = [(k, ba.solve_windows(*ws[k], iters=5))
           for k in ("a", "b", "a", "b", "b", "a", "a", "b")]
    for k, g in got:
        close_windows(g, want[k])
    st = ba.solve_windows.stats()
    assert (st["keys"], st["captures"], st["replays"]) == (2, 2, 6)


@pytest.mark.cuda
def test_cuda_frontend_chunk_graph_matches_eager(cuda):
    """process_chunk from its graphs equal bit for bit to eager, with and
    without a carry, and on new images."""
    left, right = to(textures(4), cuda)
    calib = torch.from_numpy(CALIB).to(cuda)

    def run(l_, r_):
        out0, carry = frontend.process_chunk(
            l_, r_, None, calib, CFG,
            frontend.chunk_generator(CFG, 0, cuda))
        out1, _ = frontend.process_chunk(
            l_, r_, carry, calib, CFG,
            frontend.chunk_generator(CFG, 1, cuda))
        return out0, out1

    with graphs.eager():
        want = run(left, right)
    for _ in range(3):
        assert_same(run(left, right), want)
    assert frontend._chunk.replays >= 4
    l2, r2 = to(textures(4, seed=2), cuda)
    got2 = run(l2, r2)
    with graphs.eager():
        assert_same(got2, run(l2, r2))


@pytest.mark.cuda
def test_cuda_chunk_stamps_time_the_replayed_graph(cuda):
    """The frontend chunk's clock stamps (the card's global timer inside
    its graph) rise within a replay, and their span, features plus
    motion, is within 10 % of the replay's device time by CUDA events
    around the call (median of five), at KITTI's image size, where the
    chunk's work outweighs the copies into its static buffers and the
    clones of its outputs that the events also hold."""
    cfg = SlamConfig(runtime=RuntimeConfig(chunk_frames=8))
    left, right = to(textures(8, H=376, W=1241), cuda)
    calib = torch.from_numpy(CALIB).to(cuda)
    u = torch.rand((8, cfg.ransac.num_hypotheses, cfg.features.max_kp),
                   device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    args = (left, right, None, calib, u, cfg)
    for _ in range(2):  # the warm-up, then the capture
        frontend._chunk(*args)
    spans, events = [], []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        st = frontend._chunk(*args)[2]
        ev[1].record()
        torch.cuda.synchronize()
        st = st.cpu()
        assert bool((st[1:] > st[:-1]).all()), st
        spans.append(int(st[2] - st[0]))
        events.append(ev[0].elapsed_time(ev[1]) * 1e6)
    assert frontend._chunk.replays >= 5
    span_ns, event_ns = float(np.median(spans)), float(np.median(events))
    assert abs(span_ns - event_ns) <= 0.1 * event_ns, (spans, events)


@pytest.mark.cuda
def test_cuda_verification_graph_matches_eager(cuda):
    args = to(verify_inputs(), cuda)
    with graphs.eager():
        want = loop_closure._verify_candidates(*args)
    for _ in range(3):
        got = loop_closure._verify_candidates(*args)
        assert torch.equal(got["num_inliers"], want["num_inliers"])
        assert torch.equal(got["match_tgt"], want["match_tgt"])
        assert torch.allclose(got["T"], want["T"], atol=1e-5)
    assert loop_closure._verify_candidates.replays == 2


def on_card(g, device):
    g.device = str(device)
    return g


@pytest.mark.cuda
def test_cuda_pose_graph_optimize_graph_matches_eager(cuda):
    """All 15 LM iterations of the pose graph from one graph against eager
    on the card; a loop edge more stays in the 64-edge bucket and replays
    the same graph."""
    g = on_card(pose_graph(N=17, loops=((0, 12), (3, 16))), cuda)
    args, n_valid = g._dense_args()

    def run(a):
        return pg_ops.optimize(*a, iters=15, n_valid=n_valid)

    with graphs.eager():
        want = run(args)
    for _ in range(3):
        got = run(args)
        assert torch.allclose(got[0], want[0], atol=1e-4, rtol=0)
        assert torch.allclose(got[1], want[1], rtol=1e-3, atol=1e-6)
    assert (pg_ops.optimize.captures, pg_ops.optimize.replays) == (1, 2)
    g.add_edge(2, 14, g.nodes[14] @ np.linalg.inv(g.nodes[2]),
               np.eye(6) * 1e-2)
    args2, _ = g._dense_args()
    got2 = run(args2)
    with graphs.eager():
        want2 = run(args2)
    assert torch.allclose(got2[0], want2[0], atol=1e-4, rtol=0)
    assert pg_ops.optimize.stats()["keys"] == 1
    assert pg_ops.optimize.replays == 3


@pytest.mark.cuda
def test_cuda_gate_matrix_graph_matches_eager(cuda):
    """The posterior refresh and the gate sweep over the bucket's padded pairs from
    one graph against eager on the card: distances within 1e-3, the same
    pairs failing closed; PoseGraph.gate_distances replays it."""
    g = on_card(pose_graph(N=17, loops=((0, 12),)), cuda)
    args, n_valid, pairs = pose_graph_args(g)
    pairs = tuple(p.to(cuda) for p in pairs)
    with graphs.eager():
        want = pg_ops.gate_matrix(*args, *pairs, n_valid=n_valid)
    for _ in range(3):
        got = pg_ops.gate_matrix(*args, *pairs, n_valid=n_valid)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        f = torch.isfinite(want)
        assert torch.allclose(got[f], want[f], rtol=1e-3, atol=1e-4)
    ii, jj = np.tril_indices(17, k=-1)
    d = g.gate_distances(jj, ii)
    np.testing.assert_allclose(d, want[:len(ii)].cpu().numpy(), rtol=1e-3,
                               atol=1e-4)
    st = pg_ops.gate_matrix.stats()
    assert (st["keys"], st["captures"], st["replays"]) == (1, 1, 3)


@pytest.mark.cuda
def test_cuda_batched_lu_inverse_capture_raises(cuda):
    """The covariances' old route, torch.linalg.inv_ex at the window BA's
    (16, 144, 144), synchronises with the host (its batched LU): its
    capture raises naming the function."""
    def batched_inverse(S):
        return torch.linalg.inv_ex(S)[0]

    f = graphs.graphed(batched_inverse)
    A = torch.randn((16, 144, 144), device=cuda)
    S = A @ A.transpose(1, 2) + 144 * torch.eye(144, device=cuda)
    f(S)
    with pytest.raises(RuntimeError,
                       match="batched_inverse: capture failed"):
        f(S)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_capture_that_meets_a_sync_raises(cuda):
    """A body that asks the host for a value cannot be captured: the call
    raises naming the function, and never runs eagerly instead."""
    def needs_host(x):
        return x * float(x.sum().item())

    f = graphs.graphed(needs_host)
    x = torch.ones(8, device=cuda)
    assert torch.equal(f(x), x * 8)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError, match="needs_host: capture failed"):
        f(x)
    torch.cuda.synchronize()
    # the card still works, and eager() still runs the body
    with graphs.eager():
        assert torch.equal(f(x), x * 8)
