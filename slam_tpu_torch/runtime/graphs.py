"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each hot function as one compiled program: the LM
loop (``slam_tpu/ops/ba.py`` ``optimize_bundle``, a ``lax.scan``), the
frontend chunk (``slam_tpu/models/frontend.py`` ``process_chunk``), loop
verification. PyTorch runs op by op, and on the card the host's launches
set the pace: one BA LM iteration launches some hundred small kernels.
``graphed`` captures a function once per key as a ``torch.cuda.CUDAGraph``
and replays it, so one host call launches every kernel of its body:

  * the key: the values of the static arguments (``static=`` names, as
    ``jax.jit``'s ``static_argnames``), the structure of the other
    arguments (tensors, None, and tuples, lists and dicts of them) and
    each tensor's shape, dtype and device;
  * the first call with a key runs the body eagerly on the card. That
    warm-up builds the kernel library, sets the kernels' shared-memory
    attributes, makes the cuBLAS and cuDNN handles and fills the device
    constants' caches, all outside any capture;
  * the second call copies its inputs into static buffers, captures the
    body on a side stream (``capture_error_mode="thread_local"``: the
    prefetch and decode threads allocate pinned memory meanwhile), and
    replays it;
  * every later call copies its inputs into the static buffers, replays
    on the current stream and returns clones of the static outputs, so
    that a caller may hold an output past the next replay.

A function's graphs share one memory pool per device, as the keys of a
jitted function share its buffers: a capture reuses the intermediates of
the function's earlier captures. So their replays never overlap: each
waits for the last replay of any of them (and its clones), wherever it
ran, and a graph may replay on another stream than the call before.

A body must launch only device work, at shapes its key fixes: no host
copy, no synchronisation, no random draw (draw the uniforms before the
call and pass them in). A capture that fails raises with the function's
name; a graphed function never falls back to eager on the card.

Tensors on the CPU always run the body eagerly: that is the caller
asking for the CPU, as the tests do. Inside ``eager()``, the counterpart
of ``jax.disable_jit``, every graphed function runs op by op. So does
every call in a rank of a process group of more than one rank: the rank
paths (``parallel/``) interleave their steps with collectives, which
gloo runs through host memory, and they stay eager (ROADMAP.md). A graphed
function called inside another's body (its warm-up or its capture) runs
inline, as a jitted function inside a jitted one is traced into it.

Kernel launches (``ops.cuda_kernels.LAUNCHES``) are counted in Python by
the wrappers, and a replay runs no Python: each graph records the counts
its capture added to each counter of ``COUNTERS`` (the launches, the
plain versions' calls, and any a caller adds there before the capture),
takes them back (a capture launches nothing), and adds them at every
replay, so that a run counts the same launches with graphs and under
``eager()``. ``stats()`` gives warm-ups, captures, replays, keys and the
bytes of the capture pool per function, ``totals()`` their sums;
``clear()`` frees every graph and its memory pool. Each function keeps
at most ``MAX_KEYS`` graphs, the least recently used going first.

Each call that reaches a graph (not inline, not on the CPU, not under
``eager()``) is a span ``graph:<function name>`` of the active
``utils.profiling`` timer: the host's launch, from the input copies into
the static buffers to the output clones. A key's first call opens a
``warmup`` span inside it, its second a ``capture`` span.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from collections import OrderedDict

import torch
import torch.distributed as dist

from ..ops import cuda_kernels
from ..utils import profiling

# window batches come in several shapes on one path: the 16-window
# batch, the loop-closure pair and the overlap's flushes, each of its own
# size (chip_smoke.py 4l (c) prints the keys)
MAX_KEYS = 8
# the counters each replay adds its capture's counts to (a caller may add
# one of its own before the capture, as chip_smoke.py counts B6 by shape)
COUNTERS = [cuda_kernels.LAUNCHES, cuda_kernels.PLAIN_CALLS]
_LEAF = "tensor"
# the counts that ``totals()`` sums
TOTALS = ("warmups", "captures", "replays", "evictions")


class CudaPool:
    """The memory pool a function's graphs share on one device, and the
    event recorded after their last replay and its clones."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.done = None

    def wait(self) -> None:
        """Order this call after the last replay of the pool's graphs:
        they reuse each other's intermediates and static outputs."""
        if self.done is not None:
            torch.cuda.current_stream(self.device).wait_event(self.done)

    def fence(self) -> None:
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(self.device))

    def drain(self) -> None:
        if self.done is not None:
            self.done.synchronize()


class CudaGraph:
    """One captured body on the card, behind the interface ``GraphedFunction``
    uses (``GRAPH``, the factory it calls, is the seam where the tests
    put a graph of their own; ``GRAPH.Pool`` makes its pools)."""

    Pool = CudaPool
    _streams: dict = {}

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self, pool: CudaPool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.pool_bytes = 0

    def capture(self, body):
        """Capture ``body()`` into the pool on the device's side stream;
        returns its (static) outputs. Raises what the capture raised."""
        dev = self.pool.device
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            before = torch.cuda.memory_reserved(dev)
            self.graph.capture_begin(pool=self.pool.handle,
                                     capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        return out

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        """Drop the graph once the pool's last replay has finished."""
        self.pool.drain()
        self.graph = None


GRAPH = CudaGraph


class _State(threading.local):
    depth = 0   # > 0 inside a graphed body (warm-up or capture)


_STATE = _State()
_LOCK = threading.RLock()
_EAGER = [0]
_FUNCTIONS: list = []


@contextlib.contextmanager
def eager():
    """Every graphed function runs op by op inside this context (the
    counterpart of ``jax.disable_jit``)."""
    with _LOCK:
        _EAGER[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _EAGER[0] -= 1


def _flatten(x, leaves: list, name: str, out: bool = False):
    """The structure of ``x`` (hashable), its tensors appended to
    ``leaves``; a non-tensor leaf raises, but in outputs, where it is
    kept as a constant of the key."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, leaves, name, out) for v in x))
    if isinstance(x, dict):
        return (dict, tuple(x),
                tuple(_flatten(v, leaves, name, out) for v in x.values()))
    if out and isinstance(x, (bool, int, float, str)):
        return ("const", x)
    raise TypeError(f"graphed {name}: {type(x).__name__} among the tensor "
                    f"arguments; name its argument in static=")


def _unflatten(spec, leaves):
    """Rebuild a structure from ``_flatten``'s spec and an iterator of
    its tensors."""
    if spec == _LEAF:
        return next(leaves)
    if spec is None:
        return None
    kind = spec[0]
    if kind == "const":
        return spec[1]
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    return kind(_unflatten(s, leaves) for s in spec[1])


class _Entry:
    """One key's graph: static input and output buffers, and the counts
    one run of the body adds to each counter, as (counter, delta)."""

    def __init__(self):
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.out_spec = None
        self.counts = []


def _in_process_group() -> bool:
    """True in a rank of a process group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _add(counter: dict, delta: dict, sign: int = 1) -> None:
    for k, n in delta.items():
        counter[k] += sign * n


class GraphedFunction:
    """``fn`` run from a CUDA graph per key (the module docstring)."""

    def __init__(self, fn, static=()):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.static = tuple(static)
        self._sig = inspect.signature(fn)
        unknown = set(self.static) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"graphed {fn.__qualname__}: static names "
                             f"{sorted(unknown)} are not its arguments")
        mod = fn.__module__.split("slam_tpu_torch.")[-1]
        self.name = f"{mod}.{fn.__qualname__}"
        # no dots: a span's key joins the names of the open spans by dots
        self.span_name = f"graph:{fn.__name__}"
        self._entries: OrderedDict = OrderedDict()
        self._pools: dict = {}   # device -> the pool its graphs share
        self._reset_counts()
        with _LOCK:
            _FUNCTIONS.append(self)

    def _reset_counts(self) -> None:
        self.warmups = self.captures = self.replays = self.evictions = 0

    def _inline(self, args, kwargs):
        _STATE.depth += 1
        try:
            return self.fn(*args, **kwargs)
        finally:
            _STATE.depth -= 1

    def __call__(self, *args, **kwargs):
        if _STATE.depth or _EAGER[0] or _in_process_group():
            return self.fn(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics = tuple((k, v) for k, v in bound.arguments.items()
                        if k in self.static)
        dyn = {k: v for k, v in bound.arguments.items()
               if k not in self.static}
        leaves: list = []
        spec = _flatten(dyn, leaves, self.name)
        devices = {t.device for t in leaves}
        if len(devices) > 1:
            raise ValueError(f"graphed {self.name}: tensors on "
                             f"{sorted(map(str, devices))}")
        if not devices or not GRAPH.supports(next(iter(devices))):
            return self.fn(*args, **kwargs)
        key = (statics, spec,
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        with profiling.span(self.span_name), _LOCK:
            entry = self._entries.get(key)
            if entry is None:
                self._insert(key)
                self.warmups += 1
                with profiling.span("warmup"):
                    return self._inline(bound.args, bound.kwargs)
            self._entries.move_to_end(key)
            if entry.graph is None:
                with profiling.span("capture"):
                    self._capture(entry, bound, spec, leaves, devices.pop())
            return self._replay(entry, leaves)

    def _insert(self, key) -> None:
        self._entries[key] = _Entry()
        while len(self._entries) > MAX_KEYS:
            _, old = self._entries.popitem(last=False)
            if old.graph is not None:
                old.graph.release()
            self.evictions += 1

    def _capture(self, entry: _Entry, bound, spec, leaves, device) -> None:
        static_in = [t.clone() for t in leaves]
        bound.arguments.update(_unflatten(spec, iter(static_in)))
        pool = self._pools.get(device)
        if pool is None:
            pool = self._pools[device] = GRAPH.Pool(device)
        graph = GRAPH(pool)
        counters = list(COUNTERS)
        before = [dict(c) for c in counters]
        _STATE.depth += 1
        try:
            out = graph.capture(lambda: self.fn(*bound.args, **bound.kwargs))
        except Exception as e:
            raise RuntimeError(f"graphed {self.name}: capture failed "
                               f"({type(e).__name__}: {e})") from e
        finally:
            _STATE.depth -= 1
            # a capture launches nothing: take its counts back
            entry.counts = [(c, {k: n - b.get(k, 0) for k, n in c.items()
                                 if n != b.get(k, 0)})
                            for c, b in zip(counters, before)]
            for c, delta in entry.counts:
                _add(c, delta, -1)
        out_leaves: list = []
        entry.out_spec = _flatten(out, out_leaves, self.name, out=True)
        entry.static_out = out_leaves
        entry.static_in = static_in
        entry.graph = graph
        self.captures += 1

    def _replay(self, entry: _Entry, leaves):
        graph = entry.graph
        graph.pool.wait()
        for buf, t in zip(entry.static_in, leaves):
            buf.copy_(t)
        graph.replay()
        for c, delta in entry.counts:
            _add(c, delta)
        outs = [t.clone() for t in entry.static_out]
        graph.pool.fence()
        self.replays += 1
        return _unflatten(entry.out_spec, iter(outs))

    def stats(self) -> dict:
        pool = sum(getattr(e.graph, "pool_bytes", 0)
                   for e in self._entries.values() if e.graph is not None)
        return {"warmups": self.warmups, "captures": self.captures,
                "replays": self.replays, "keys": len(self._entries),
                "evictions": self.evictions, "pool_bytes": pool}

    def clear(self) -> None:
        for e in self._entries.values():
            if e.graph is not None:
                e.graph.release()
        self._entries.clear()
        self._pools.clear()
        self._reset_counts()


def graphed(fn=None, *, static=()):
    """``fn`` replayed from a CUDA graph per key (the module docstring);
    as a decorator, ``@graphed(static=("cfg",))``."""
    if fn is None:
        return functools.partial(graphed, static=static)
    return GraphedFunction(fn, static)


def functions() -> list:
    """Every graphed function, in the order they were made."""
    with _LOCK:
        return list(_FUNCTIONS)


def stats() -> dict:
    """Per graphed function (``module.qualname``): warm-ups, captures,
    replays, cached keys, evictions and the bytes its captures added to
    its memory pool."""
    with _LOCK:
        return {f.name: f.stats() for f in _FUNCTIONS}


def totals() -> dict:
    """Warm-ups, captures, replays and evictions so far, summed over
    every graphed function."""
    out = dict.fromkeys(TOTALS, 0)
    for st in stats().values():
        for k in TOTALS:
            out[k] += st[k]
    return out


def clear() -> None:
    """Free every graph, its static buffers and its memory pool, and
    zero the counts."""
    with _LOCK:
        for f in _FUNCTIONS:
            f.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
