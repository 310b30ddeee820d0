"""Tracing and profiling utilities.

Counterpart of ``slam_tpu/utils/profiling.py``:

  * :class:`StageTimer` - nested host-clock spans (seconds and entries
    per dotted key), the program's one span mechanism; :func:`span` opens
    one on the timer active in this context (``run_pipeline``'s), and
    :func:`add` records a duration the device's clock measured (a
    ``device:`` span, :func:`is_device_key`);
  * :func:`device_trace` - a ``torch.profiler`` scope (host activity, and
    the card's when it is in use) that writes a Chrome trace into a
    directory;
  * :func:`log` - structured ``key=value`` event lines on stdlib logging.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("slam_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s",
                                      "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

# a span's name on the profiler's timeline: STAGE + its dotted key
STAGE = "stage:"
# the last part of a span's key that the device's clock timed: DEVICE +
# its name (StageTimer.add)
DEVICE = "device:"
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "slam_tpu_torch_stage_timer", default=None)
_NULL = contextlib.nullcontext()


def log(event: str, **fields) -> None:
    """Structured event log line (key=value pairs)."""
    suffix = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("%s %s", event, suffix)


class StageTimer:
    """Nested host-clock spans with a flat report.

    A span's key is its name under the spans open around it, joined by
    dots (``frontend.wait``); seconds and entries are summed per key. The
    clock is ``time.perf_counter_ns``. While a ``torch.profiler`` is
    recording, each span is also a ``record_function`` named
    ``stage:<key>``, on the timeline that stamps the device's events; with
    none recording a span costs two clock reads and a few dict updates.

    A span only times the host: one that should cover device work ends
    on a host read of its result, which the code it wraps already makes.
    The timer is not thread-safe: spans go to it from the thread that
    made it active (``active``) alone; a thread started inside has no
    active timer, and its spans are not recorded. ``run_pipeline``'s
    overlapped stage records none inside it (``unrecorded``): over ranks
    each runs another half of it, and no benchmark cell runs it."""

    def __init__(self) -> None:
        self.ns: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self._stack: list[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        key = f"{self._stack[-1]}.{name}" if self._stack else name
        if key not in self.ns:  # the report lists keys as first opened
            self.ns[key] = self.counts[key] = 0
        self._stack.append(key)
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(STAGE + key)
            rf.__enter__()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self._stack.pop()
            self.ns[key] += dt
            self.counts[key] += 1

    def add(self, name: str, ns: int) -> None:
        """One entry of ``ns`` nanoseconds measured by another clock (the
        card's, ``ops.cuda_kernels.stamp``) under the spans open now, as
        the span ``device:<name>``, with no host clock read and no
        ``record_function``: its time runs beside the host's spans and is
        no part of theirs (:func:`is_device_key`)."""
        name = DEVICE + name
        key = f"{self._stack[-1]}.{name}" if self._stack else name
        self.ns[key] = self.ns.get(key, 0) + int(ns)
        self.counts[key] = self.counts.get(key, 0) + 1

    def active(self):
        """Make this the timer that :func:`span` opens spans on, in this
        context, for the length of the block."""
        return _activate(self)

    def seconds(self, key: str) -> float:
        return self.ns.get(key, 0) * 1e-9

    def report(self) -> dict[str, float]:
        """Seconds per dotted key."""
        return {k: v * 1e-9 for k, v in self.ns.items()}

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


@contextlib.contextmanager
def _activate(timer):
    token = _ACTIVE.set(timer)
    try:
        yield timer
    finally:
        _ACTIVE.reset(token)


def unrecorded():
    """No active timer for the length of the block: spans opened inside
    are not recorded."""
    return _activate(None)


def span(name: str):
    """A span ``name`` under the spans open on the active timer (the
    ``run_pipeline`` call this runs in); a no-op with no active timer, as
    when a test calls a model or an op directly."""
    timer = _ACTIVE.get()
    return _NULL if timer is None else timer.span(name)


def add(name: str, ns: int) -> None:
    """``StageTimer.add`` on the active timer; a no-op with none."""
    timer = _ACTIVE.get()
    if timer is not None:
        timer.add(name, ns)


def is_device_key(key: str) -> bool:
    """Whether a dotted key is a span of the device's clock
    (``StageTimer.add``) rather than of the host's."""
    return key.rsplit(".", 1)[-1].startswith(DEVICE)


@contextlib.contextmanager
def device_trace(out_dir: str | Path, enabled: bool = True,
                 device: str = "cuda"):
    """A ``torch.profiler`` scope: host activity, plus the card's when
    ``device`` is a CUDA device; on exit the Chrome trace is written to
    ``out_dir/trace.json``. Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
