"""Tracing and profiling utilities.

Counterpart of ``slam_tpu/utils/profiling.py``:

  * :class:`StageTimer` - nested wall-clock spans with a JSON dump;
  * :func:`device_trace` - a ``torch.profiler`` scope (host activity, and
    the card's when it is in use) that writes a Chrome trace into a
    directory;
  * :func:`log` - structured ``key=value`` event lines on stdlib logging.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

logger = logging.getLogger("slam_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s",
                                      "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log(event: str, **fields) -> None:
    """Structured event log line (key=value pairs)."""
    suffix = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("%s %s", event, suffix)


class StageTimer:
    """Nested wall-clock spans with a flat JSON report."""

    def __init__(self) -> None:
        self.spans: dict[str, float] = {}
        self._stack: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        self._stack.append((name, t0))
        try:
            yield
        finally:
            self._stack.pop()
            prefix = ".".join(n for n, _ in self._stack)
            key = f"{prefix}.{name}" if prefix else name
            self.spans[key] = self.spans.get(key, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return dict(self.spans)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


@contextlib.contextmanager
def device_trace(out_dir: str | Path, enabled: bool = True,
                 device: str = "cuda"):
    """A ``torch.profiler`` scope: host activity, plus the card's when
    ``device`` is a CUDA device; on exit the Chrome trace is written to
    ``out_dir/trace.json``. Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
