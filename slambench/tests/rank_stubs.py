"""Programs for the rank runner's tests (``test_slambench_ranks.py``),
importable by the ranks that ``harness/ranked.py`` spawns.

``Stub`` stands in for the program on every rank: it runs the real
one-process pipeline on the CPU once per sequence and hands that result
back on every later call, logs each call (the sequence and the digest of
its images) to a file of its rank, and does what its ``plan`` says on one
rank: raise on its n-th call, hang on its n-th call, or hold a large
block of memory. ``faulty_mesh`` is the real mesh program with the
window BA's LM iterations taken away on one rank alone.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import numpy as np

from harness import runner


def seq_digest(seq) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(seq.left).tobytes())
    h.update(np.ascontiguousarray(seq.right).tobytes())
    return h.hexdigest()


class Stub:
    def __init__(self, cfg, calib, device, from_disk, mesh=None, plan=None):
        self.real = runner.Program(cfg, calib, device, from_disk)
        self.pipeline = self.real.pipeline
        self.rank = mesh.rank if mesh is not None else 0
        self.plan = plan or {}
        self.cache, self.calls = {}, 0
        self.log = Path(self.plan["log"]) / f"rank{self.rank}.jsonl" \
            if "log" in self.plan else None
        if self.plan.get("hold", [None])[0] == self.rank:
            self.held = np.ones(self.plan["hold"][1], np.uint8)

    def _at(self, key) -> bool:
        when = self.plan.get(key)
        return when is not None and when == [self.rank, self.calls]

    def __call__(self, seq):
        self.calls += 1
        if self.log is not None:
            with open(self.log, "a") as f:
                f.write(json.dumps({"sequence": seq.index,
                                    "digest": seq_digest(seq)}) + "\n")
        if self._at("raise"):
            raise RuntimeError(f"planted on rank {self.rank}")
        if self._at("hang"):
            time.sleep(3600)
        if seq.index not in self.cache:
            self.cache[seq.index] = self.real(seq)
        return self.cache[seq.index]


def faulty_mesh(cfg, calib, device, from_disk, mesh, rank=2):
    """The mesh program, with the window BA on rank ``rank`` returning its
    share of the windows unoptimized (no LM iteration)."""
    if mesh.rank == rank:
        from slam_tpu_torch.models import bundle

        orig = bundle.window_step
        bundle.window_step = lambda calib, device, iters=20, **kw: orig(
            calib, device, iters=0, **kw)
    return runner.Program(cfg, calib, device, from_disk, mesh)
