"""Ranks of a ``torch.distributed`` process group: joining one, and
starting them.

A mesh over several devices (parallel/mesh.py) runs one process per
device, not one process driving them all: the port's LM and frontend are
eager Python loops whose host launches already cost as much as the
device's work (PERF.md section 5), and one interpreter launching for N
cards would multiply that host time by N. Each rank launches its own
kernels from its own interpreter; the mesh's collectives join them.

The caller names the backend: ``nccl`` for one card per rank, ``gloo``
for CPU ranks or for ranks that share a card (gloo all-reduces CUDA
tensors through host memory). NCCL refuses two ranks on one card, so
asking for it with more ranks on a host than cards raises before any
work; there is no switch to another backend.

Two ways to start ranks: ``torchrun --nproc-per-node N <script>``, whose
script calls :func:`init_rank` (``env://`` rendezvous), or
:func:`spawn`, which starts N processes through ``torch.multiprocessing``
with a ``file://`` rendezvous in a temporary directory, joins them within
a time limit and kills them all if one fails or outlives it.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, ranks_per_host: int, device_type: str,
                  n_cards: int) -> None:
    """Raise ValueError unless ``backend`` can join ``ranks_per_host`` ranks
    on this host's devices: nccl needs a card per rank, gloo takes CPU
    ranks and ranks that share cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("nccl joins CUDA cards: use gloo for CPU ranks")
    if ranks_per_host > n_cards:
        raise ValueError(
            f"nccl needs one card per rank: {ranks_per_host} ranks on "
            f"{n_cards} card(s) would put two ranks on one device; use gloo "
            f"for ranks that share a card")


def init_rank(backend: str, device="cuda",
              init_method: str = "env://") -> torch.device:
    """Join the default process group as the rank the environment names
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE: torchrun sets them,
    as ``spawn`` does) and return its device: on the card, card
    LOCAL_RANK modulo the host's cards (made the current device, so that
    "cuda" names it); else the CPU."""
    from ..ops.cuda_kernels import resolve_device

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    check_backend(backend, per_host, dev.type, n_cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               init_method: str, out: str, args: tuple,
               threads: int | None) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, and write
    ("ok", its result) or ("error", the traceback) to ``out``; exit 1 on
    an error."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        init_rank(backend, device, init_method)
        result = ("ok", fn(*args))
    except BaseException:  # reported to the parent, which fails the run
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized() and result[0] == "ok":
        dist.destroy_process_group()
    sys.stdout.flush()
    os._exit(0 if result[0] == "ok" else 1)


def spawn(fn, n_ranks: int, backend: str, device="cuda", args: tuple = (),
          timeout: float = 600.0, threads: int | None = None) -> list:
    """Run ``fn(*args)`` in ``n_ranks`` new processes, one rank each of a
    fresh process group on ``device`` (one card per rank under nccl, the
    host's cards shared under gloo, or the CPU), and return every rank's
    result in rank order. ``fn`` must be importable by the new processes
    (a module-level function), and ``threads`` caps each rank's torch
    threads. The kernels are built here first, so that the ranks load one
    library rather than race ``nvcc``. A rank that fails, or a run that
    outlives ``timeout`` seconds, kills every rank and raises
    RuntimeError with the ranks' errors."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..ops import cuda_kernels

        cuda_kernels.resolve_device(dev)
        check_backend(backend, n_ranks, "cuda", torch.cuda.device_count())
        cuda_kernels.build()
    else:
        check_backend(backend, n_ranks, dev.type, 0)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="slam_ranks_") as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        outs = [str(Path(tmp) / f"rank{r}.pkl") for r in range(n_ranks)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n_ranks, backend, str(device), init, outs[r], args,
            threads)) for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"{len(running)} of {n_ranks} ranks still running "
                        f"after {timeout:.0f} s: killed"
                        + _errors(procs, outs))
                wait([p.sentinel for p in running], timeout=left)
                running = [p for p in running if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(
                        "a rank failed (exit codes "
                        f"{[p.exitcode for p in procs]})"
                        + _errors(procs, outs))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results


def _errors(procs, outs) -> str:
    """The tracebacks the failed ranks wrote, for the parent's error."""
    text = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.exitcode not in (None, 0) and os.path.exists(out):
            with open(out, "rb") as f:
                status, detail = pickle.load(f)
            if status == "error":
                text.append(f"\n--- rank {r} ---\n{detail}")
    return "".join(text)
