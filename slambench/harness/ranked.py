"""The ranks of a cell whose configuration spans several cards: one rank
per card, one process each.

``runner.run`` takes this path when the cell's configuration has
``deployment.ranks`` > 1, and runs set-up, the window, the traced pass
and the comparison as for one card (``runner._run``) on a ``Group``: the
program, whose call runs a sequence on every rank in step, and the
cards, which answer the rest of what ``_run`` asks (``settled``,
``traced_pass``, ``record``, ``release``).

Layout: this process is rank 0 on card 0; it starts ranks 1 to W-1 as
child processes (spawn context), rank i on card i. Every rank joins one
process group through the program's ``parallel.ranks.init_rank`` (nccl
on the card, gloo on the CPU), with a ``file://`` rendezvous in a fresh
directory under ``$TMPDIR``, and builds ``make_mesh()``: one shard per
rank.

Rank 0 renders the cell's sequences as a one-card run does and
broadcasts the host uint8 arrays over the group; each rank checks that
the digest of what it got equals rank 0's before set-up ends. From then
on rank 0 drives the others by one broadcast command at a time: run
sequence i (every rank calls ``run_pipeline(..., mesh=mesh, device=<its
card>)``, then one all-reduce of each rank's "raised" and "not finite"
flags; where any rank failed, the call raises on every rank, and the
window counts a failed sequence; its wall time ends after that
all-reduce), sum the ranks' graph warm-ups and captures, profile the
same pass on every rank, report the peaks, take new images
(``calibrate.py``), stop. The spans that the metrics read are rank 0's
``res.timings``.

No hang, no orphan: a watchdog thread of rank 0 gives every command a
limit (``SETUP_LIMIT_S`` for a sequence's first call, ``SEQ_LIMIT_S``
after). When a command outlives it, or a rank's process ends before the
stop, it logs which ranks did not finish, kills and reaps every rank and
ends this process with ``EXIT_HUNG``: no result line. Each child ends
itself when rank 0's process is gone (its lifeline pipe reads EOF).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait

import numpy as np

from . import runner, trace, traffic

STOP, RUN, SETTLED, TRACE, REPORT, SHARE = range(6)
EXIT_HUNG = 5
# a sequence on four nccl ranks took at most ~9.1 s on four H100s
# (PERF.md, section 6); its limit is about ten times that
SEQ_LIMIT_S = 90.0
# a sequence's first call on the ranks loads the kernels and warms its
# shapes eagerly; joining and sharing the images
SETUP_LIMIT_S = 300.0
# a command that runs no sequence (a sum, a gather)
COMMAND_LIMIT_S = 120.0
JOIN_S = 60.0

log = runner.log


class Failed(RuntimeError):
    """A sequence that raised, or gave a trajectory that is not finite,
    on some rank: raised on every rank."""


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_bytes(dev) -> int:
    """The rank's peak: the card's allocator peak, or on the CPU the
    process's largest resident set."""
    import torch

    if dev.type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    import resource

    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def images_digest(seqs) -> str:
    h = hashlib.sha256()
    for s in seqs:
        h.update(np.ascontiguousarray(s.left).tobytes())
        h.update(np.ascontiguousarray(s.right).tobytes())
    return h.hexdigest()


class Rank:
    """One rank's side of the protocol: joining, the images, the commands
    and what each does on this rank. ``done`` is told, after a command's
    own work and before its collective, the number of the command (the
    join is 1): the watchdog's reading of who finished."""

    def __init__(self, rank, world, backend, device, init, done, cell,
                 factory, calib):
        import torch

        from slam_tpu_torch.parallel.mesh import make_mesh
        from slam_tpu_torch.parallel.ranks import init_rank

        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        self.rank, self.world = rank, world
        self.dev = init_rank(backend, device, init)
        self.comm = self.dev if backend == "nccl" else torch.device("cpu")
        self.mesh = make_mesh(device=self.dev)
        self.step = 1
        self._done = done
        self.program = factory(runner.program_config(cell), calib, self.dev,
                               False, self.mesh)

    def done(self) -> None:
        self._done(self.step)

    def command(self, cmd: int = 0, arg: int = 0) -> tuple:
        """Rank 0's (cmd, arg), broadcast to every rank."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([cmd, arg], dtype=torch.int64, device=self.comm)
        dist.broadcast(t, 0)
        self.step += 1
        return int(t[0]), int(t[1])

    def share(self, seqs=None) -> list:
        """Rank 0's sequences (host uint8) on every rank, by broadcast; the
        other ranks' ``Sequence``s carry no scene. Raises when a rank's
        digest differs from rank 0's."""
        import torch
        import torch.distributed as dist

        meta = [[(s.index, s.scene_seed, tuple(s.left.shape))
                 for s in seqs] if self.rank == 0 else None]
        dist.broadcast_object_list(meta, src=0, device=self.comm)
        out = []
        for k, (index, scene_seed, shape) in enumerate(meta[0]):
            pair = []
            for side in ("left", "right"):
                if self.rank == 0:
                    t = torch.from_numpy(np.ascontiguousarray(
                        getattr(seqs[k], side))).to(self.comm)
                else:
                    t = torch.empty(shape, dtype=torch.uint8,
                                    device=self.comm)
                dist.broadcast(t, 0)
                pair.append(t.cpu().numpy())
                del t
            out.append(seqs[k] if self.rank == 0 else traffic.Sequence(
                index, scene_seed, None, pair[0], pair[1]))
        self.done()
        digests = self.gather(images_digest(out))
        if any(d != digests[0] for d in digests):
            raise RuntimeError(f"the ranks' images differ: digests "
                               f"{digests}")
        return out

    def __call__(self, seq):
        """This rank's run of one sequence, in step with the others: its
        result, or ``Failed`` on every rank where any rank raised or gave
        a trajectory that is not finite."""
        import torch
        import torch.distributed as dist

        res, flags = None, [0, 0]
        try:
            res = self.program(seq)
            _sync(self.dev)
            flags[1] = int(runner._failed(res, seq.frames))
        except Exception as exc:  # a failed operation, counted
            flags[0] = 1
            log(f"[rank {self.rank}] sequence {seq.index} raised {exc!r}")
        self.done()
        t = torch.tensor(flags, dtype=torch.int64, device=self.comm)
        dist.all_reduce(t)
        raised, not_finite = (int(x) for x in t.tolist())
        if raised or not_finite:
            raise Failed(f"sequence {seq.index}: {raised} rank(s) raised, "
                         f"{not_finite} gave a trajectory not finite")
        return res

    def settled(self) -> int:
        """Graph warm-ups and captures so far, summed over the ranks: a
        pass that adds none on any rank is warm."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([runner.settled()], dtype=torch.int64,
                         device=self.comm)
        self.done()
        dist.all_reduce(t)
        return int(t[0])

    def gather(self, value) -> list:
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, value)
        return out

    def traced_pass(self, seqs) -> tuple:
        """``runner._traced_pass`` over the sequences on this rank, in step
        with the others; (this rank's Trace, every rank's busy and window
        seconds)."""
        tr = runner._traced_pass(self, seqs, self.dev)
        self.done()
        return tr, self.gather({"busy_s": tr.busy_s(),
                                "window_s": tr.window_s})

    def peaks(self) -> list:
        """Every rank's peak memory."""
        self.done()
        return self.gather(_peak_bytes(self.dev))


def _lifeline(conn) -> None:
    """A child's guard: rank 0's process holds the other end; when it is
    gone the pipe reads EOF and this rank ends at once."""
    try:
        while True:
            conn.recv()
    except BaseException:
        pass
    os._exit(3)


def _child(rank, world, backend, device, init, cell, factory, calib,
           progress, lifeline) -> None:
    """Ranks 1 to W-1: join, take the images, serve rank 0's commands."""
    os.dup2(2, 1)  # standard output is rank 0's result line alone
    threading.Thread(target=_lifeline, args=(lifeline,), daemon=True).start()
    code = 0
    try:
        runner.setup_env()
        if device == "cpu":  # CPU ranks share the host's cores
            import torch

            torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1)
                                             // world)))
        r = Rank(rank, world, backend, device, init, progress.send, cell,
                 factory, calib)
        seqs = r.share()
        while True:
            cmd, arg = r.command()
            if cmd == STOP:
                break
            try:
                if cmd == RUN:
                    r(seqs[arg])
                elif cmd == SETTLED:
                    r.settled()
                elif cmd == TRACE:
                    r.traced_pass(seqs)
                elif cmd == REPORT:
                    r.peaks()
                elif cmd == SHARE:
                    seqs = r.share()
            except Failed:  # rank 0 counts it
                pass
    except BaseException:
        traceback.print_exc()
        code = 1
    if code == 0:
        import torch.distributed as dist

        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _stop_resource_tracker() -> None:
    """End and reap the helper process that the spawn context starts
    beside the children, so that it does not outlive this process."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


class Watchdog:
    """Rank 0's guard over the children: each command is armed with a
    limit; past it, or when a child's process ends before the stop, the
    ranks are killed and this process ends with ``EXIT_HUNG``."""

    def __init__(self, procs, conns):
        self.procs, self.conns = procs, list(conns)
        self.world = len(procs) + 1
        self.done = [0] * self.world
        self.step = 0
        self.deadline = None
        self.what = ""
        self.closing = False   # the stop is sent: children may end
        self.stopping = False  # every child has ended: the thread ends
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def arm(self, limit_s: float, what: str) -> None:
        with self.lock:
            self.step += 1
            self.what = what
            self.deadline = time.monotonic() + limit_s

    def mine(self, step: int) -> None:
        self.done[0] = step

    def disarm(self) -> None:
        with self.lock:
            self.deadline = None

    def _watch(self) -> None:
        live = {c: r + 1 for r, c in enumerate(self.conns)}
        while not self.stopping:
            for c in wait(list(live), timeout=0.2) if live else ():
                try:
                    self.done[live[c]] = c.recv()
                except (EOFError, OSError):
                    del live[c]
            if not live:
                time.sleep(0.2)
            with self.lock:
                if self.stopping:
                    return
                ended = [] if self.closing else [
                    r + 1 for r, p in enumerate(self.procs)
                    if p.exitcode is not None]
                late = (self.deadline is not None
                        and time.monotonic() > self.deadline)
                if ended or late:
                    why = (f"rank(s) {ended} ended (exit codes "
                           f"{[self.procs[r - 1].exitcode for r in ended]})"
                           if ended else "the limit passed")
                    self._fail(why)

    def _fail(self, why: str) -> None:
        missing = [r for r in range(self.world) if self.done[r] < self.step]
        log(f"[ranks] {self.what} (command {self.step}): {why}; ranks "
            f"{missing} did not finish it; killing every rank")
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            p.join(JOIN_S)
        log(f"[ranks] exit codes {[p.exitcode for p in self.procs]}; no "
            f"result")
        _stop_resource_tracker()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_HUNG)


class Group:
    """Rank 0's handle on the ranks, and what ``runner._run`` drives: a
    call runs one sequence on every rank (rank 0's result), and the
    cards' questions go to every rank, each command under the
    watchdog."""

    def __init__(self, cell, factory, calib, device: str):
        import torch

        self.cell, self.factory, self.calib = cell, factory, calib
        self.world = cell.ranks
        cuda = str(device).startswith("cuda")
        self.backend = cell.deployment["backend"] if cuda else "gloo"
        self.device = "cuda" if cuda else "cpu"
        self.procs, self.lifelines = [], []
        self.watchdog = None
        self.r = None
        self.warm = set()
        self.per_rank = None
        self.env = {k: os.environ.get(k) for k in
                    ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
        self.tmp = tempfile.mkdtemp(prefix="slambench_ranks_")
        if cuda:
            from slam_tpu_torch.ops import cuda_kernels

            # one build for every rank, before they start (as the
            # program's parallel.ranks.spawn does)
            cuda_kernels.build()
            if torch.cuda.device_count() < self.world:
                raise RuntimeError(
                    f"{cell.name} needs {self.world} cards, "
                    f"{torch.cuda.device_count()} present")
        from slam_tpu_torch import runtime

        runtime.available()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self, seqs) -> list:
        """Start ranks 1 to W-1, join as rank 0, share the images; the
        ranks' sequences (rank 0's own)."""
        import torch

        ctx = torch.multiprocessing.get_context("spawn")
        init = "file://" + os.path.join(self.tmp, "rendezvous")
        conns = []
        for rank in range(1, self.world):
            got, sent = ctx.Pipe(duplex=False)
            alive_r, alive_w = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_child, args=(
                rank, self.world, self.backend, self.device, init, self.cell,
                self.factory, self.calib, sent, alive_r), daemon=True)
            p.start()
            sent.close()
            alive_r.close()
            self.procs.append(p)
            conns.append(got)
            self.lifelines.append(alive_w)
        log(f"[ranks] {self.world} ranks over {self.backend}; children "
            f"pids {[p.pid for p in self.procs]}")
        self.watchdog = Watchdog(self.procs, conns)
        self.watchdog.arm(SETUP_LIMIT_S, "joining and sharing the images")
        self.r = Rank(0, self.world, self.backend, self.device, init,
                      self.watchdog.mine, self.cell, self.factory,
                      self.calib)
        seqs = self.r.share(seqs)
        self.watchdog.disarm()
        return seqs

    def _do(self, cmd, arg, limit, what, fn):
        self.watchdog.arm(limit, what)
        try:
            self.r.command(cmd, arg)
            return fn()
        finally:
            self.watchdog.disarm()

    @property
    def pipeline(self):
        return self.r.program.pipeline

    def __call__(self, seq):
        """Sequence ``seq`` on every rank: rank 0's result, or ``Failed``."""
        limit = SEQ_LIMIT_S if seq.index in self.warm else SETUP_LIMIT_S
        self.warm.add(seq.index)
        return self._do(RUN, seq.index, limit, f"sequence {seq.index}",
                        lambda: self.r(seq))

    def settled(self) -> int:
        return self._do(SETTLED, 0, COMMAND_LIMIT_S, "settled",
                        self.r.settled)

    def traced_pass(self, program, seqs):
        """Every rank profiles a pass over its sequences (``program`` is
        this group); rank 0's trace, each rank's busy and window kept for
        ``record``."""
        tr, self.per_rank = self._do(
            TRACE, 0, SEQ_LIMIT_S * (len(seqs) + 1), "the traced pass",
            lambda: self.r.traced_pass(seqs))
        for rank, p in enumerate(self.per_rank):
            log(f"[trace] rank {rank}: busy {p['busy_s']:.4f} of "
                f"{p['window_s']:.4f} s")
        return tr

    def record(self, tr) -> dict:
        """The ``device`` record: ``count`` the ranks' cards,
        ``memory_peak_bytes`` the fullest card's; with a trace ``busy_s``
        and ``window_s`` averaged over the cards; ``per_rank`` each card's
        peak (and busy and window)."""
        import torch

        peaks = self._do(REPORT, 0, COMMAND_LIMIT_S, "report", self.r.peaks)
        per = [{"rank": k, "memory_peak_bytes": b}
               for k, b in enumerate(peaks)]
        cuda = self.device == "cuda"
        out = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": self.world, "memory_peak_bytes": max(peaks)}
        if tr is not None:
            for p, t in zip(per, self.per_rank):
                p.update(t)
            out["busy_s"] = sum(p["busy_s"] for p in per) / len(per)
            out["window_s"] = sum(p["window_s"] for p in per) / len(per)
        out["per_rank"] = per
        return out

    def release(self) -> None:
        """The window and its readings are done: stop the ranks before the
        comparison."""
        self.close()

    def share(self, seqs) -> list:
        """New sequences on every rank (``calibrate.py``, a seed after
        another)."""
        return self._do(SHARE, 0, COMMAND_LIMIT_S, "sharing the images",
                        lambda: self.r.share(seqs))

    def close(self) -> None:
        """Stop every rank and wait for it (killing what outlives
        ``JOIN_S``), leave the group, remove the rendezvous; once."""
        import torch.distributed as dist

        if self.tmp is None:
            return
        if self.watchdog is not None:
            self.watchdog.closing = True
            self.watchdog.arm(2 * JOIN_S, "the stop")
        if self.r is not None:
            # every rank leaves the group at once (nccl's teardown waits
            # for the peers)
            try:
                self.r.command(STOP)
                dist.destroy_process_group()
            except Exception as exc:
                log(f"[ranks] the stop did not reach every rank: {exc!r}")
        for p in self.procs:
            p.join(JOIN_S)
            if p.exitcode is None:
                log(f"[ranks] pid {p.pid} outlived the stop: killed")
                p.kill()
                p.join()
        if self.watchdog is not None:
            with self.watchdog.lock:
                self.watchdog.stopping = True
        for c in self.lifelines:
            c.close()
        _stop_resource_tracker()
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.tmp = None
