"""The runner's path for a cell over several ranks (``harness/ranked.py``),
on gloo ranks of the CPU, through ``runner.run``'s ``program_factory``.

A stub program (``rank_stubs.Stub``: the real one-process pipeline once
per sequence, that result again on every later call, each call logged)
shows the ranks calling in lockstep on the same images, a raise on one
rank counted as one failed sequence, a hung rank killed within the
watchdog's limit with no result and no process left, and the fullest
rank's peak; the real mesh program with a fault on one rank's share of
the window BA reads ``correct`` false. A cell of one card starts no rank.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import rank_stubs
from conftest import tiny
from harness import ranked, runner

SEED = 2**31 + 4242
FRAMES = 16          # a stub's sequence: two windows, no closure
RANKS = 4
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _stub_run(tmp_path, seconds=1.0, traced=False, **plan):
    cell = tiny(frames=FRAMES, ranks=RANKS)
    factory = functools.partial(rank_stubs.Stub,
                                plan=dict(plan, log=str(tmp_path)))
    res = runner.run(cell, SEED, seconds, traced, device="cpu",
                     program_factory=factory)
    assert not dist.is_initialized()
    assert not _children()
    return res


def _children() -> list:
    """The processes whose parent is this one (the ranks, the spawn
    context's resource tracker), from /proc."""
    me, out = str(os.getpid()), []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if stat.rsplit(")", 1)[1].split()[1] == me:
                out.append(int(d.name))
    return out


def _calls(tmp_path, rank):
    lines = (tmp_path / f"rank{rank}.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines]


def test_ranks_call_in_lockstep_on_the_same_images(tmp_path):
    res = _stub_run(tmp_path, traced=True)
    assert set(res) == KEYS | {"breakdown"}
    calls = [_calls(tmp_path, r) for r in range(RANKS)]
    # set-up's three calls (the first sequence twice, one pass over the
    # one sequence: no graph settles on the CPU), the window's, the traced
    # pass's one
    assert len(calls[0]) == 3 + res["attempted"] + 1
    for c in calls[1:]:
        assert c == calls[0]
    assert len({c["digest"] for c in calls[0]}) == 1
    dev = res["device"]
    assert dev["count"] == RANKS
    assert [p["rank"] for p in dev["per_rank"]] == list(range(RANKS))
    assert dev["window_s"] > 0


def test_a_raise_on_one_rank_is_one_failed_sequence(tmp_path):
    # set-up makes three calls on the one sequence; the fourth is the
    # window's first
    res = _stub_run(tmp_path, **{"raise": [2, 4]})
    assert res["failed"] == 1
    assert res["attempted"] >= 2
    assert not res["correct"]
    calls = [_calls(tmp_path, r) for r in range(RANKS)]
    assert all(len(c) == len(calls[0]) for c in calls)


def test_peak_is_the_fullest_ranks(tmp_path):
    res = _stub_run(tmp_path, seconds=0.01, hold=[3, 1 << 30])
    per = res["device"]["per_rank"]
    peaks = [p["memory_peak_bytes"] for p in per]
    assert res["device"]["memory_peak_bytes"] == max(peaks)
    assert max(peaks) == peaks[3]


HANG = """
import functools, json, sys
sys.path[:0] = {paths!r}
import rank_stubs
from conftest import tiny
from harness import ranked, runner
ranked.SEQ_LIMIT_S = 20.0
cell = tiny(frames={frames}, ranks={ranks})
factory = functools.partial(rank_stubs.Stub, plan={{"hang": [2, 5]}})
print(json.dumps(runner.run(cell, {seed}, 5.0, False, device="cpu",
                            program_factory=factory)))
"""


def test_a_hung_rank_is_killed_with_no_result(tmp_path):
    tests = Path(__file__).resolve().parent
    bench = tests.parent
    script = HANG.format(paths=[str(tests), str(bench.parent), str(bench),
                                str(bench / "reference")],
                         frames=FRAMES, ranks=RANKS, seed=SEED)
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == ranked.EXIT_HUNG, proc.stderr[-3000:]
    assert '"correct"' not in proc.stdout
    assert "ranks [2] did not finish" in proc.stderr, proc.stderr[-3000:]
    line = next(x for x in proc.stderr.splitlines()
                if "children pids" in x)
    pids = json.loads(line.split("children pids ")[1])
    assert len(pids) == RANKS - 1
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_one_card_cell_starts_no_rank(tmp_path):
    cell = tiny(frames=FRAMES)
    assert cell.ranks == 1
    res = runner.run(cell, SEED, 0.01, False, device="cpu",
                     program_factory=rank_stubs.Stub)
    assert not _children()
    assert not dist.is_initialized()
    assert set(res) == KEYS
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["device"]["count"] == 1


def test_fault_on_one_ranks_ba_share_reads_not_correct():
    cell = tiny(ranks=RANKS)
    res = runner.run(cell, SEED, 0.01, False, device="cpu",
                     program_factory=rank_stubs.faulty_mesh)
    assert res["failed"] == 0
    assert not res["correct"], res["compared"]
