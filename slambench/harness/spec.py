"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a file of its own: ``configs/<name>.json`` (the file the
configuration's entry names), ``traffic/<name>.json`` and, for the
comparison that decides ``correct``, ``limits/<cell>.json``. A per-layer
metric is ``metrics/<name>.py``. A later cell, configuration, mix or
metric is added as files and entries, and no file here changes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration's file
    traffic_name: str
    traffic: dict         # the traffic mix's file
    limits: dict          # the compared numbers' limits
    end_to_end: list      # BENCHMARK.json's metrics that this cell reports
    per_layer: list

    @property
    def deployment(self) -> dict:
        """The configuration's layout over cards (``deployment``): its
        ``ranks``, one card each with a mesh of one shard per rank, over
        ``backend``; one process on one card where the file names none."""
        return self.config.get("deployment", {"ranks": 1})

    @property
    def ranks(self) -> int:
        return int(self.deployment["ranks"])


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits read
    from their files. Raises KeyError for a name BENCHMARK.json lacks."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((BENCH_DIR / "traffic" /
                            f"{w['traffic']}.json").read_text()),
        limits=json.loads((BENCH_DIR / "limits" / f"{name}.json")
                          .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_file(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"
