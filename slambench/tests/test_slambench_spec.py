"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from harness import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"]
    assert BENCH["command"] == ["python3", "slambench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200, cells
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("slambench/configs/")
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k)
        # the settings load into both sides' configuration classes
        cell = next(w for w in BENCH["workloads"] if w["config"] == c["name"])
        loaded = spec.load_cell(cell["name"])
        assert runner.program_config(loaded).to_json() == \
            runner.reference_config(loaded).to_json()


def test_kitti00_settings():
    h = json.loads((spec.BENCH_DIR / "configs/kitti00_harris.json")
                   .read_text())
    a = json.loads((spec.BENCH_DIR / "configs/kitti00_akaze.json")
                   .read_text())
    from slam_tpu_torch.config import SlamConfig

    assert runner.program_config(spec.load_cell("harris.loop80")).to_json() \
        == SlamConfig().to_json()
    assert h["geometry"] == a["geometry"] == {
        "image_hw": [376, 1241],
        "calib": [718.856, 718.856, 607.1928, 185.2157, 0.5372]}
    assert a["settings"]["features"]["detector"] == "akaze"
    assert a["settings"]["features"]["num_levels"] == 4
    assert a["settings"]["features"]["akaze_threshold"] == 8e-4
    assert a["settings"]["matching"]["norm"] == "hamming"
    assert a["settings"]["matching"]["max_hamming"] == 40.0
    for key in ("ransac", "keyframes", "bundle", "loop", "runtime"):
        assert a["settings"][key] == h["settings"][key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert _one_line(w["why"])
    c = spec.load_cell(cell)
    # one card, or four where the configuration runs four ranks: the
    # cell takes a card per rank
    assert (w["chips"], c.ranks) in ((1, 1), (4, 4))
    assert c.traffic["input"] in ("memory", "disk")
    assert c.limits and set(c.limits) <= set(runner.check.NUMBERS)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert spec.metric_file(m["name"]).exists()
        assert hasattr(runner.load_metric(m["name"]), "read")


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"])
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert set(layers) == {"frontend", "track store", "window BA",
                           "pose graph and loop closure", "kernels",
                           "device"}


def test_four_chip_cells_are_few():
    """At most a quarter of the cells, rounded down, or one, take four
    cards."""
    cells = BENCH["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four
    assert all(w["chips"] in (1, 4) for w in cells)


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_deployment(conf):
    """A configuration's ``deployment``: one process on one card where it
    names none; else 1 or 4 ranks over nccl, and nothing more."""
    c = next(x for x in BENCH["configs"] if x["name"] == conf)
    body = json.loads((spec.ROOT / c["file"]).read_text())
    d = body.get("deployment", {"ranks": 1})
    assert isinstance(d["ranks"], int) and d["ranks"] in (1, 4)
    if d["ranks"] > 1:
        assert d == {"ranks": d["ranks"], "backend": "nccl"}
    else:
        assert d == {"ranks": 1}
