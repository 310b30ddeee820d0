"""The per-layer metrics that read the frontend's device-clock spans
(``frontend.device:features`` and ``frontend.device:motion``: the card's
clock stamped inside the frontend's chunk graph), on hand-made records:
the sums over the frames, a sequence without the key read as 0 ms, and
no records, or a program that stamps no chunk, read as None."""

import pytest

from harness import runner, spec

NAMES = {"frontend_features_dev_ms_per_frame": "frontend.device:features",
         "frontend_motion_dev_ms_per_frame": "frontend.device:motion"}


def _ctx(records, cell="sift.loop80"):
    return runner.MetricContext(spec.load_cell(cell), list(records), None)


def _record(i, frames=80, from_disk=False, **timings):
    return {"index": i, "frames": frames, "wall_s": 0.9, "windows": 16,
            "from_disk": from_disk,
            "timings": dict({"frontend": 0.8, "frontend.wait": 0.7,
                             "bundles": 0.05}, **timings)}


RECORDS = [
    _record(0, **{"frontend.device:features": 0.6,
                  "frontend.device:motion": 0.03}),
    _record(1, frames=40, **{"frontend.device:features": 0.3,
                             "frontend.device:motion": 0.012}),
]


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reads_the_device_spans(name):
    """The span's seconds over every sequence, over their 120 frames."""
    want = {"frontend_features_dev_ms_per_frame": 1e3 * 0.9 / 120,
            "frontend_motion_dev_ms_per_frame": 1e3 * 0.042 / 120}[name]
    assert runner.load_metric(name).read(_ctx(RECORDS)) == pytest.approx(
        want)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_a_sequence_without_the_key_reads_zero(name):
    """A sequence with no stamped chunk adds its frames and no time."""
    got = runner.load_metric(name).read(_ctx(RECORDS[:1] + [_record(1)]))
    assert got == pytest.approx(
        1e3 * RECORDS[0]["timings"][NAMES[name]] / 160)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_no_records_or_no_stamps_read_none(name):
    """No records, and a program that stamps no chunk (the parent of the
    stamps: the host spans alone), read None; so does a program that
    times its stages only."""
    m = runner.load_metric(name)
    assert m.read(_ctx([])) is None
    assert m.read(_ctx([_record(0), _record(1)])) is None
    bare = [dict(r, timings={"frontend": 0.8}) for r in RECORDS]
    assert m.read(_ctx(bare)) is None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_disk_input_reads_the_same(name):
    """The device's time does not depend on where the images came from:
    sequences read from PNGs count too."""
    disk = [dict(r, from_disk=True) for r in RECORDS]
    m = runner.load_metric(name)
    assert m.read(_ctx(disk)) == pytest.approx(m.read(_ctx(RECORDS)))


def test_every_cell_reports_the_device_spans():
    """Both are listed for every cell, in the frontend's layer, move
    seq_fps and read a program span."""
    bench = spec.load_benchmark()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NAMES:
        m = metrics[name]
        assert m["source"] == "program_span" and m["moves"] == "seq_fps"
        assert m["layer"] == "frontend" and m["unit"] == "ms/frame"
        assert m["workloads"] == cells
        for c in cells:
            assert name in [x["name"] for x in spec.load_cell(c).per_layer]
