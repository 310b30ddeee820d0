"""The per-layer metrics that read the program's spans below its stages
(``harness/spans.py``), on hand-made records: the sums and their bases, a
missing key read as 0 ms, no records read as None, and records of a
program that records no span below its stages read as None."""

import pytest

from harness import runner, spec


def _ctx(records, cell="harris.loop80"):
    return runner.MetricContext(spec.load_cell(cell), list(records), None)


def _record(i, **timings):
    return {"index": i, "frames": 80, "wall_s": 0.25, "windows": 16,
            "from_disk": False,
            "timings": dict({"frontend": 0.05, "trackstore": 0.004,
                             "bundles": 0.112, "pose_graph": 0.01,
                             "loop_closure": 0.07}, **timings)}


RECORDS = [
    _record(0, **{"frontend.wait": 0.008, "frontend.take_in.wait": 0.001,
                  "frontend.fill": 0.004, "bundles.build": 0.016,
                  "bundles.wait": 0.032, "bundles.take_in": 0.002,
                  "pose_graph.optimize": 0.001, "loop_closure.optimize": 0.01,
                  "loop_closure.optimize.wait": 0.009,
                  "loop_closure.gate": 0.03, "loop_closure.gate.wait": 0.02,
                  "loop_closure.verify": 0.02}),
    _record(1, **{"frontend.wait": 0.007, "bundles.build": 0.016,
                  "bundles.wait": 0.016, "loop_closure.gate": 0.01}),
]
# what each reads from RECORDS: sums over 160 frames, 32 windows, 2
# sequences
EXPECTED = {
    "frontend_wait_ms_per_frame": 1e3 * 0.016 / 160,
    "bundles_build_ms_per_window": 1e3 * 0.032 / 32,
    "bundles_wait_ms_per_window": 1e3 * 0.048 / 32,
    "pose_graph_lm_ms_per_seq": 1e3 * 0.011 / 2,
    "loop_gate_ms_per_seq": 1e3 * 0.04 / 2,
    "loop_verify_ms_per_seq": 1e3 * 0.02 / 2,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_the_spans(name):
    assert runner.load_metric(name).read(_ctx(RECORDS)) == pytest.approx(
        EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_missing_key_reads_zero(name):
    """A sequence with spans, none of them this metric's, reads 0."""
    rec = _record(0, **{"trackstore.x": 0.001})
    assert runner.load_metric(name).read(_ctx([rec])) == 0.0


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_records_or_no_spans_read_none(name):
    m = runner.load_metric(name)
    assert m.read(_ctx([])) is None
    # a program that times its stages only
    assert m.read(_ctx([_record(0), _record(1)])) is None


def test_the_frontend_wait_reads_the_in_memory_sequences():
    disk = [dict(r, from_disk=True) for r in RECORDS]
    m = runner.load_metric("frontend_wait_ms_per_frame")
    assert m.read(_ctx(disk)) is None
    assert m.read(_ctx(RECORDS[:1] + disk[1:])) == pytest.approx(
        1e3 * 0.009 / 80)


def test_every_cell_reports_the_span_metrics():
    """Each is listed for all three cells, moves seq_fps and reads a
    program span."""
    bench = spec.load_benchmark()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in EXPECTED:
        m = metrics[name]
        assert m["source"] == "program_span" and m["moves"] == "seq_fps"
        assert m["workloads"] == cells
        for c in cells:
            assert name in [x["name"] for x in spec.load_cell(c).per_layer]
