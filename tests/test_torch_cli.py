"""The port's entry points: ``python -m slam_tpu_torch`` against the JAX
package's CLI on one KITTI-layout directory, its synthetic mode, its
refusal to run without a card unless asked for the CPU, and the
resumable reference-scale run (``python -m slam_tpu_torch.scale_run``)
at a tiny size.

Both CLIs read the same PNG files under the same config; their RANSAC
streams differ (jax.random vs torch.Generator), so the reports are held
to the bounds of tests/test_torch_disk.py: the same closures and every
stage's ATE under 0.5 m in both."""

import json

import numpy as np
import pytest
import torch

from slam_tpu.__main__ import main as jax_main
from slam_tpu_torch import scale_run
from slam_tpu_torch.__main__ import main as port_main
from slam_tpu_torch.models import loop_closure
from slam_tpu_torch.runtime import graphs
from slam_tpu_torch.utils import analysis, kitti, synthetic

from tests.test_torch_disk import u8
from tests.test_torch_slice import CFG

torch.set_num_threads(2)

STAGES = ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = synthetic.make_scene(seed=3, num_frames=24, num_landmarks=2500,
                                 trajectory="loop", hw=(128, 256),
                                 loop_radius=6.0)
    L, R = synthetic.render_sequence(scene)
    kitti.write_kitti_sequence(root / "kitti", "00", u8(L), u8(R),
                               scene.calib, scene.T_w2c)
    CFG.save(root / "cfg.json")
    common = ["--kitti-root", str(root / "kitti"), "--seq", "00", "--cpu",
              "--config", str(root / "cfg.json")]
    assert port_main(common + ["--out", str(root / "port")]) == 0
    assert jax_main(common + ["--out", str(root / "jax"),
                              "--no-analysis"]) == 0
    return root


def closures(out):
    return [(c.frame_i, c.frame_j) for c in loop_closure.load_closures(
        out / "00" / "cache" / "closures.npz")]


def test_cli_matches_the_jax_cli(cli_runs):
    """The same outputs (config.json, reports.json, per sequence cache/,
    report.json), the same closures, every stage's ATE under 0.5 m in
    both, and the port's analysis in graphs/ with every artifact."""
    port, jax_out = cli_runs / "port", cli_runs / "jax"
    for out in (port, jax_out):
        assert (out / "config.json").read_text() == (
            cli_runs / "cfg.json").read_text()
        assert set(json.loads((out / "reports.json").read_text())) == {"00"}
    rp = json.loads((port / "00" / "report.json").read_text())
    rj = json.loads((jax_out / "00" / "report.json").read_text())
    assert closures(port) == closures(jax_out) and closures(port)
    assert rp["num_closures"] == rj["num_closures"] == len(closures(port))
    for k in STAGES:
        assert rp[k]["ate_rmse_m"] < 0.5 and rj[k]["ate_rmse_m"] < 0.5, k
    an = json.loads((port / "00" / "graphs" / "analysis.json").read_text())
    assert an == json.loads(json.dumps(rp["analysis"]))
    for a in analysis.ARTIFACTS:
        assert (port / "00" / "graphs" / f"{a}.png").exists(), a
    c = closures(port)[0]
    assert (port / "00" / "graphs" / f"loop_match_{c[0]}_{c[1]}.png").exists()


def test_cli_eager_load_agrees_with_prefetch(cli_runs, tmp_path):
    """--no-prefetch (the images loaded into memory as float32 x / 255)
    agrees with the default path-list run (uint8 through the native
    prefetcher, x * (1 / 255f) on the device): the last bit of a pixel
    differs, so each stage's ATE within 1 mm (8e-5 m seen) and the same
    pose failures."""
    assert port_main(["--kitti-root", str(cli_runs / "kitti"), "--seq", "00",
                      "--cpu", "--config", str(cli_runs / "cfg.json"),
                      "--no-prefetch", "--no-analysis", "--no-loop-closure",
                      "--out", str(tmp_path)]) == 0
    a = json.loads((tmp_path / "00" / "report.json").read_text())
    b = json.loads((cli_runs / "port" / "00" / "report.json").read_text())
    for k in STAGES[:3]:
        assert abs(a[k]["ate_rmse_m"] - b[k]["ate_rmse_m"]) < 1e-3, k
    assert a["num_pose_failures"] == b["num_pose_failures"]


def test_cli_synthetic_straight(tmp_path):
    """--synthetic straight --frames 8 --no-analysis: rc 0, one report
    with every pre-closure stage's ATE, and the span counts beside the
    timings (each key of ``timings_s`` entered, every stage once)."""
    assert port_main(["--synthetic", "straight", "--frames", "8",
                      "--no-analysis", "--cpu", "--out", str(tmp_path)]) == 0
    rep = json.loads((tmp_path / "reports.json").read_text())["synthetic"]
    assert np.isfinite([rep[k]["ate_rmse_m"] for k in STAGES[:3]]).all()
    spans = rep["counts"]["spans"]
    assert set(spans) == set(rep["timings_s"]) and spans["frontend"] == 1
    assert set(rep["counts"]["graphs"]) == set(graphs.TOTALS)
    assert not (tmp_path / "synthetic" / "graphs").exists()


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """Without --cpu and without a card the CLI raises, naming the card,
    before it writes anything; it does not run on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_main(["--synthetic", "loop", "--frames", "8", "--out",
                   str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        scale_run.main(["--frames", "8", "--out", str(tmp_path / "scale")])


def test_scale_run_resumes_every_stage(tmp_path):
    """The scale run at a tiny size on the CPU: every stage runs and
    leaves its artifact; a second run loads every stage (no stage runs,
    the same timings and ATEs); --force bundles recomputes bundles and
    every later stage and leaves the earlier artifacts untouched."""
    # a two-lap clover of 66 m, so that frames track at this size
    args = ["--cpu", "--frames", "40", "--hw", "96", "320", "--landmarks",
            "3000", "--radii", "5", "5.5", "--corridor", "2.5", "--out",
            str(tmp_path)]
    assert scale_run.main(args) == 0
    first = json.loads((tmp_path / "report.json").read_text())
    assert first["stages_run"] == scale_run.STAGES
    assert set(first["timings_s"]) == set(scale_run.STAGES)
    for name in ("images_L.npy", "images_R.npy", "frontend_ckpt.npz",
                 "trackstore.npz", "bundles.npz", "pose_graph.npz",
                 "pose_graph_lc.npz", "closures.json",
                 "graphs/analysis.json"):
        assert (tmp_path / name).exists(), name
    assert {"ransac_budget", "revisits", "num_keyframes",
            "analysis"} <= set(first)
    images = np.load(tmp_path / "images_L.npy")
    assert images.shape == (40, 96, 320) and images.dtype == np.uint8
    mtime = (tmp_path / "trackstore.npz").stat().st_mtime_ns

    assert scale_run.main(args) == 0
    again = json.loads((tmp_path / "report.json").read_text())
    assert again["stages_run"] == []
    assert again["timings_s"] == first["timings_s"]
    assert [again[k]["ate_rmse_m"] for k in STAGES[:3]] == [
        first[k]["ate_rmse_m"] for k in STAGES[:3]]

    assert scale_run.main(args + ["--force", "bundles"]) == 0
    forced = json.loads((tmp_path / "report.json").read_text())
    assert forced["stages_run"] == ["bundles", "posegraph", "loop",
                                    "analysis"]
    assert (tmp_path / "trackstore.npz").stat().st_mtime_ns == mtime
    history = (tmp_path / "report_history.jsonl").read_text().splitlines()
    assert len(history) == 3
