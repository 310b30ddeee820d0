"""The port's analysis suite against the JAX package's, on identical
inputs: one JAX ``run_pipeline`` on a rendered loop with a closure,
converted to the port's result with ``convert.pipeline_result``, and both
packages' ``run_analysis`` on it.

Everything but two calls is the same host numpy code on the same arrays,
so the numbers of ``analysis.json`` agree to float64 rounding (1e-5
relative is the bound). The two device calls are the uncertainty's
marginal log-determinants and the loop-match probe's matching (the same
bf16 products: the same matches). The log-determinants come from a dense
float32 inverse of the pose graph's Hessian in each package: on the
loop-closed graph they agree to ~1e-6, but the pre-closure chain's end is
ill-conditioned, and there each package's float32 value is off the
float64 evaluation of the same function by ~0.1 nats, in opposite
directions (measured 0.086 and 0.116, 0.20 apart). So each is held
within 0.15 nats of the float64 value, and the two within 0.05 nats on
the loop-closed graph and 0.25 on the pre-closure one."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from slam_tpu import pipeline as jpipe
from slam_tpu.ops import matching as jmatching
from slam_tpu.utils import analysis as janalysis
from slam_tpu.utils import synthetic as jsynth
from slam_tpu_torch import convert
from slam_tpu_torch.ops import pose_graph as pg_ops
from slam_tpu_torch.utils import analysis

from tests.test_torch_slice import CFG, jax_config

torch.set_num_threads(2)

PORT_ONLY = {"artifacts", "plots", "loop_match"}


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis")
    scene = jsynth.make_scene(jax.random.PRNGKey(3), num_frames=24,
                              num_landmarks=2500, trajectory="loop",
                              hw=(128, 256), loop_radius=6.0)
    L, R = jsynth.render_sequence(scene)
    T_gt = np.asarray(scene.T_w2c)
    res_j = jpipe.run_pipeline(L, R, np.asarray(scene.calib),
                               jax_config(CFG), verbose=False)
    res_t = convert.pipeline_result(res_j, device="cpu")
    rep_j = janalysis.run_analysis(res_j, T_gt, root / "jax", images_left=L)
    rep_t = analysis.run_analysis(res_t, T_gt, root / "port", images_left=L)
    return {"root": root, "L": L, "T_gt": T_gt, "jax": res_j, "port": res_t,
            "rep_j": rep_j, "rep_t": rep_t}


def numbers(d, prefix=""):
    """Flattened {path: number} of a report (port-only keys left out)."""
    out = {}
    for k, v in d.items():
        if not prefix and k in PORT_ONLY:
            continue
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(numbers(v, key))
        else:
            out[key] = v
    return out


def test_same_artifact_files(suites):
    """The same file names in both output directories: every ARTIFACTS
    entry (with closures, abs_poseGraph_LC_* too), loops.png,
    disparity_hist.png, worst_factor.png, the closure's loop_match PNG
    and analysis.json."""
    assert suites["port"].closures
    names_j = sorted(p.name for p in (suites["root"] / "jax").iterdir())
    names_t = sorted(p.name for p in (suites["root"] / "port").iterdir())
    assert names_t == names_j
    assert analysis.ARTIFACTS == janalysis.ARTIFACTS
    for a in analysis.ARTIFACTS:
        assert f"{a}.png" in names_t
    c = suites["port"].closures[0]
    assert {"loops.png", "disparity_hist.png", "worst_factor.png",
            f"loop_match_{c.frame_i}_{c.frame_j}.png",
            "analysis.json"} <= set(names_t)


def final_logdet_f64(pg) -> float:
    """log10 det of the last node's location covariance, from the port's
    marginal_logdets evaluated in float64."""
    args = [torch.as_tensor(np.asarray(a)) for a in (
        pg.nodes, pg.e_i, pg.e_j, pg.Z, pg.sqrt_info)]
    args = [a.double() if a.is_floating_point() else a.long() for a in args]
    return float(pg_ops.marginal_logdets(*args)[0][-1]) / np.log(10.0)


def test_analysis_numbers_equal_jax(suites):
    """Every number of the JAX package's analysis.json in the port's,
    within 1e-5 relative; the uncertainty's log10 determinants within 0.15
    nats of their float64 evaluation and 0.05 (loop-closed graph) or 0.25
    (pre-closure chain) nats of each other (see the module docstring); the
    written files equal the returned reports."""
    nj = numbers(json.loads((suites["root"] / "jax" / "analysis.json")
                            .read_text()))
    nt = numbers(json.loads((suites["root"] / "port" / "analysis.json")
                            .read_text()))
    assert set(nt) == set(nj)
    assert nt == numbers(json.loads(json.dumps(suites["rep_t"],
                                               default=float)))
    for k, vj in nj.items():
        vt = nt[k]
        if vj is None or isinstance(vj, str):
            assert vt == vj, k
        elif k.startswith("/uncertainty/"):
            g = (suites["port"].pose_graph if k.endswith("_lc")
                 else suites["port"].pose_graph_pre_lc)
            ref = final_logdet_f64(g)
            nats = [abs(v - ref) * np.log(10.0) for v in (vt, vj)]
            assert max(nats) < 0.15, (k, vt, vj, ref)
            limit = 0.05 if k.endswith("_lc") else 0.25
            assert abs(vt - vj) * np.log(10.0) < limit, (k, vt, vj)
        else:
            assert vt == pytest.approx(vj, rel=1e-5, abs=1e-9), (k, vt, vj)


def test_artifact_summaries(suites):
    """analysis.json lists every artifact with its file and the summary of
    each curve it draws (here every curve is non-empty and finite)."""
    rep = suites["rep_t"]
    assert rep["plots"].startswith("drawn")
    for a in analysis.ARTIFACTS:
        entry = rep["artifacts"][a]
        assert entry["file"] == f"{a}.png"
        assert entry["series"] and all(s["n"] > 0 and np.isfinite(s["mean"])
                                       for s in entry["series"].values()), a
    errs = suites["rep_t"]["artifacts"]["abs_PnP_locations"]["series"]
    assert errs["L2"]["mean"] == pytest.approx(
        suites["rep_t"]["abs_error"]["PnP"]["mean_l2"], rel=1e-6)


def test_loop_match_probe_equals_jax_matching(suites):
    """The probe's matches of every closure equal the JAX package's
    mutual_match on the same descriptors; the count is in the report."""
    res_j, res_t = suites["jax"], suites["port"]
    for c in res_t.closures:
        src, tgt = analysis.loop_matches(res_t, c)
        fe = res_j.frontend
        m = jmatching.mutual_match(
            np.asarray(fe.desc[c.frame_i], np.float32),
            np.asarray(fe.desc[c.frame_j], np.float32),
            np.asarray(fe.valid[c.frame_i]), np.asarray(fe.valid[c.frame_j]))
        src_j = np.nonzero(np.asarray(m["matched"]))[0]
        np.testing.assert_array_equal(src, src_j)
        np.testing.assert_array_equal(tgt,
                                      np.asarray(m["target_idx"])[src_j])
        assert suites["rep_t"]["loop_match"][
            f"{c.frame_i}_{c.frame_j}"] == len(src) > 0


def test_without_matplotlib(suites, tmp_path, monkeypatch):
    """With matplotlib hidden: every number written, the same as with it,
    no PNG, and the note under "plots" (also in the log)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rep = analysis.run_analysis(suites["port"], suites["T_gt"], tmp_path,
                                images_left=suites["L"])
    assert rep["plots"] == analysis.NO_MATPLOTLIB
    assert sorted(p.name for p in tmp_path.iterdir()) == ["analysis.json"]
    written = json.loads((tmp_path / "analysis.json").read_text())
    assert written["plots"] == analysis.NO_MATPLOTLIB
    assert numbers(written) == numbers(json.loads(
        (suites["root"] / "port" / "analysis.json").read_text()))
    assert all(e["file"] is None and e["series"]
               for k, e in written["artifacts"].items()
               if k in analysis.ARTIFACTS)
    assert written["loop_match"] == suites["rep_t"]["loop_match"]


def test_visualize_track(suites, tmp_path):
    """The track probe draws track_<id>.png as the JAX package's does."""
    db = suites["port"].db
    tid = int(np.argmax(db.track_lengths()))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert analysis.visualize_track(tmp_path / "port", db, suites["L"], tid)
    janalysis.visualize_track(tmp_path / "jax", suites["jax"].db, suites["L"],
                              tid)
    assert [p.name for p in (tmp_path / "port").iterdir()] == [
        p.name for p in (tmp_path / "jax").iterdir()] == [f"track_{tid}.png"]
