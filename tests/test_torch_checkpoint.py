"""The port's frontend checkpoints: incremental segments in the JAX
package's format, exact resume, descriptors recomputed on demand, and
the config fingerprint, which differs from the JAX package's on purpose.

Everything runs in the port on the CPU, on a 12-frame 128x256 scene in
chunks of 4 (the configuration of tests/test_checkpoint_resume.py); the
JAX package only writes and reads checkpoint files here (no JAX
computation)."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_tpu.models import frontend as jfrontend
from slam_tpu_torch.config import (FeatureConfig, RansacConfig,
                                   RuntimeConfig, SlamConfig)
from slam_tpu_torch.models import frontend
from slam_tpu_torch.parallel import pipeline as ppipe
from slam_tpu_torch.utils import kitti, synthetic

torch.set_num_threads(2)

CFG = SlamConfig(
    features=FeatureConfig(max_kp=256, border=8),
    ransac=RansacConfig(num_hypotheses=96),
    runtime=RuntimeConfig(chunk_frames=4),
)
ARRAYS = ("xy", "valid", "links", "link_valid", "match_prev", "match_dist",
          "inlier_prev", "T_rel", "T_w2c", "num_inliers", "inlier_frac",
          "pose_ok")


@pytest.fixture(scope="module")
def seq():
    scene = synthetic.make_scene(seed=21, num_frames=12, num_landmarks=1500,
                                 hw=(128, 256), step_m=0.8)
    L, R = synthetic.render_sequence(scene)
    return scene, L, R


@pytest.fixture(scope="module")
def full(seq):
    scene, L, R = seq
    return frontend.run_frontend(L, R, scene.calib, CFG, device="cpu")


def run(seq, n=None, cfg=CFG, **kw):
    scene, L, R = seq
    n = L.shape[0] if n is None else n
    return frontend.run_frontend(L[:n], R[:n], scene.calib, cfg,
                                 device="cpu", **kw)


def assert_same(a, b):
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


def test_resume_equals_uninterrupted(seq, full, tmp_path):
    """Stopped after 8 frames, resumed: every array equal to an
    uninterrupted run's (T_w2c bit for bit: RANSAC is seeded by the
    chunk's position), descriptors too, the 8 resumed frames' recomputed
    from the images."""
    ck = tmp_path / "fe.npz"
    run(seq, 8, checkpoint_path=str(ck), checkpoint_every=4)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "fe.npz", "fe.seg0000.npz", "fe.seg0001.npz"]
    resumed = run(seq, checkpoint_path=str(ck), checkpoint_every=4,
                  resume=True)
    assert_same(resumed, full)
    assert torch.equal(resumed.desc.gather(np.arange(12)),
                       full.desc.gather(np.arange(12)))
    with np.load(str(ck)) as z:
        assert int(z["num_segments"]) == 3 and int(z["next_start"]) == 12


def test_checkpoint_holds_no_descriptors_and_the_reference_keys(seq, tmp_path):
    ck = tmp_path / "fe.npz"
    run(seq, 8, checkpoint_path=str(ck), checkpoint_every=4)
    with np.load(str(ck)) as z:
        assert set(z.files) == {
            "T_carry", "next_start", "num_segments", "cfg_fingerprint",
            "carry_desc", "carry_valid", "carry_links", "carry_link_valid",
            "carry_xy", "carry_last_T"}
    with np.load(str(tmp_path / "fe.seg0001.npz")) as z:
        assert set(z.files) == set(frontend._CKPT_KEYS) | {"T_chain",
                                                           "T_w2c"}
        assert z["xy"].shape[0] == 4


def test_legacy_checkpoint_migrates(seq, full, tmp_path):
    """A monolithic checkpoint (the layout before segments) is rewritten
    as segment 0 + meta before anything is appended, and a second resume
    still reproduces the run."""
    ck = tmp_path / "fe.npz"
    run(seq, 8, checkpoint_path=str(ck), checkpoint_every=4)
    outs, T_list, carry, T_carry, nxt = frontend.load_frontend_checkpoint(ck)
    blob = {k: np.concatenate([o[k] for o in outs])
            for k in frontend._CKPT_KEYS + ("T_chain",)}
    blob["T_w2c"] = np.concatenate(T_list)
    blob.update({f"carry_{k}": v for k, v in carry.items()})
    blob.update(T_carry=T_carry, next_start=np.int64(nxt))
    for p in tmp_path.glob("fe.seg*.npz"):
        p.unlink()
    np.savez_compressed(str(ck), **blob)
    resumed = run(seq, checkpoint_path=str(ck), checkpoint_every=4,
                  resume=True)
    assert_same(resumed, full)
    assert (tmp_path / "fe.seg0000.npz").exists()
    with np.load(str(ck)) as z:
        assert int(z["num_segments"]) == 2
    assert_same(run(seq, checkpoint_path=str(ck), resume=True), full)


def test_resume_refuses_a_changed_config(seq, tmp_path):
    """A changed result-determining field is refused; a runtime-only
    change is not."""
    ck = tmp_path / "fe.npz"
    run(seq, 8, checkpoint_path=str(ck), checkpoint_every=4)
    changed = dataclasses.replace(CFG, ransac=RansacConfig(num_hypotheses=64))
    with pytest.raises(RuntimeError, match="different feature"):
        run(seq, cfg=changed, checkpoint_path=str(ck), resume=True)
    relaxed = dataclasses.replace(CFG, runtime=RuntimeConfig(
        chunk_frames=4, compile_cache_dir=""))
    assert run(seq, cfg=relaxed, checkpoint_path=str(ck),
               resume=True).T_w2c.shape[0] == 12


def test_resume_refuses_a_changed_default(seq, tmp_path):
    """The deliberate difference from the JAX package: a field left at its
    default, where the default itself changed (a later release's
    RansacConfig), changes the port's fingerprint, so the resume is
    refused; the JAX package hashes only non-default fields, so its
    fingerprint stays the same and it would stitch frames computed under
    two thresholds."""
    @dataclasses.dataclass(frozen=True)
    class LaterRansac(RansacConfig):
        threshold_px: float = 2.5  # the default moved from 2.0

    later = dataclasses.replace(CFG, ransac=LaterRansac(num_hypotheses=96))
    assert jfrontend._frontend_fingerprint(later) == \
        jfrontend._frontend_fingerprint(CFG)
    assert frontend._frontend_fingerprint(later) != \
        frontend._frontend_fingerprint(CFG)
    ck = tmp_path / "fe.npz"
    run(seq, 8, checkpoint_path=str(ck), checkpoint_every=4)
    with pytest.raises(RuntimeError, match="different feature"):
        run(seq, cfg=later, checkpoint_path=str(ck), resume=True)


def test_resume_is_a_pure_load_when_complete(seq, full, tmp_path,
                                             monkeypatch):
    ck = tmp_path / "fe.npz"
    run(seq, checkpoint_path=str(ck))

    def no_compute(*a, **k):
        raise AssertionError("process_chunk ran on a complete checkpoint")

    monkeypatch.setattr(frontend, "process_chunk", no_compute)
    again = run(seq, checkpoint_path=str(ck), resume=True)
    assert_same(again, full)


def test_segment_sized_descriptor_recompute(seq, full, tmp_path,
                                            monkeypatch):
    """Segments of 8 frames over chunks of 4: a resumed run's descriptor
    chunks are recomputed at the chunk shape (the left and right images
    of 4 frames, as process_chunk detected them), one chunk per frame
    asked for, and equal the originals; the (F, K, D) shape holds before
    anything is recomputed."""
    ck = tmp_path / "fe.npz"
    run(seq, checkpoint_path=str(ck), checkpoint_every=8)
    resumed = run(seq, checkpoint_path=str(ck), checkpoint_every=8,
                  resume=True)
    shapes = []
    detect = frontend._detect_describe

    def recording(imgs, cfg):
        shapes.append(tuple(imgs.shape))
        return detect(imgs, cfg)

    monkeypatch.setattr(frontend, "_detect_describe", recording)
    assert resumed.desc.shape == (12, 256, 128) and len(resumed.desc) == 12
    assert shapes == [(8, 128, 256)] * 2  # (K, D) from segment 0
    assert torch.equal(resumed.desc[10], full.desc[10])
    assert len(shapes) == 3
    assert np.array_equal(resumed.desc.numpy(), full.desc.numpy())
    assert shapes == [(8, 128, 256)] * 3


def test_descriptor_bank_indexing(full):
    """The bank serves what loop closure and the analysis probes ask:
    an int (negative too), int arrays and tensors of any shape, lists,
    slices; shape, len, dtype, device, numpy."""
    bank = full.desc
    allf = bank.numpy()
    assert allf.shape == bank.shape == (12, 256, 128)
    assert allf.dtype == np.float16 and bank.dtype == torch.float16
    assert bank.device == torch.device("cpu") and len(bank) == 12
    idx = np.array([[3, 11], [0, 7]])
    np.testing.assert_array_equal(bank.gather(idx).numpy(), allf[idx])
    np.testing.assert_array_equal(bank[idx].numpy(), allf[idx])
    np.testing.assert_array_equal(bank[torch.tensor([5, 1])].numpy(),
                                  allf[[5, 1]])
    np.testing.assert_array_equal(bank[[2, 2]].numpy(), allf[[2, 2]])
    np.testing.assert_array_equal(bank[-1].numpy(), allf[-1])
    np.testing.assert_array_equal(bank[4:9].numpy(), allf[4:9])


def test_jax_checkpoints_load_and_their_resume_is_refused(seq, full,
                                                          tmp_path):
    """A checkpoint written by the JAX package's _save_checkpoint (here
    from the port's own outputs) loads through the port's loader with the
    same arrays, and the port's through the JAX package's; resuming the
    JAX package's is refused by the fingerprint, loudly."""
    rng = np.random.default_rng(0)
    outs = [{k: getattr(full, k)[s:s + 4] for k in frontend._CKPT_KEYS}
            for s in (0, 4)]
    for o in outs:
        o["T_chain"] = rng.random((4, 4, 4)).astype(np.float32)
    T_list = [full.T_w2c[0:4], full.T_w2c[4:8]]
    carry = {"desc": rng.random((256, 128)).astype(np.float32),
             "valid": full.valid[7], "links": full.links[7],
             "link_valid": full.link_valid[7], "xy": full.xy[7],
             "last_T": full.T_rel[7]}
    ck = tmp_path / "jax.npz"
    fp = jfrontend._frontend_fingerprint(CFG)
    jfrontend._save_checkpoint(ck, outs[:1], T_list[:1], carry,
                               full.T_w2c[3], 4, 0, fp)
    jfrontend._save_checkpoint(ck, outs[1:], T_list[1:], carry,
                               full.T_w2c[7], 8, 1, fp)
    got, T_got, carry_got, T_carry, nxt = frontend.load_frontend_checkpoint(
        ck)
    assert nxt == 8 and len(got) == 2
    np.testing.assert_array_equal(T_carry, full.T_w2c[7])
    for o, g in zip(outs, got):
        for k, v in o.items():
            np.testing.assert_array_equal(g[k], v, k)
    for a, b in zip(T_list, T_got):
        np.testing.assert_array_equal(a, b)
    for k, v in carry.items():
        np.testing.assert_array_equal(carry_got[k], v, k)
    with pytest.raises(RuntimeError, match="different feature"):
        run(seq, checkpoint_path=str(ck), resume=True)

    ours = tmp_path / "port.npz"
    run(seq, 8, checkpoint_path=str(ours), checkpoint_every=4)
    j_outs, j_T, j_carry, _, j_next = jfrontend.load_frontend_checkpoint(
        ours)
    p_outs, p_T, p_carry, _, _ = frontend.load_frontend_checkpoint(ours)
    assert j_next == 8
    for a, b in zip(j_outs, p_outs):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], k)
    for k in p_carry:
        np.testing.assert_array_equal(np.asarray(j_carry[k]), p_carry[k])


def test_png_and_memory_runs_resume_each_other(seq, tmp_path):
    """A run from PNG files and a run from the same decoded uint8 frames
    in memory write the same checkpoints: each resumes the other's, equal
    to an uninterrupted run."""
    scene, L, R = seq

    def u8(x):
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)

    paths = kitti.write_kitti_sequence(tmp_path / "kitti", "00", u8(L),
                                       u8(R), scene.calib)
    lp = sorted(paths.left_dir.glob("*.png"))
    rp = sorted(paths.right_dir.glob("*.png"))
    Lu = np.stack([kitti._imread_gray(p) for p in lp])
    Ru = np.stack([kitti._imread_gray(p) for p in rp])
    mem = frontend.run_frontend(Lu, Ru, scene.calib, CFG, device="cpu")

    def from_pngs(n, **kw):
        return ppipe.run_frontend_pipelined(lp[:n], rp[:n], (128, 256),
                                            scene.calib, CFG, device="cpu",
                                            **kw)

    def from_memory(n, **kw):
        return frontend.run_frontend(Lu[:n], Ru[:n], scene.calib, CFG,
                                     device="cpu", **kw)

    assert_same(from_pngs(12), mem)
    for first, second in ((from_pngs, from_memory),
                          (from_memory, from_pngs)):
        ck = tmp_path / f"{first.__name__}.npz"
        first(8, checkpoint_path=str(ck), checkpoint_every=4)
        resumed = second(12, checkpoint_path=str(ck), checkpoint_every=4,
                         resume=True)
        assert_same(resumed, mem)
        assert torch.equal(resumed.desc.gather(np.arange(8)),
                           mem.desc.gather(np.arange(8)))
