"""Kernels B1 (detect_maps) and B2 (mutual_nearest) of the port.

On the CPU the wrappers run their plain versions, which are held here
against the JAX package's Pallas kernels in interpret mode. The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card and skip without one. JAX is imported inside the parity tests only,
so the ``cuda`` tests also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import matching

torch.set_num_threads(2)

WINDOW = (-192.0, -2.0, 4.0)


def t(x, dtype=None, device="cpu"):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def images(seed, F, H, W):
    """Blob images with a smooth background: Harris corners and every
    gradient orientation."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((F, H, W), np.float32)
    for f in range(F):
        img = 0.05 + 0.02 * np.sin(yy / 7.0 + f)
        for cy, cx, a in zip(rng.uniform(0, H, 60), rng.uniform(0, W, 60),
                             rng.uniform(0.3, 1.0, 60)):
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
        out[f] = np.clip(img, 0, 1)
    return out


def desc_sets(seed, B, Ka, Kb, D=128, noise=0.1):
    """B's rows are noisy copies of A's rows; B's positions are A's
    shifted as a stereo pair would be."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ka, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    src = rng.integers(0, Ka, (B, Kb))
    b = np.take_along_axis(a, src[..., None], 1) + noise * rng.normal(
        size=(B, Kb, D)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    xa = rng.uniform([0, 0], [1241, 376], (B, Ka, 2)).astype(np.float32)
    xb = (np.take_along_axis(xa, src[..., None], 1)
          + rng.uniform([-150, -3], [-1, 3], (B, Kb, 2))).astype(np.float32)
    va = rng.uniform(size=(B, Ka)) > 0.05
    vb = rng.uniform(size=(B, Kb)) > 0.05
    return a, b.astype(np.float32), va, vb, xa, xb


def decided(base, pen, dim):
    """Entries whose best and second-best differ by more than 1e-5 (and
    whose best is a real distance): the argmin there is not a tie."""
    d = base + pen
    top2 = torch.topk(d, 2, dim=dim, largest=False).values
    first, second = top2.select(dim, 0), top2.select(dim, 1)
    return ((second - first) > 1e-5) & (first < 1e29)


def near_tie(resp):
    """Pixels whose response ties the runner-up of their 5x5 window
    within 1e-6 of max |resp|: there a last-bit difference may flip the
    NMS decision either way."""
    r = torch.as_tensor(resp)
    pad = torch.nn.functional.pad(r[:, None], (2, 2, 2, 2),
                                  value=-float("inf"))
    win = pad.unfold(2, 5, 1).unfold(3, 5, 1).reshape(*r.shape, 25).clone()
    win[..., 12] = -float("inf")
    runner = win.max(dim=-1).values
    return ((r - runner).abs() <= 1e-6 * float(r.abs().max())).numpy()


# ---------------------------------------------------------------------------
# plain versions against the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_b1_plain_matches_pallas_interior():
    """resp and maps within 1e-5 of their max, and the same NMS pattern,
    away from near-ties, on the interior >= 8 px from the edge (the Pallas
    kernel's zero canvas differs from the plain version's per-stage zero
    padding within 4-6 px of the edge)."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    imgs = images(0, 2, 70, 120)
    r_j, n_j, m_j = (np.asarray(x) for x in pk.detect_maps_batch(
        jnp.asarray(imgs), interpret=True))
    r_t, n_t, m_t = (x.numpy() for x in ck.detect_maps(t(imgs)))
    inner = (slice(None), slice(8, -8), slice(8, -8))
    np.testing.assert_allclose(r_t[inner], r_j[inner],
                               atol=1e-5 * np.abs(r_j).max())
    np.testing.assert_allclose(m_t[:, :, 8:-8, 8:-8], m_j[:, :, 8:-8, 8:-8],
                               atol=1e-5 * np.abs(m_j).max())
    mism = np.isfinite(n_t) != np.isfinite(n_j)
    assert not (mism & ~near_tie(r_t))[inner].any()


@pytest.mark.parametrize("window", [None, WINDOW])
def test_b2_plain_matches_pallas(window):
    """Row and column distances within 1e-5 (summation order); indices
    equal wherever the best and second-best differ by more than 1e-5."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    a, b, va, vb, xa, xb = desc_sets(1, 1, 1024, 1024)
    rd_j, ri_j, cd_j, ci_j = (np.asarray(x) for x in pk.mutual_nearest(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(va[0]),
        jnp.asarray(vb[0]), interpret=True, xy_a=jnp.asarray(xa[0]),
        xy_b=jnp.asarray(xb[0]), window=window))
    rd, ri, cd, ci = ck.mutual_nearest(t(a), t(b), t(va), t(vb), t(xa),
                                       t(xb), window)
    base = ck.window_distances(t(a), t(b), t(xa), t(xb), window)
    row_ok = decided(base, torch.where(t(vb), 0.0, ck.BIG)[:, None, :], 2)[0]
    col_ok = decided(base, torch.where(t(va), 0.0, ck.BIG)[:, :, None], 1)[0]
    assert row_ok.sum() > 500 and col_ok.sum() > 500
    np.testing.assert_allclose(rd[0].numpy()[row_ok], rd_j[row_ok],
                               atol=1e-5)
    np.testing.assert_array_equal(ri[0].numpy()[row_ok], ri_j[row_ok])
    np.testing.assert_allclose(cd[0].numpy()[col_ok], cd_j[col_ok],
                               atol=1e-5)
    np.testing.assert_array_equal(ci[0].numpy()[col_ok], ci_j[col_ok])


def test_mutual_match_matches_pallas_wrapper():
    """The port's cross-checked matches equal the JAX package's one-pass
    kernel's on the same descriptors (no ties among random vectors)."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    a, b, va, vb, xa, xb = desc_sets(2, 1, 1024, 1024)
    out_j = pk.mutual_match_pallas(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(va[0]),
        jnp.asarray(vb[0]), max_dist=0.6, interpret=True,
        xy_a=jnp.asarray(xa[0]), xy_b=jnp.asarray(xb[0]), window=WINDOW)
    out_t = matching.mutual_match(t(a), t(b), t(va), t(vb), max_dist=0.6,
                                  xy_a=t(xa), xy_b=t(xb), window=WINDOW)
    np.testing.assert_array_equal(out_t["matched"][0].numpy(),
                                  np.asarray(out_j["matched"]))
    np.testing.assert_array_equal(out_t["target_idx"][0].numpy(),
                                  np.asarray(out_j["target_idx"]))
    assert int(out_t["matched"].sum()) > 100


# ---------------------------------------------------------------------------
# wrappers on the CPU: dispatch, counters, input checks
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    ck.reset_counters()
    ck.detect_maps(t(images(3, 1, 40, 50)))
    a, b, va, vb, xa, xb = desc_sets(3, 2, 30, 40)
    ck.mutual_nearest(t(a), t(b), t(va), t(vb))
    assert ck.PLAIN_CALLS == {"detect_maps": 1, "mutual_nearest": 1}
    assert ck.LAUNCHES == {"detect_maps": 0, "mutual_nearest": 0}


@pytest.mark.parametrize("case", ["ndim", "dtype", "device"])
def test_detect_maps_rejects_bad_input(case):
    x = {"ndim": torch.zeros((4, 5)),
         "dtype": torch.zeros((1, 8, 8), dtype=torch.float64),
         "device": torch.zeros((1, 8, 8), device="meta")}[case]
    with pytest.raises(ValueError):
        ck.detect_maps(x)


@pytest.mark.parametrize("case", ["shape", "mask", "window", "device"])
def test_mutual_nearest_rejects_bad_input(case):
    a, b, va, vb, xa, xb = (t(x) for x in desc_sets(4, 2, 10, 12))
    args = {"shape": (a, b[:, :, :64], va, vb),
            "mask": (a, b, va.float(), vb),
            "window": (a, b, va, vb, None, None, WINDOW),
            "device": (a.to("meta"), b.to("meta"), va.to("meta"),
                       vb.to("meta"))}[case]
    with pytest.raises(ValueError):
        ck.mutual_nearest(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.build()


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 333), (3, 64, 64), (1, 37, 41)])
def test_cuda_detect_maps_matches_plain(cuda, shape):
    """Over the whole image (the kernel follows the plain version's edge
    semantics): resp within 1e-5 of max |resp|, maps within 1e-5 of max
    |maps| for all but 0.1% of values (8-bin boundary flips), NMS equal
    away from ties."""
    x = t(images(5, *shape), device=cuda)
    ck.reset_counters()
    r_k, n_k, m_k = ck.detect_maps(x)
    assert ck.LAUNCHES["detect_maps"] == 1
    r_p, n_p, m_p = ck.detect_maps_plain(x)
    torch.cuda.synchronize()
    scale = float(r_p.abs().max())
    assert float((r_k - r_p).abs().max()) <= 1e-5 * scale
    m_bad = ((m_k - m_p).abs() > 1e-5 * float(m_p.abs().max())).float()
    assert float(m_bad.mean()) <= 1e-3
    mism = (torch.isfinite(n_k) != torch.isfinite(n_p)).cpu().numpy()
    assert not (mism & ~near_tie(r_p.cpu())).any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("sizes", [(4, 2048, 2048, 128), (3, 1500, 1777, 128),
                                   (2, 1, 65, 128), (1, 130, 3, 128),
                                   (2, 300, 200, 32), (2, 200, 300, 256)])
def test_cuda_mutual_nearest_matches_plain(cuda, window, sizes):
    """Distances within 1e-5, indices equal where not tied, for ragged
    sizes and descriptor widths 32 to 256."""
    a, b, va, vb, xa, xb = (t(x, device=cuda) for x in desc_sets(6, *sizes))
    rd, ri, cd, ci = ck.mutual_nearest(a, b, va, vb, xa, xb, window)
    rd_p, ri_p, cd_p, ci_p = ck.mutual_nearest_plain(a, b, va, vb, xa, xb,
                                                     window)
    torch.cuda.synchronize()
    assert float((rd - rd_p).abs().max()) <= 1e-5
    assert float((cd - cd_p).abs().max()) <= 1e-5
    base = ck.window_distances(a, b, xa, xb, window)
    if sizes[2] > 1:
        row_ok = decided(base, torch.where(vb, 0.0, ck.BIG)[:, None, :], 2)
        assert torch.equal(ri[row_ok], ri_p[row_ok])
    if sizes[1] > 1:
        col_ok = decided(base, torch.where(va, 0.0, ck.BIG)[:, :, None], 1)
        assert torch.equal(ci[col_ok], ci_p[col_ok])


@pytest.mark.cuda
def test_cuda_wrappers_reject_non_contiguous(cuda):
    x = torch.rand((2, 40, 60), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        ck.detect_maps(x)
    a = torch.rand((1, 128, 8), device=cuda).transpose(1, 2)
    v = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        ck.mutual_nearest(a, a, v, v)


@pytest.mark.cuda
def test_cuda_slice_runs_through_the_kernels(cuda):
    """A small scene through run_pipeline on the card: both kernels
    launched, no plain version run."""
    from slam_tpu.config import (BundleConfig, FeatureConfig,
                                 KeyframeConfig, RuntimeConfig, SlamConfig)
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.utils import synthetic

    scene = synthetic.make_scene(seed=2, num_frames=12, num_landmarks=3000,
                                 hw=(128, 256))
    L, R = synthetic.render_sequence(scene)
    cfg = SlamConfig(features=FeatureConfig(max_kp=512),
                     runtime=RuntimeConfig(chunk_frames=6),
                     keyframes=KeyframeConfig(min_gap=2, max_gap=6),
                     bundle=BundleConfig(max_poses=8, max_landmarks=256,
                                         max_obs=1024, lm_iters=5))
    ck.reset_counters()
    res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                run_loop_closure=False, device=cuda)
    assert ck.LAUNCHES["detect_maps"] == 2
    assert ck.LAUNCHES["mutual_nearest"] == 4
    assert ck.PLAIN_CALLS == {"detect_maps": 0, "mutual_nearest": 0}
    assert np.isfinite(res.T_frontend).all()
