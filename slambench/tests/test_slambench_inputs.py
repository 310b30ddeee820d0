"""The benchmark's inputs: scenes per seed, the renderer on the device
against the numpy model, and the KITTI-layout PNGs."""

import zlib

import numpy as np
import pytest
import torch

from harness import pngs, scenes, spec, traffic


def test_scene_deterministic_per_seed():
    a = scenes.make_scene(2**33 + 7, 20, 500, "loop", loop_radius=25.0)
    b = scenes.make_scene(2**33 + 7, 20, 500, "loop", loop_radius=25.0)
    c = scenes.make_scene(2**33 + 8, 20, 500, "loop", loop_radius=25.0)
    for k in ("landmarks", "T_w2c", "render_points", "render_intens"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.landmarks, c.landmarks)
    # the trajectory is the mix's, whatever the seed
    assert np.array_equal(a.T_w2c, c.T_w2c)


def test_sequences_per_seed():
    mix = {"sequences_per_seed": 3, "input": "memory",
           "scene": {"trajectory": "clover", "num_frames": 6,
                     "num_landmarks": 300, "clover_radii": [10.0, 13.0],
                     "corridor_halfwidth": 6.0}}
    assert traffic.scene_seeds(mix, 5) == [15, 16, 17]
    a = traffic.make_sequences(mix, 5, "cpu", hw=(48, 160))
    b = traffic.make_sequences(mix, 5, "cpu", hw=(48, 160))
    assert [s.scene_seed for s in a] == [15, 16, 17]
    for x, y in zip(a, b):
        assert x.left.dtype == np.uint8 and x.left.shape == (6, 48, 160)
        assert np.array_equal(x.left, y.left)
        assert np.array_equal(x.right, y.right)
    assert not np.array_equal(a[0].left, a[1].left)


@pytest.mark.parametrize("trajectory", ["loop", "clover"])
def test_device_renderer_matches_numpy_model(trajectory):
    sc = scenes.make_scene(11, 5, 400, trajectory, hw=(64, 200),
                           loop_radius=25.0, clover_radii=(10.0, 13.0),
                           corridor_halfwidth=6.0)
    left, right = scenes.render_float(sc, "cpu", frames_per_call=2)
    for f in range(5):
        ln, rn = scenes.render_frame_np(sc, f)
        np.testing.assert_allclose(left[f].numpy(), ln, atol=2e-6)
        np.testing.assert_allclose(right[f].numpy(), rn, atol=2e-6)
    lu, _ = scenes.render_u8(sc, "cpu")
    mismatch = np.mean(lu != scenes.to_u8(np.stack(
        [scenes.render_frame_np(sc, f)[0] for f in range(5)])))
    assert mismatch < 1e-4


def _decode(data: bytes) -> np.ndarray:
    """A plain PNG reader for 8-bit gray with any row filter."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, W, H = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            W, H = (int.from_bytes(body[i:i + 4], "big") for i in (0, 4))
            assert body[8:10] == b"\x08\x00"
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W + 1)
    out = np.zeros((H, W), np.int64)
    for y in range(H):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int64)
        up = out[y - 1] if y else np.zeros(W, np.int64)
        for x in range(W):
            a = out[y, x - 1] if x else 0
            b = up[x]
            c = up[x - 1] if x else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, x] = (row[x] + pred) & 0xFF
    return out.astype(np.uint8)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 13), dtype=np.uint8)
    img[3:] = 17
    assert np.array_equal(_decode(pngs.encode_png(img)), img)
    sc = scenes.make_scene(3, 2, 200, "loop", hw=(24, 40))
    left, right = scenes.render_u8(sc, "cpu")
    lp, rp = pngs.write_sequence(tmp_path, "00", left, right, sc.calib,
                                 sc.T_w2c)
    assert len(lp) == len(rp) == 2
    for p, img in zip(lp + rp, list(left) + list(right)):
        assert np.array_equal(_decode(open(p, "rb").read()), img)
    calib = (tmp_path / "sequences/00/calib.txt").read_text().splitlines()
    assert [line[:3] for line in calib] == ["P0:", "P1:", "P2:", "P3:"]
    P1 = np.array(calib[1].split()[1:], float).reshape(3, 4)
    assert P1[0, 3] == pytest.approx(-sc.calib[0] * sc.calib[4], rel=1e-6)
    poses = np.loadtxt(tmp_path / "poses/00.txt").reshape(-1, 3, 4)
    T_c2w = np.linalg.inv(sc.T_w2c.astype(np.float64))
    np.testing.assert_allclose(poses, T_c2w[:, :3], atol=1e-9)


def test_traffic_files_load():
    for w in spec.load_benchmark()["workloads"]:
        mix = spec.load_cell(w["name"]).traffic
        assert mix["sequences_per_seed"] >= 1
        assert mix["scene"]["trajectory"] in ("loop", "clover")
        assert torch.tensor(mix["scene"]["num_frames"]) > 0
