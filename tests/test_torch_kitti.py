"""The port's KITTI IO (``slam_tpu_torch/utils/kitti.py``) against the JAX
package's, and the port's native runtime (``slam_tpu_torch/runtime``:
its own zlib PNG decoder, the stereo prefetcher and track chaining)
against the JAX package's libpng runtime, cv2 and the numpy chaining.

KITTI IO is numpy on both sides, so every value is compared exactly."""

import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slam_tpu import runtime as jruntime
from slam_tpu.utils import kitti as jkitti
from slam_tpu_torch import runtime
from slam_tpu_torch.models.trackstore import NO_ID, chain_tracks
from slam_tpu_torch.utils import kitti

from tests.test_kitti_io import fake_kitti, real_format_kitti  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def both_paths(p):
    """The same KittiPaths in either package."""
    return (kitti.KittiPaths(root=p.root, sequence=p.sequence),
            jkitti.KittiPaths(root=p.root, sequence=p.sequence))


def test_paths_and_readers_equal_jax(fake_kitti):
    pt, pj = both_paths(fake_kitti)
    for name in ("seq_dir", "left_dir", "right_dir", "calib_file",
                 "poses_file"):
        assert getattr(pt, name) == getattr(pj, name)
    assert pt.exists() and pj.exists()
    assert kitti.num_frames(pt) == jkitti.num_frames(pj) == 3
    for a, b in zip(kitti.read_calibration(pt), jkitti.read_calibration(pj)):
        same(a, b)
    same(kitti.calib_vector(pt), jkitti.calib_vector(pj))
    same(kitti.read_ground_truth(pt), jkitti.read_ground_truth(pj))
    same(kitti.read_kth_camera(pt, 2), jkitti.read_kth_camera(pj, 2))


def test_real_format_equal_jax(real_format_kitti):
    """The genuine sequence-00 calibration (P0..P3 and a Tr line) and
    poses files parse to the JAX package's values."""
    pt, pj = both_paths(real_format_kitti)
    for a, b in zip(kitti.read_calibration(pt), jkitti.read_calibration(pj)):
        same(a, b)
    same(kitti.calib_vector(pt), jkitti.calib_vector(pj))
    same(kitti.read_ground_truth(pt), jkitti.read_ground_truth(pj))
    bad = real_format_kitti.calib_file
    bad.write_text("P2: " + " ".join(["1"] * 12) + "\n")
    for mod, p in ((kitti, pt), (jkitti, pj)):
        with pytest.raises(ValueError, match="P0/P1"):
            mod.read_calibration(p)


def test_image_readers_equal_jax(fake_kitti):
    pt, pj = both_paths(fake_kitti)
    for a, b in zip(kitti.read_pair(pt, 1), jkitti.read_pair(pj, 1)):
        same(a, b)
    for a, b in zip(kitti.read_batch(pt, 0, 3), jkitti.read_batch(pj, 0, 3)):
        same(a, b)
    for bucket in (None, (48, 64)):
        for a, b in zip(kitti.load_sequence(pt, limit=2, bucket_hw=bucket),
                        jkitti.load_sequence(pj, limit=2, bucket_hw=bucket)):
            same(a, b)
    paths = sorted(pt.left_dir.glob("*.png"))
    lt = kitti.LazyImageSequence(paths, (48, 64))
    lj = jkitti.LazyImageSequence(paths, (48, 64))
    assert lt.shape == lj.shape and len(lt) == len(lj) == 3
    same(lt[2], lj[2])
    same(lt[1, 5:9, 50:64], lj[1, 5:9, 50:64])
    same(kitti._imread_gray(paths[0]), jkitti._imread_gray(paths[0]))


def test_bucket_and_padding_equal_jax():
    shapes = [(376, 1241), (375, 1242), (370, 1226)]
    assert kitti.bucket_for(shapes) == jkitti.bucket_for(shapes) == (376,
                                                                     1248)
    assert kitti.bucket_for(shapes, 16) == jkitti.bucket_for(shapes, 16)
    imgs = np.random.default_rng(0).random((2, 37, 53)).astype(np.float32)
    same(kitti.pad_to_bucket(imgs, (40, 56)),
         jkitti.pad_to_bucket(imgs, (40, 56)))
    assert kitti.pad_to_bucket(imgs, (37, 53)) is imgs
    with pytest.raises(ValueError):
        kitti.pad_to_bucket(imgs, (36, 56))


def test_write_kitti_sequence_equal_jax(tmp_path):
    """Both writers give the same files: the same PNG pixels, the same
    calib.txt and poses text."""
    rng = np.random.default_rng(1)
    L = (rng.random((3, 30, 44)) * 255).astype(np.uint8)
    R = (rng.random((3, 30, 44)) * 255).astype(np.uint8)
    calib = np.array([350.0, 350.0, 22.0, 15.0, 0.54], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, 2, 3] = -np.arange(3)
    pt = kitti.write_kitti_sequence(tmp_path / "t", "05", L, R, calib, T)
    pj = jkitti.write_kitti_sequence(tmp_path / "j", "05", L, R, calib, T)
    assert pt.calib_file.read_text() == pj.calib_file.read_text()
    assert pt.poses_file.read_text() == pj.poses_file.read_text()
    for i in range(3):
        name = f"{i:06d}.png"
        same(kitti._imread_gray(pt.left_dir / name), L[i])
        same(kitti._imread_gray(pt.right_dir / name),
             jkitti._imread_gray(pj.right_dir / name))
    same(kitti.calib_vector(pt), calib)


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    assert runtime.available(), runtime.build_error
    assert jruntime._load()
    return runtime


def _images(tmp_path):
    """PNG files of every kind the decoder reads, written by cv2 and
    PIL: 8-bit gray (noise and a smooth ramp), RGB, RGBA, 16-bit gray,
    a palette image and a 1-bit image."""
    rng = np.random.default_rng(2)
    out = {}
    for name, img in (
            ("gray", (rng.random((37, 53)) * 255).astype(np.uint8)),
            ("ramp", (np.add.outer(np.arange(40), 3 * np.arange(61))
                      % 256).astype(np.uint8)),
            ("rgb", (rng.random((20, 30, 3)) * 255).astype(np.uint8)),
            ("rgba", (rng.random((20, 30, 4)) * 255).astype(np.uint8)),
            ("gray16", (rng.random((20, 30)) * 65535).astype(np.uint16))):
        out[name] = tmp_path / f"{name}.png"
        cv2.imwrite(str(out[name]), img)
    gray = Image.fromarray((rng.random((25, 33)) * 255).astype(np.uint8))
    out["palette"] = tmp_path / "palette.png"
    gray.convert("RGB").convert("P").save(out["palette"])
    out["bits1"] = tmp_path / "bits1.png"
    gray.convert("1").save(out["bits1"])
    return out


def test_native_decode_equals_jax_runtime(native, tmp_path):
    """Every kind of PNG decodes to the JAX package's libpng values
    exactly, padded or not, and the uint8 decode is the same image."""
    for name, p in _images(tmp_path).items():
        a, b = native.load_png_gray(p), jruntime.load_png_gray(p)
        same(a, b)
        hw = (a.shape[0] + 5, a.shape[1] + 7)
        same(native.load_png_gray_padded(p, hw),
             jruntime.load_png_gray_padded(p, hw))
        u = native.load_png_u8_padded(p, hw)
        same(u * np.float32(1.0 / 255.0), native.load_png_gray_padded(p, hw))
        if name in ("gray", "ramp", "bits1"):  # cv2 weighs colour otherwise
            same(u[:a.shape[0], :a.shape[1]], kitti._imread_gray(p))


def _png(img: np.ndarray, filters) -> bytes:
    """An 8-bit grayscale PNG of ``img`` whose row y uses row filter
    ``filters[y % len(filters)]`` (0 none, 1 sub, 2 up, 3 average,
    4 Paeth)."""
    H, W = img.shape
    x = img.astype(np.int32)
    raw = bytearray()
    for y in range(H):
        ft = filters[y % len(filters)]
        cur = x[y]
        up = x[y - 1] if y else np.zeros(W, np.int32)
        left = np.concatenate([[0], cur[:-1]])
        ul = np.concatenate([[0], up[:-1]])
        if ft == 0:
            pred = np.zeros(W, np.int32)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw.append(ft)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
def test_native_decoder_every_row_filter(native, tmp_path, filters):
    """Each of PNG's five row filters (and all of them mixed) decodes to
    the written image, as cv2 and the JAX package's libpng read it."""
    rng = np.random.default_rng(sum(filters))
    img = (rng.random((19, 27)) * 255).astype(np.uint8)
    img[5:9] = np.arange(27, dtype=np.uint8) * 9  # smooth rows too
    p = tmp_path / "f.png"
    p.write_bytes(_png(img, filters))
    u = native.load_png_u8_padded(p, img.shape)
    same(u, img)
    same(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE), img)
    same(native.load_png_gray(p), jruntime.load_png_gray(p))


def test_native_decoder_refuses_bad_files(native, tmp_path):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    good = _png(img, (1,))
    cases = {"crc": good[:40] + bytes([good[40] ^ 1]) + good[41:],
             "truncated": good[:-20], "not a png": b"GIF89a" + good[6:]}
    for name, data in cases.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(data)
        with pytest.raises(IOError):
            native.load_png_u8_padded(p, (8, 8))
    p = tmp_path / "big.png"
    p.write_bytes(good)
    with pytest.raises(IOError):  # larger than the bucket
        native.load_png_u8_padded(p, (8, 7))
    with pytest.raises(IOError):
        native.load_png_gray(tmp_path / "missing.png")


def _sequence(tmp_path, F, hw=(24, 40)):
    rng = np.random.default_rng(F)
    L = (rng.random((F,) + hw) * 255).astype(np.uint8)
    R = (rng.random((F,) + hw) * 255).astype(np.uint8)
    calib = np.array([300.0, 300.0, 20.0, 12.0, 0.5], np.float32)
    return kitti.write_kitti_sequence(tmp_path, "00", L, R, calib), L, R


@pytest.mark.parametrize("into_tensors", [False, True])
def test_prefetcher_yields_read_batch_chunks(native, tmp_path, into_tensors):
    """Chunks of 4 over 10 frames, the tail chunk of 2 included, equal
    read_batch's frames (as uint8: read_batch is u8 / 255), returned as
    fresh arrays or written into given host tensors, whose frames past
    the tail are zero; with a bucket, pad_to_bucket's frames."""
    paths, L, R = _sequence(tmp_path, 10)
    lp = sorted(paths.left_dir.glob("*.png"))
    rp = sorted(paths.right_dir.glob("*.png"))
    for hw in ((24, 40), (32, 48)):
        pf = native.StereoPrefetcher(lp, rp, hw[0], hw[1], 4, n_threads=2)
        starts = []
        for s in range(0, 10, 4):
            if into_tensors:
                dl, dr = (torch.full((4,) + hw, 7, dtype=torch.uint8)
                          for _ in range(2))
                cl, cr = pf.__next__(dl, dr)
                assert (dl[len(cl):] == 0).all() and (dr[len(cr):] == 0).all()
                cl, cr = cl.numpy(), cr.numpy()
            else:
                cl, cr = next(pf)
            n = min(4, 10 - s)
            assert cl.shape == (n,) + hw and cl.dtype == np.uint8
            bl, br = kitti.read_batch(paths, s, n)
            same(cl.astype(np.float32) / 255.0, kitti.pad_to_bucket(bl, hw))
            same(cr.astype(np.float32) / 255.0, kitti.pad_to_bucket(br, hw))
            same(cl, kitti.pad_to_bucket(L[s:s + n], hw))
            starts.append(s)
        assert starts == [0, 4, 8]
        with pytest.raises(StopIteration):
            next(pf)


def test_prefetcher_under_more_threads_than_cores(native, tmp_path):
    """Decode threads share the chunk queue and the frame counter: with 4x
    as many threads as cores, 41 frames in chunks of 3 (a tail of 2),
    every chunk arrives once, in order, with its own frames; the whole
    stream runs under a time limit (a lost wake-up would hang it)."""
    import threading

    paths, L, R = _sequence(tmp_path, 41, hw=(8, 12))
    lp = sorted(paths.left_dir.glob("*.png"))
    rp = sorted(paths.right_dir.glob("*.png"))
    got = []

    def drain():
        pf = native.StereoPrefetcher(lp, rp, 8, 12, 3,
                                     n_threads=4 * (os.cpu_count() or 2))
        got.extend(pf)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the prefetcher did not finish"
    assert [len(cl) for cl, _ in got] == [3] * 13 + [2]
    same(np.concatenate([cl for cl, _ in got]), L)
    same(np.concatenate([cr for _, cr in got]), R)


def test_prefetcher_raises_on_a_bad_frame(native, tmp_path):
    paths, _, _ = _sequence(tmp_path, 6)
    lp = sorted(paths.left_dir.glob("*.png"))
    rp = sorted(paths.right_dir.glob("*.png"))
    lp[5].write_bytes(b"not a png")
    pf = native.StereoPrefetcher(lp, rp, 24, 40, 3)
    next(pf)
    with pytest.raises(IOError, match="3..6"):
        next(pf)
    with pytest.raises(ValueError):  # wrong destination shape
        native.StereoPrefetcher(lp[:3], rp[:3], 24, 40, 3).__next__(
            torch.zeros((3, 24, 41), dtype=torch.uint8),
            torch.zeros((3, 24, 41), dtype=torch.uint8))


def test_build_tracks_equals_chain_tracks_and_jax(native):
    """The C++ chaining issues the numpy chain_tracks' ids and the JAX
    package's runtime's, on random injective matches."""
    rng = np.random.default_rng(5)
    F, K = 30, 64
    mp = np.full((F, K), -1, np.int32)
    for f in range(1, F):
        cur = rng.choice(K, 40, replace=False)
        mp[f, cur] = rng.choice(K, 40, replace=False)
    inl = rng.random((F, K)) < 0.8
    tids, n = native.build_tracks(mp, inl)
    ref = np.full((F, K), NO_ID, np.int32)
    assert n == chain_tracks(ref, 0, mp, inl, 1, F) > 0
    same(tids, ref)
    jt, jn = jruntime.build_tracks(mp, inl)
    assert n == jn
    same(tids, jt)


def test_native_library_is_built_outside_the_sources(native):
    """The library is built from the port's own native.cpp into
    build/slam_tpu_torch/, keyed on the source's hash; the package's
    source tree holds no binary and the JAX package's library is not
    what the port loaded."""
    built = sorted((REPO / "build" / "slam_tpu_torch").glob(
        "libslam_native_*.so"))
    assert built
    assert native._lib._name in {str(p) for p in built}
    assert not list((REPO / "slam_tpu_torch").rglob("*.so"))
    assert "slam_tpu/runtime" not in native._lib._name
