"""Sequences written in KITTI odometry's layout, as its users read them.

``<root>/sequences/<seq>/image_0/000000.png`` (left, 8-bit gray), ``image_1``
(right), ``calib.txt`` (P0..P3) and ``<root>/poses/<seq>.txt`` (3x4
camera-to-world rows). The PNGs are written here with zlib at its
default level and the Paeth filter on every row (what photographs get
from the usual encoders), so that decoding them costs what KITTI's own
files cost.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def paeth_rows(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, 1 + W) filtered scanlines, Paeth on every row."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                 # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                       # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]              # upper left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.empty((img.shape[0], img.shape[1] + 1), np.uint8)
    out[:, 0] = 4
    out[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8)
    return out


def encode_png(img: np.ndarray) -> bytes:
    H, W = img.shape
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(paeth_rows(img).tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_sequence(root: Path, seq: str, left: np.ndarray,
                   right: np.ndarray, calib, T_w2c, threads: int = 4):
    """Write one stereo sequence; returns (left paths, right paths)."""
    seq_dir = Path(root) / "sequences" / seq
    dirs = [seq_dir / "image_0", seq_dir / "image_1"]
    for d in dirs:
        d.mkdir(parents=True, exist_ok=True)
    jobs = [(d / f"{i:06d}.png", imgs[i]) for d, imgs in zip(dirs, (left,
                                                                  right))
            for i in range(imgs.shape[0])]
    with ThreadPoolExecutor(threads) as pool:
        for fut in [pool.submit(lambda p, im: p.write_bytes(encode_png(im)),
                                p, im) for p, im in jobs]:
            fut.result()
    fx, fy, cx, cy, b = (float(v) for v in np.asarray(calib).ravel()[:5])
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * b
    (seq_dir / "calib.txt").write_text("".join(
        f"{k}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n"
        for k, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1))))
    poses = Path(root) / "poses"
    poses.mkdir(parents=True, exist_ok=True)
    T_c2w = np.linalg.inv(np.asarray(T_w2c, np.float64))
    np.savetxt(poses / f"{seq}.txt", T_c2w[:, :3, :].reshape(len(T_c2w), 12),
               fmt="%.12e")
    n = left.shape[0]
    return ([str(dirs[0] / f"{i:06d}.png") for i in range(n)],
            [str(dirs[1] / f"{i:06d}.png") for i in range(n)])
