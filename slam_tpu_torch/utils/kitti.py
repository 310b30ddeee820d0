"""KITTI odometry dataset IO (numpy, with cv2 or PIL for PNG files).

The port's own copy of ``slam_tpu/utils/kitti.py``, kept equal to it by
``tests/test_torch_kitti.py``: ``KittiPaths`` (the dataset's directory
layout), calibration and ground-truth readers, ``write_kitti_sequence``
(a sequence written in KITTI's exact layout, the fixture of the on-disk
path), image readers, and the bucket padding that lets sequences of
different resolutions share one set of shapes. Reference surface:
final_project/Inputs.py (``read_images`` :8-19, ``read_cameras``
:22-37, ``read_extrinsic_matrices`` :40-64, ``read_kth_camera`` :67).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class KittiPaths:
    root: Path                 # e.g. .../dataset
    sequence: str = "00"

    @property
    def seq_dir(self) -> Path:
        return Path(self.root) / "sequences" / self.sequence

    @property
    def left_dir(self) -> Path:
        return self.seq_dir / "image_0"

    @property
    def right_dir(self) -> Path:
        return self.seq_dir / "image_1"

    @property
    def calib_file(self) -> Path:
        return self.seq_dir / "calib.txt"

    @property
    def poses_file(self) -> Path:
        return Path(self.root) / "poses" / f"{self.sequence}.txt"

    def exists(self) -> bool:
        return self.left_dir.is_dir() and self.calib_file.is_file()


def num_frames(paths: KittiPaths) -> int:
    """Sequence length = image count (reference arguments.py:13)."""
    return len(sorted(paths.left_dir.glob("*.png")))


def _parse_projection_lines(text: str) -> dict[str, np.ndarray]:
    """Parse the `P0: <12 floats>` lines of a KITTI calib.txt.

    Real odometry calib files carry four cameras (P0/P1 grayscale,
    P2/P3 color) and, in the raw-synced variants, a trailing `Tr:`
    velodyne line — tolerate both, key by label."""
    out = {}
    for line in text.strip().splitlines():
        if ":" not in line:
            continue
        label, vals = line.split(":", 1)
        arr = np.fromstring(vals, sep=" ")
        if arr.size == 12:
            out[label.strip()] = arr.reshape(3, 4)
    return out


def read_calibration(paths: KittiPaths):
    """Parse calib.txt -> (K 3x3, M1 3x4, M2 3x4, baseline).

    KITTI stores P0/P1 = K @ [R|t]; K is shared, and the right camera's
    translation encodes the baseline: P1[0,3] = -fx * b
    (reference read_cameras, Inputs.py:22-37). Handles the real on-disk
    format: P0..P3 + optional Tr line, scientific-notation floats.
    """
    mats = _parse_projection_lines(paths.calib_file.read_text())
    if "P0" not in mats or "P1" not in mats:
        raise ValueError(
            f"{paths.calib_file}: expected P0/P1 projection lines, "
            f"found {sorted(mats)}"
        )
    P0, P1 = mats["P0"], mats["P1"]
    K = P0[:, :3]
    Kinv = np.linalg.inv(K)
    M1 = np.hstack([np.eye(3), (Kinv @ P0[:, 3])[:, None]])
    M2 = np.hstack([np.eye(3), (Kinv @ P1[:, 3])[:, None]])
    baseline = float(-M2[0, 3])
    return K, M1, M2, baseline


def calib_vector(paths: KittiPaths) -> np.ndarray:
    """[fx, fy, cx, cy, baseline] for the stereo camera model."""
    K, _, _, b = read_calibration(paths)
    return np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2], b], np.float32)


def read_ground_truth(paths: KittiPaths) -> np.ndarray:
    """Ground-truth extrinsics (F, 4, 4) T_w2c.

    KITTI poses/XX.txt rows are 3x4 cam->world matrices; the reference
    inverts them to extrinsics (Inputs.py:40-64).
    """
    rows = np.loadtxt(paths.poses_file).reshape(-1, 3, 4)
    F = rows.shape[0]
    T_c2w = np.tile(np.eye(4, dtype=np.float64), (F, 1, 1))
    T_c2w[:, :3, :] = rows
    return np.linalg.inv(T_c2w).astype(np.float32)


def read_kth_camera(paths: KittiPaths, k: int) -> np.ndarray:
    """Ground-truth extrinsic matrix of frame k (reference read_kth_camera,
    Inputs.py:67-80)."""
    return read_ground_truth(paths)[k]


def _imwrite_gray(path: Path, img_u8: np.ndarray) -> None:
    try:
        import cv2

        if not cv2.imwrite(str(path), img_u8):
            raise IOError(path)
    except ImportError:
        from PIL import Image

        Image.fromarray(img_u8, mode="L").save(path)


def write_kitti_sequence(
    root: Path | str,
    sequence: str,
    left_u8: np.ndarray,
    right_u8: np.ndarray,
    calib: np.ndarray,
    T_w2c: np.ndarray | None = None,
) -> KittiPaths:
    """Write a stereo sequence to disk in KITTI odometry's exact layout:

      <root>/sequences/<seq>/image_0/000000.png ...   (left, 8-bit gray)
      <root>/sequences/<seq>/image_1/000000.png ...   (right)
      <root>/sequences/<seq>/calib.txt                (P0..P3 lines)
      <root>/poses/<seq>.txt                          (3x4 cam-to-world rows)

    ``calib`` is the [fx, fy, cx, cy, baseline] vector; ``T_w2c`` the
    per-frame extrinsics (inverted to the cam-to-world rows KITTI ships,
    matching read_ground_truth). This is the fixture generator for driving
    the on-disk CLI path (reference layout per Inputs.py:8-64 +
    arguments.py:12-14) without the real dataset in the image.
    """
    paths = KittiPaths(root=Path(root), sequence=sequence)
    paths.left_dir.mkdir(parents=True, exist_ok=True)
    paths.right_dir.mkdir(parents=True, exist_ok=True)
    F = left_u8.shape[0]
    for i in range(F):
        _imwrite_gray(paths.left_dir / f"{i:06d}.png", left_u8[i])
        _imwrite_gray(paths.right_dir / f"{i:06d}.png", right_u8[i])

    fx, fy, cx, cy, b = [float(v) for v in np.asarray(calib).ravel()[:5]]
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * b  # right-camera baseline (Inputs.py:22-37 inverse)
    lines = []
    for label, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)):
        lines.append(label + ": " + " ".join(f"{v:.12e}" for v in P.ravel()))
    paths.calib_file.write_text("\n".join(lines) + "\n")

    if T_w2c is not None:
        paths.poses_file.parent.mkdir(parents=True, exist_ok=True)
        T_c2w = np.linalg.inv(np.asarray(T_w2c, np.float64))
        rows = T_c2w[:, :3, :].reshape(len(T_c2w), 12)
        np.savetxt(paths.poses_file, rows, fmt="%.12e")
    return paths


def _imread_gray(path: Path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def read_pair(paths: KittiPaths, idx: int) -> tuple[np.ndarray, np.ndarray]:
    """One stereo pair as float32 in [0, 1] (reference read_images)."""
    name = f"{idx:06d}.png"
    l = _imread_gray(paths.left_dir / name).astype(np.float32) / 255.0
    r = _imread_gray(paths.right_dir / name).astype(np.float32) / 255.0
    return l, r


def read_batch(
    paths: KittiPaths, start: int, count: int
) -> tuple[np.ndarray, np.ndarray]:
    """A contiguous batch of stereo pairs (count, H, W) float32 — the host
    staging block the frontend consumes per chunk."""
    ls, rs = [], []
    for i in range(start, start + count):
        l, r = read_pair(paths, i)
        ls.append(l)
        rs.append(r)
    return np.stack(ls), np.stack(rs)


def bucket_for(shapes, multiple: int = 8) -> tuple[int, int]:
    """Shared padded shape for a set of (H, W) image shapes.

    KITTI sequences differ in resolution (00-02: 376x1241, 03: 375x1242,
    04-12: 370x1226); under jit each distinct shape costs a full
    recompilation of the frontend kernels. One bucket = one compilation
    for the whole multi-sequence batch (reference loads each sequence
    at native size, Inputs.py:8-19, and pays nothing because cv2 is
    eager — XLA is not)."""
    hs = [s[0] for s in shapes]
    ws = [s[1] for s in shapes]
    rup = lambda v: ((v + multiple - 1) // multiple) * multiple
    return rup(max(hs)), rup(max(ws))


def pad_to_bucket(images: np.ndarray, bucket_hw: tuple[int, int]) -> np.ndarray:
    """Edge-replicate-pad (F, H, W) images bottom/right to the bucket shape.

    Bottom/right padding keeps pixel coordinates and the calibration
    (cx, cy anchored at the top-left origin) valid. Edge replication (not
    zeros) avoids manufacturing a high-contrast step edge at the
    content/padding boundary: a zero region next to real texture is a
    strong static Harris/AKAZE response that would steal grid-cell top-K
    slots from real features in every frame; a replicated edge is flat in
    the pad direction, so the detectors stay quiet there.
    """
    F, H, W = images.shape
    BH, BW = bucket_hw
    if (H, W) == (BH, BW):
        return images
    if H > BH or W > BW:
        raise ValueError(f"images {(H, W)} exceed bucket {bucket_hw}")
    return np.pad(images, ((0, 0), (0, BH - H), (0, BW - W)), mode="edge")


class LazyImageSequence:
    """Array-like view over on-disk grayscale PNGs, decoded on demand.

    Streams exactly like ``load_sequence``'s eager arrays (same decode +
    edge-replicate bucket padding) but holds only one decoded frame at a
    time, so the prefetch/path CLI mode can still feed the image-based
    analysis probes (loop-match overlays, worst-factor insets,
    visualize_track) without re-loading the whole sequence into host
    memory. Supports the indexing the analysis suite uses:
    ``seq[f]``, ``seq[f, y0:y1, x0:x1]``, ``seq.shape``, ``len(seq)``.
    """

    def __init__(self, paths, bucket_hw: tuple[int, int] | None = None):
        self._paths = [Path(p) for p in paths]
        if not self._paths:
            raise ValueError("empty image path list")
        self._bucket = bucket_hw
        self._cache: tuple[int, np.ndarray] | None = None
        h, w = _imread_gray(self._paths[0]).shape
        if bucket_hw is not None:
            h, w = bucket_hw
        self.shape = (len(self._paths), h, w)

    def __len__(self) -> int:
        return self.shape[0]

    def _frame(self, f: int) -> np.ndarray:
        f = int(f)
        if self._cache is not None and self._cache[0] == f:
            return self._cache[1]
        img = _imread_gray(self._paths[f]).astype(np.float32) / 255.0
        if self._bucket is not None:
            img = pad_to_bucket(img[None], self._bucket)[0]
        self._cache = (f, img)
        return img

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            return self._frame(idx[0])[idx[1:]]
        return self._frame(idx)


def load_sequence(
    paths: KittiPaths,
    limit: int | None = None,
    bucket_hw: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """(left (F,H,W), right, calib_vector, T_gt or None).

    With ``bucket_hw`` the images are edge-replicate-padded bottom/right
    to the bucket shape (see pad_to_bucket for why not zeros) so
    differently-sized sequences share compiled kernels (see bucket_for)."""
    F = num_frames(paths)
    if limit is not None:
        F = min(F, limit)
    L, R = read_batch(paths, 0, F)
    if bucket_hw is not None:
        L = pad_to_bucket(L, bucket_hw)
        R = pad_to_bucket(R, bucket_hw)
    calib = calib_vector(paths)
    gt = None
    if paths.poses_file.is_file():
        gt = read_ground_truth(paths)[:F]
    return L, R, calib, gt
