"""Native C++ runtime of the port (ctypes bindings).

The port's own counterpart of ``slam_tpu/runtime``, built from its own
source, ``native.cpp`` beside this file: g++ compiles it at first use
into ``build/slam_tpu_torch/`` beside the package (the file name keyed on
a hash of the source and flags; nothing is written into the source
tree). It needs zlib only, no libpng. It provides:

  * :func:`build_tracks` - the track store's track-id chaining;
  * :func:`load_png_gray`, :func:`load_png_gray_padded` - PNG decode to
    float32 [0, 1] (u8 * (1/255f), what the device computes from uint8),
    the second edge-replicate-padded to a bucket shape;
    :func:`load_png_u8_padded` the same as uint8;
  * :class:`StereoPrefetcher` - worker threads decode the next stereo
    chunk as uint8 while the caller uploads and computes the current one;
    ``__next__`` writes into given (pinned) host tensors.

``available()`` builds and loads the library; it is False when g++ or
zlib is missing, and the callers then decode with
``utils.kitti._imread_gray`` (cv2, else PIL) on the calling thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slam_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-pthread")

AVAILABLE = False
build_error = ""   # the compiler's output when the build failed
_lib = None


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    out = BUILD_DIR / f"libslam_native_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp),
                               *LIBS], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def available() -> bool:
    """Build (once per source content) and load the library; False when
    it cannot be built or loaded (``build_error`` says why)."""
    global _lib, AVAILABLE, build_error
    if _lib is not None or build_error:
        return AVAILABLE
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = str(e) or type(e).__name__
        return False
    i32, p = ctypes.c_int32, ctypes.c_void_p
    lib.build_tracks.restype = i32
    lib.build_tracks.argtypes = [i32, i32, p, p, p]
    lib.load_png_gray.restype = ctypes.c_int
    lib.load_png_gray.argtypes = [ctypes.c_char_p, p, ctypes.POINTER(i32),
                                  ctypes.POINTER(i32), i32, i32]
    for name in ("load_png_gray_padded", "load_png_u8_padded"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_char_p, p, i32, i32]
    lib.loader_create.restype = p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.POINTER(ctypes.c_char_p), i32, i32,
                                  i32, i32, i32]
    lib.loader_next.restype = i32
    lib.loader_next.argtypes = [p, p, p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [p]
    _lib = lib
    AVAILABLE = True
    return True


def _need():
    if not available():
        raise RuntimeError(f"native runtime unavailable: {build_error}")
    return _lib


def _ptr(buf, dtype, shape) -> int:
    """Address of a C-contiguous host buffer (numpy array or CPU torch
    tensor) of ``dtype`` and ``shape``."""
    if hasattr(buf, "data_ptr"):  # torch tensor
        ok = (buf.device.type == "cpu" and buf.is_contiguous()
              and str(buf.dtype) == f"torch.{np.dtype(dtype).name}")
        addr = buf.data_ptr()
    else:
        ok = buf.dtype == dtype and buf.flags.c_contiguous
        addr = buf.ctypes.data
    if not ok or tuple(buf.shape) != tuple(shape):
        raise ValueError(f"need a contiguous {np.dtype(dtype).name} host "
                         f"buffer of shape {tuple(shape)}, got "
                         f"{getattr(buf, 'dtype', None)} {tuple(buf.shape)}")
    return addr


def build_tracks(match_prev: np.ndarray, inlier_prev: np.ndarray):
    """C++ track-id chaining: (track_ids (F, K) int32, num_tracks), the
    ids ``models.trackstore.chain_tracks`` issues."""
    lib = _need()
    F, K = match_prev.shape
    mp = np.ascontiguousarray(match_prev, np.int32)
    inl = np.ascontiguousarray(inlier_prev, np.uint8)
    tids = np.full((F, K), -1, np.int32)
    n = lib.build_tracks(F, K, mp.ctypes.data, inl.ctypes.data,
                         tids.ctypes.data)
    return tids, int(n)


def load_png_gray(path, max_h: int = 4096, max_w: int = 4096) -> np.ndarray:
    """A PNG as float32 [0, 1] at its own size."""
    lib = _need()
    buf = np.zeros(max_h * max_w, np.float32)  # rows packed at the width
    h, w = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = lib.load_png_gray(str(path).encode(), buf.ctypes.data,
                           ctypes.byref(h), ctypes.byref(w), max_h, max_w)
    if rc != 0:
        raise IOError(f"load_png_gray({path}) failed rc={rc}")
    return buf[:h.value * w.value].reshape(h.value, w.value).copy()


def load_png_gray_padded(path, hw: tuple[int, int]) -> np.ndarray:
    """A PNG as float32 [0, 1], edge-replicate-padded bottom/right to
    ``hw`` (``utils.kitti.pad_to_bucket``; it must not exceed ``hw``)."""
    buf = np.zeros(tuple(hw), np.float32)
    rc = _need().load_png_gray_padded(str(path).encode(), buf.ctypes.data,
                                      *hw)
    if rc != 0:
        raise IOError(f"load_png_gray_padded({path}) failed rc={rc}")
    return buf


def load_png_u8_padded(path, hw: tuple[int, int], out=None):
    """A PNG as uint8, edge-replicate-padded to ``hw``, into ``out`` (a
    host (H, W) uint8 array or tensor) when given."""
    out = np.zeros(tuple(hw), np.uint8) if out is None else out
    rc = _need().load_png_u8_padded(str(path).encode(),
                                    _ptr(out, np.uint8, hw), *hw)
    if rc != 0:
        raise IOError(f"load_png_u8_padded({path}) failed rc={rc}")
    return out


class StereoPrefetcher:
    """Background stereo chunk loader: yields (left, right) uint8 chunks
    of ``chunk`` frames (the tail one shorter), each frame decoded and
    edge-replicate-padded to (H, W), decoding the next chunk on
    ``n_threads`` threads while the caller works on this one.

    ``next(p)`` returns fresh arrays; ``p.__next__(dst_left, dst_right)``
    writes the chunk into the given host buffers ((chunk, H, W) uint8,
    e.g. pinned tensors; frames past the valid count are zero) and
    returns their valid parts. A frame that does not decode raises."""

    def __init__(self, left_paths, right_paths, H, W, chunk, n_threads=3):
        lib = _need()
        self.H, self.W, self.chunk = H, W, chunk
        n = len(left_paths)
        if len(right_paths) != n:
            raise ValueError("left and right path lists differ in length")
        self._lp = (ctypes.c_char_p * n)(*[str(p).encode()
                                           for p in left_paths])
        self._rp = (ctypes.c_char_p * n)(*[str(p).encode()
                                           for p in right_paths])
        self._num = n
        self._served = 0
        self._handle = lib.loader_create(self._lp, self._rp, n, H, W, chunk,
                                         n_threads)

    def __iter__(self):
        return self

    def __next__(self, dst_left=None, dst_right=None):
        if self._handle is None or self._served >= self._num:
            self.close()
            raise StopIteration
        shape = (self.chunk, self.H, self.W)
        if dst_left is None:
            dst_left, dst_right = np.zeros(shape, np.uint8), np.zeros(
                shape, np.uint8)
        got = _lib.loader_next(self._handle,
                               _ptr(dst_left, np.uint8, shape),
                               _ptr(dst_right, np.uint8, shape))
        n_valid = min(self.chunk, self._num - self._served)
        if got < 0:
            self.close()
            raise IOError(f"a frame of {self._served}..{self._served + n_valid}"
                          f" did not decode")
        if got != n_valid:
            self.close()
            raise RuntimeError(f"prefetcher served {got} frames, expected "
                               f"{n_valid}")
        self._served += n_valid
        return dst_left[:n_valid], dst_right[:n_valid]

    def close(self):
        if getattr(self, "_handle", None):
            _lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
