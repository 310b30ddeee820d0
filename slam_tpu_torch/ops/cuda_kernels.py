"""Hand-written CUDA kernels of the frontend, with their plain versions.

Counterpart of ``slam_tpu/ops/pallas_kernels.py``. Two kernels sit on the
pipeline's main path:

  B1 ``detect_maps``     Harris response, 5x5 NMS map and 8 orientation
                         cell maps in one pass (csrc/detect_maps.cu);
  B2 ``mutual_nearest``  bf16 similarity with both nearest-neighbour
                         reductions in one pass (csrc/mutual_nearest.cu).

Each has a plain PyTorch version with the same signature
(``detect_maps_plain``, ``mutual_nearest_plain``). A wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
its kernel or raises, on the current stream. The kernels are built with
``nvcc`` for sm_90a at first use, from the sources in ``csrc/``, into
``build/slam_tpu_torch/`` beside the package, and bound through ctypes
(plain C entry points returning ``cudaError_t``).

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the plain
versions, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import features

BIG = 1e30
_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "detect_maps.cu", _PKG / "csrc" / "mutual_nearest.cu")
BUILD_DIR = _PKG.parent / "build" / "slam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"detect_maps": 0, "mutual_nearest": 0}
PLAIN_CALLS = {"detect_maps": 0, "mutual_nearest": 0}
_lib = None
build_log = ""


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def resolve_device(device) -> torch.device:
    """The device a stage runs on. The stage entry points default to
    "cuda", where the kernels run; the CPU (plain versions) only when the
    caller names it. Asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; pass "
            f"device='cpu' to run the plain PyTorch versions")
    return device


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slam_detect_maps.argtypes = [p, p, p, p, i, i, i, f, p, p, p]
    lib.slam_detect_maps.restype = i
    lib.slam_mutual_nearest.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f,
                                        f, p, p, p, p, p, p]
    lib.slam_mutual_nearest.restype = i
    _lib = lib
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# B1: detection maps
# ---------------------------------------------------------------------------

def detect_maps_plain(imgs: torch.Tensor, k: float = 0.05):
    """Plain version of B1: (resp, nms, maps) from the jnp-path
    semantics (features.harris_response / nms / orientation_cell_maps)."""
    PLAIN_CALLS["detect_maps"] += 1
    resp = features.harris_response(imgs, k)
    return resp, features.nms(resp), features.orientation_cell_maps(imgs)


def detect_maps(imgs: torch.Tensor, k: float = 0.05):
    """Kernel B1: (F, H, W) float32 -> resp (F, H, W), nms (F, H, W),
    maps (F, 8, H, W), all float32 (the unshifted contract of
    pallas_kernels.detect_maps_batch)."""
    _require(imgs.dim() == 3, f"detect_maps: expected (F, H, W), got "
             f"{tuple(imgs.shape)}")
    _require(imgs.dtype == torch.float32,
             f"detect_maps: expected float32, got {imgs.dtype}")
    if imgs.device.type == "cpu":
        return detect_maps_plain(imgs, k)
    _require(imgs.device.type == "cuda",
             f"detect_maps: unsupported device {imgs.device}")
    _require(imgs.is_contiguous(), "detect_maps: input must be contiguous")
    F, H, W = imgs.shape
    _require(F > 0 and H > 0 and W > 0, "detect_maps: empty input")
    lib = build()
    resp = torch.empty_like(imgs)
    nms = torch.empty_like(imgs)
    maps = torch.empty((F, 8, H, W), dtype=imgs.dtype, device=imgs.device)
    # host-computed taps: the plain version blurs with the same values
    th = (ctypes.c_float * 5)(*features.gaussian_kernel1d(1.5, 2).tolist())
    to = (ctypes.c_float * 5)(*features.gaussian_kernel1d(1.0, 2).tolist())
    with torch.cuda.device(imgs.device):
        err = lib.slam_detect_maps(
            imgs.data_ptr(), resp.data_ptr(), nms.data_ptr(), maps.data_ptr(),
            F, H, W, float(k), ctypes.cast(th, ctypes.c_void_p),
            ctypes.cast(to, ctypes.c_void_p), _stream(imgs))
    _check(err, "detect_maps")
    LAUNCHES["detect_maps"] += 1
    return resp, nms, maps


# ---------------------------------------------------------------------------
# B2: one-pass mutual nearest neighbours
# ---------------------------------------------------------------------------

def _check_match_inputs(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b,
                        window):
    _require(desc_a.dim() == 3 and desc_b.dim() == 3,
             "mutual_nearest: descriptors must be (B, K, D)")
    B, Ka, D = desc_a.shape
    _require(desc_b.shape[0] == B and desc_b.shape[2] == D,
             f"mutual_nearest: shapes {tuple(desc_a.shape)} vs "
             f"{tuple(desc_b.shape)}")
    Kb = desc_b.shape[1]
    _require(desc_a.is_floating_point() and desc_b.is_floating_point(),
             "mutual_nearest: descriptors must be floating point")
    _require(valid_a.shape == (B, Ka) and valid_b.shape == (B, Kb)
             and valid_a.dtype == torch.bool and valid_b.dtype == torch.bool,
             "mutual_nearest: valid masks must be bool (B, K)")
    if window is not None:
        _require(xy_a is not None and xy_b is not None,
                 "mutual_nearest: a window needs xy_a and xy_b")
        _require(xy_a.shape == (B, Ka, 2) and xy_b.shape == (B, Kb, 2)
                 and xy_a.dtype == torch.float32
                 and xy_b.dtype == torch.float32,
                 "mutual_nearest: xy must be float32 (B, K, 2)")
    devs = {t.device for t in (desc_a, desc_b, valid_a, valid_b)}
    if window is not None:
        devs |= {xy_a.device, xy_b.device}
    _require(len(devs) == 1, f"mutual_nearest: tensors on several devices "
             f"{devs}")
    return B, Ka, Kb, D


def window_distances(desc_a, desc_b, xy_a=None, xy_b=None, window=None):
    """(B, Ka, Kb) distances ``2 - 2 a.b`` of bf16-rounded descriptors,
    +BIG for pairs outside the guided window ``(dx_min, dx_max, dy_max)``
    (candidate j is admissible for query i iff x_b[j] - x_a[i] is in
    [dx_min, dx_max] and |y_b[j] - y_a[i]| <= dy_max): the matrix both
    reductions of B2 read, before the validity penalties."""
    a = desc_a.to(torch.bfloat16).float()
    b = desc_b.to(torch.bfloat16).float()
    base = 2.0 - 2.0 * torch.matmul(a, b.transpose(1, 2))
    if window is not None:
        dx_min, dx_max, dy_max = (float(v) for v in window)
        dx = xy_b[:, None, :, 0] - xy_a[:, :, None, 0]
        dy = torch.abs(xy_b[:, None, :, 1] - xy_a[:, :, None, 1])
        bad = (dx < dx_min) | (dx > dx_max) | (dy > dy_max)
        base = base + torch.where(bad, BIG, 0.0)
    return base


def mutual_nearest_plain(desc_a, desc_b, valid_a, valid_b, xy_a=None,
                         xy_b=None, window=None):
    """Plain version of B2. Inputs are rounded to bf16 and multiplied in
    float32 (those products are exact), so it matches the kernel up to the
    order of the summation. Returns (row_dist (B, Ka), row_idx (B, Ka),
    col_dist (B, Kb), col_idx (B, Kb)); ties go to the lowest index."""
    PLAIN_CALLS["mutual_nearest"] += 1
    base = window_distances(desc_a, desc_b, xy_a, xy_b, window)
    pen_a = torch.where(valid_a, 0.0, BIG)
    pen_b = torch.where(valid_b, 0.0, BIG)
    rdist, ridx = torch.min(base + pen_b[:, None, :], dim=2)
    cdist, cidx = torch.min(base + pen_a[:, :, None], dim=1)
    return rdist, ridx, cdist, cidx


def mutual_nearest(desc_a, desc_b, valid_a, valid_b, xy_a=None, xy_b=None,
                   window=None):
    """Kernel B2, batched over pairs: A (B, Ka, D), B (B, Kb, D) float
    descriptors (rounded to bf16), valid (B, K) bool, xy (B, K, 2) float32
    and an optional guided window (dx_min, dx_max, dy_max). Any Ka, Kb;
    D a multiple of 16 up to 256. Returns row dist/idx (B, Ka) and column
    dist/idx (B, Kb), float32 / int64."""
    B, Ka, Kb, D = _check_match_inputs(desc_a, desc_b, valid_a, valid_b,
                                       xy_a, xy_b, window)
    dev = desc_a.device
    if dev.type == "cpu":
        return mutual_nearest_plain(desc_a, desc_b, valid_a, valid_b, xy_a,
                                    xy_b, window)
    _require(dev.type == "cuda", f"mutual_nearest: unsupported device {dev}")
    _require(D % 16 == 0 and 0 < D <= 256,
             f"mutual_nearest: D={D} must be a multiple of 16 up to 256")
    _require(Ka > 0 and Kb > 0, "mutual_nearest: empty descriptor set")
    ins = (desc_a, desc_b, valid_a, valid_b) + (
        (xy_a, xy_b) if window is not None else ())
    _require(all(t.is_contiguous() for t in ins),
             "mutual_nearest: inputs must be contiguous")
    lib = build()
    a = desc_a.to(torch.bfloat16)
    b = desc_b.to(torch.bfloat16)
    pen_a = torch.where(valid_a, 0.0, BIG)
    pen_b = torch.where(valid_b, 0.0, BIG)
    win = (0.0, 0.0, 0.0) if window is None else tuple(float(v) for v in window)
    xa = xy_a.data_ptr() if window is not None else None
    xb = xy_b.data_ptr() if window is not None else None
    colbest = torch.full((B, Kb), -1, dtype=torch.int64, device=dev)
    rdist = torch.empty((B, Ka), dtype=torch.float32, device=dev)
    ridx = torch.empty((B, Ka), dtype=torch.int64, device=dev)
    cdist = torch.empty((B, Kb), dtype=torch.float32, device=dev)
    cidx = torch.empty((B, Kb), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.slam_mutual_nearest(
            a.data_ptr(), b.data_ptr(), pen_a.data_ptr(), pen_b.data_ptr(),
            xa, xb, B, Ka, Kb, D, int(window is not None), *win,
            colbest.data_ptr(), rdist.data_ptr(), ridx.data_ptr(),
            cdist.data_ptr(), cidx.data_ptr(), _stream(a))
    _check(err, "mutual_nearest")
    LAUNCHES["mutual_nearest"] += 1
    return rdist, ridx, cdist, cidx

