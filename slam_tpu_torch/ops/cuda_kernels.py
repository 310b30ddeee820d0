"""Hand-written CUDA kernels, with their plain versions.

Counterpart of ``slam_tpu/ops/pallas_kernels.py`` (B1-B6), plus B7, B8
and B9, which have no TPU counterpart, and a clock stamp. Nine kernels:

  B1 ``detect_maps``       Harris response, 5x5 NMS map and 8 orientation
                           cell maps in one pass (csrc/detect_maps.cu);
                           Harris detection at every pyramid level;
  B2 ``mutual_nearest``    bf16 similarity with both nearest-neighbour
                           reductions in one pass (csrc/mutual_nearest.cu);
                           every L2 and Hamming matching;
  B3 ``orientation_maps``  B1's orientation phase alone, a variant of B1's
                           template: AKAZE's descriptor maps;
  B4 ``harris_response``   B1's Harris phase alone (resp and NMS), a
                           variant of B1's template; no pipeline caller;
  B5 ``akaze_octave``      one AKAZE octave: PM-g2 diffusion steps,
                           sigma^4 det(Hessian) and 5x5 NMS in one pass
                           (csrc/akaze_octave.cu);
  B6 ``cholesky_solve``    batched Cholesky factorization and both
                           substitutions of bundle adjustment's reduced
                           pose systems (csrc/cholesky_solve.cu); every
                           LM iteration of ops/ba.py;
  B7 ``schur_reduce``      bundle adjustment's reduced pose system,
                           linearized and built from each window's
                           observations, and (its
                           second entry point, ``schur_back``) the
                           landmark steps (csrc/schur_reduce.cu); every
                           LM iteration and the covariances of ops/ba.py.
                           It replaces no TPU kernel: the JAX package
                           builds this system in plain jnp;
  B8 ``sift_octave``       one SIFT octave's scale space: the Gaussian
                           ladder, DoGs, 3x3x3 extremum, contrast and edge
                           gates, response, 5x5 NMS, the continuous
                           interval and the next octave's base in one pass
                           (csrc/sift_octave.cu); every octave of
                           ops/sift.py. It replaces no TPU kernel: the JAX
                           package computes this in plain jnp;
  B9 ``pg_system``         the dense pose graph's LM system: each edge's
                           residual and closed-form Jacobian, the
                           preconditioned, damped normal equations and the
                           cost, and (its second entry point, ``pg_step``)
                           the retraction, trial cost and accept rule
                           (csrc/pose_graph.cu); every LM iteration and
                           covariance of ops/pose_graph.py. It replaces no
                           TPU kernel: the JAX package linearizes with
                           jax.jacfwd and assembles in plain jnp.

and ``stamp``, the card's clock written into a slot of a buffer
(csrc/stamp.cu): times inside a CUDA graph (the frontend's chunk).

The JAX package's two thin wrappers over its B2 have their counterparts
here and in ops/matching.py: ``nearest_neighbor`` below, and
``mutual_match_pallas``, whose counterpart is ``matching.mutual_match``
(B2 on the card, with the cross-check and the distance gate).

Each has a plain PyTorch version with the same signature (the wrapper's
name + ``_plain``). A wrapper takes the plain version only for tensors on
the CPU; for a CUDA tensor it launches its kernel or raises, on the
current stream. The kernels are built with ``nvcc`` for sm_90a at first
use, from the sources in ``csrc/`` (one ``nvcc`` per source, all at once,
then one link), into ``build/slam_tpu_torch/`` beside the package, and
bound through ctypes (plain C entry points that take the tensors' device
index and stream and return ``cudaError_t``).

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the plain
versions, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import akaze, features, se3, sift

BIG = 1e30
_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / n for n in (
    "detect_maps.cu", "mutual_nearest.cu", "akaze_octave.cu",
    "cholesky_solve.cu", "schur_reduce.cu", "sift_octave.cu", "pose_graph.cu",
    "stamp.cu"))
HEADERS = (_PKG / "csrc" / "launch.cuh",)
BUILD_DIR = _PKG.parent / "build" / "slam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("detect_maps", "mutual_nearest", "orientation_maps",
           "harris_response", "akaze_octave", "cholesky_solve",
           "schur_reduce", "sift_octave", "pg_system", "pg_step", "stamp")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
_lib = None
build_log = ""
# read from the library when it loads: B6's largest N, B5's most steps,
# B7's most pose rows, B9's most nodes
cholesky_max_n = 0
akaze_max_steps = 0
schur_max_poses = 0
pg_max_nodes = 0


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


def _run_all(cmds) -> str:
    """Run the commands at once; their output, in order. Raises if one
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    for proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    return log


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _lib, build_log, cholesky_max_n, akaze_max_steps, schur_max_poses
    global pg_max_nodes
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _find_nvcc(), f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
        tmp = out.with_name(f"{tag}.tmp.so")
        try:
            build_log = _run_all(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs))
            build_log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                                    *(str(o) for o in objs)]])
            os.replace(tmp, out)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every launch entry point ends with (device index, stream)
    lib.slam_detect_maps.argtypes = [p, p, p, p, i, i, i, f, p, p, i, p]
    lib.slam_harris_response.argtypes = [p, p, p, i, i, i, f, p, i, p]
    lib.slam_orientation_maps.argtypes = [p, p, i, i, i, p, i, p]
    lib.slam_akaze_octave.argtypes = [p, p, p, p, p, i, i, i, i, f, f, i, p]
    lib.slam_akaze_max_steps.argtypes = []
    lib.slam_akaze_static_path.argtypes = [i]
    lib.slam_cholesky_solve.argtypes = [p, p, p, i, i, i, p]
    lib.slam_cholesky_max_n.argtypes = []
    lib.slam_mutual_nearest.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f,
                                        f, p, p, p, p, p, i, p]
    lib.slam_schur_reduce.argtypes = [p, p, p, p, p, f, p, p, f, f, i, i, i,
                                      i, p, p, p, p, p, p, p, i, p]
    lib.slam_schur_back.argtypes = [p, p, p, p, p, i, i, i, i, p, i, p]
    lib.slam_schur_max_poses.argtypes = []
    lib.slam_sift_octave.argtypes = [p, p, p, p, p, i, i, i, i, p, p, f, f,
                                     i, p]
    lib.slam_pg_system.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, p, p,
                                   p, p, p, i, p]
    lib.slam_pg_step.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, p, p, i,
                                 p]
    lib.slam_pg_max_nodes.argtypes = []
    lib.slam_stamp.argtypes = [p, i, i, p]
    for fn in (lib.slam_detect_maps, lib.slam_harris_response,
               lib.slam_orientation_maps, lib.slam_akaze_octave,
               lib.slam_akaze_max_steps, lib.slam_akaze_static_path,
               lib.slam_cholesky_solve,
               lib.slam_cholesky_max_n, lib.slam_mutual_nearest,
               lib.slam_schur_reduce, lib.slam_schur_back,
               lib.slam_schur_max_poses, lib.slam_sift_octave,
               lib.slam_pg_system, lib.slam_pg_step, lib.slam_pg_max_nodes,
               lib.slam_stamp):
        fn.restype = i
    cholesky_max_n = lib.slam_cholesky_max_n()
    akaze_max_steps = lib.slam_akaze_max_steps()
    schur_max_poses = lib.slam_schur_max_poses()
    pg_max_nodes = lib.slam_pg_max_nodes()
    _lib = lib
    return lib


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's device, as the raw handle the kernels
    take (without building a torch.cuda.Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _require(cond: bool, msg: str, *args) -> None:
    """Raise ValueError(msg.format(*args)) unless cond: the message is
    built only on failure, as the wrappers run once per launch."""
    if not cond:
        raise ValueError(msg.format(*args))


# ---------------------------------------------------------------------------
# B1, B3, B4: detection maps (one template, csrc/detect_maps.cu)
# ---------------------------------------------------------------------------

def _check_images(imgs: torch.Tensor, name: str) -> bool:
    """Validate (F, H, W) float32 images; True when they lie on the card
    (launch the kernel), False on the CPU (run the plain version)."""
    _require(imgs.dim() == 3, "{}: expected (F, H, W), got {}", name,
             imgs.shape)
    _require(imgs.dtype == torch.float32, "{}: expected float32, got {}",
             name, imgs.dtype)
    if imgs.device.type == "cpu":
        return False
    _require(imgs.device.type == "cuda", "{}: unsupported device {}", name,
             imgs.device)
    _require(imgs.is_contiguous(), "{}: input must be contiguous", name)
    _require(min(imgs.shape) > 0, "{}: empty input", name)
    return True


@functools.lru_cache(maxsize=None)
def _taps(sigma: float):
    """Host-computed Gaussian taps (r 2) as a C float[5] pointer (which
    keeps its array alive): the plain versions blur with the same values.
    Built once per sigma."""
    taps = (ctypes.c_float * 5)(*features.gaussian_kernel1d(sigma, 2).tolist())
    return ctypes.cast(taps, ctypes.c_void_p)


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
    if not _check_images(imgs, "detect_maps"):
        return detect_maps_plain(imgs, k)
    F, H, W = imgs.shape
    lib = build()
    resp = torch.empty_like(imgs)
    nms = torch.empty_like(imgs)
    maps = torch.empty((F, 8, H, W), dtype=imgs.dtype, device=imgs.device)
    th, to = _taps(1.5), _taps(1.0)
    err = lib.slam_detect_maps(
        imgs.data_ptr(), resp.data_ptr(), nms.data_ptr(), maps.data_ptr(),
        F, H, W, float(k), th, to, imgs.device.index, _stream(imgs))
    _check(err, "detect_maps")
    LAUNCHES["detect_maps"] += 1
    return resp, nms, maps


def harris_response_plain(imgs: torch.Tensor, k: float = 0.05):
    """Plain version of B4: (resp, nms) (features.harris_response +
    features.nms)."""
    PLAIN_CALLS["harris_response"] += 1
    resp = features.harris_response(imgs, k)
    return resp, features.nms(resp)


def harris_response(imgs: torch.Tensor, k: float = 0.05):
    """Kernel B4, B1's Harris phase: (F, H, W) float32 -> resp and nms,
    each (F, H, W) float32 (pallas_kernels.harris_response_batch)."""
    if not _check_images(imgs, "harris_response"):
        return harris_response_plain(imgs, k)
    F, H, W = imgs.shape
    lib = build()
    resp = torch.empty_like(imgs)
    nms = torch.empty_like(imgs)
    th = _taps(1.5)
    err = lib.slam_harris_response(
        imgs.data_ptr(), resp.data_ptr(), nms.data_ptr(), F, H, W, float(k),
        th, imgs.device.index, _stream(imgs))
    _check(err, "harris_response")
    LAUNCHES["harris_response"] += 1
    return resp, nms


def orientation_maps_plain(imgs: torch.Tensor):
    """Plain version of B3: features.orientation_cell_maps."""
    PLAIN_CALLS["orientation_maps"] += 1
    return features.orientation_cell_maps(imgs)


def orientation_maps(imgs: torch.Tensor):
    """Kernel B3, B1's orientation phase: (F, H, W) float32 -> (F, 8, H, W)
    float32 (pallas_kernels.orientation_cell_maps_batch, unshifted)."""
    if not _check_images(imgs, "orientation_maps"):
        return orientation_maps_plain(imgs)
    F, H, W = imgs.shape
    lib = build()
    maps = torch.empty((F, 8, H, W), dtype=imgs.dtype, device=imgs.device)
    to = _taps(1.0)
    err = lib.slam_orientation_maps(imgs.data_ptr(), maps.data_ptr(), F, H,
                                    W, to, imgs.device.index, _stream(imgs))
    _check(err, "orientation_maps")
    LAUNCHES["orientation_maps"] += 1
    return maps


# ---------------------------------------------------------------------------
# B5: one AKAZE octave (csrc/akaze_octave.cu)
# ---------------------------------------------------------------------------

def akaze_octave_plain(imgs: torch.Tensor, k: torch.Tensor, steps: int = 6,
                       tau: float = 0.2, sigma: float = 1.6):
    """Plain version of B5: (L, resp, nms) = akaze.diffuse,
    akaze._hessian_response and features.nms."""
    PLAIN_CALLS["akaze_octave"] += 1
    L = akaze.diffuse(imgs, k, steps, tau)
    resp = akaze._hessian_response(L, sigma)
    return L, resp, features.nms(resp)


def akaze_octave(imgs: torch.Tensor, k: torch.Tensor, steps: int = 6,
                 tau: float = 0.2, sigma: float = 1.6):
    """Kernel B5: (F, H, W) float32 images and their (F,) float32 PM
    contrasts ``k`` (on the images' device) -> the diffused L, the
    scale-normalized Hessian response and its NMS map, each (F, H, W)
    float32 (pallas_kernels.akaze_octave_batch, with features.nms's -inf
    outside the image). ``steps == 6`` takes the kernel's compile-time
    instantiation, any other count its run-time path. Raises ValueError
    for more steps than one block's shared memory holds
    (``akaze_max_steps``, read from the library). Besides the launch it
    makes no ctypes call."""
    on_card = _check_images(imgs, "akaze_octave")
    _require(k.shape == imgs.shape[:1] and k.dtype == torch.float32
             and k.device == imgs.device,
             "akaze_octave: k must be float32 ({},) on {}", imgs.shape[0],
             imgs.device)
    _require(steps >= 0, "akaze_octave: steps={} < 0", steps)
    if not on_card:
        return akaze_octave_plain(imgs, k, steps, tau, sigma)
    F, H, W = imgs.shape
    lib = build()
    _require(steps <= akaze_max_steps, "akaze_octave: steps={} above the {} "
             "one block's shared memory holds", steps, akaze_max_steps)
    k = k.contiguous()
    L = torch.empty_like(imgs)
    resp = torch.empty_like(imgs)
    nms = torch.empty_like(imgs)
    err = lib.slam_akaze_octave(
        imgs.data_ptr(), k.data_ptr(), L.data_ptr(), resp.data_ptr(),
        nms.data_ptr(), F, H, W, int(steps), float(tau), float(sigma) ** 4,
        imgs.device.index, _stream(imgs))
    _check(err, "akaze_octave")
    LAUNCHES["akaze_octave"] += 1
    return L, resp, nms


# ---------------------------------------------------------------------------
# B2: one-pass mutual nearest neighbours
# ---------------------------------------------------------------------------

def _check_match_inputs(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b,
                        window):
    _require(desc_a.dim() == 3 and desc_b.dim() == 3,
             "mutual_nearest: descriptors must be (B, K, D)")
    B, Ka, D = desc_a.shape
    _require(desc_b.shape[0] == B and desc_b.shape[2] == D,
             "mutual_nearest: shapes {} vs {}", desc_a.shape, desc_b.shape)
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
    dev = desc_a.device
    ins = (desc_b, valid_a, valid_b) + ((xy_a, xy_b) if window is not None
                                        else ())
    _require(all(t.device == dev for t in ins),
             "mutual_nearest: tensors on several devices {}",
             [str(t.device) for t in (desc_a,) + ins])
    return B, Ka, Kb, D


def window_distances(desc_a, desc_b, xy_a=None, xy_b=None, window=None):
    """(B, Ka, Kb) distances ``2 - 2 a.b`` of bf16-rounded descriptors,
    +BIG for pairs outside the guided window ``(dx_min, dx_max, dy_max)``
    (candidate j is admissible for query i iff x_b[j] - x_a[i] is in
    [dx_min, dx_max] and |y_b[j] - y_a[i]| <= dy_max): the matrix both
    reductions of B2 read, before the validity penalties."""
    from .matching import window_penalty

    a = desc_a.to(torch.bfloat16).float()
    b = desc_b.to(torch.bfloat16).float()
    base = 2.0 - 2.0 * torch.matmul(a, b.transpose(1, 2))
    return base + window_penalty(xy_a, xy_b, window, big=BIG)


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
    _require(dev.type == "cuda", "mutual_nearest: unsupported device {}", dev)
    _require(D % 16 == 0 and 0 < D <= 256,
             "mutual_nearest: D={} must be a multiple of 16 up to 256", D)
    _require(Ka > 0 and Kb > 0, "mutual_nearest: empty descriptor set")
    ins = (desc_a, desc_b, valid_a, valid_b) + (
        (xy_a, xy_b) if window is not None else ())
    _require(all(t.is_contiguous() for t in ins),
             "mutual_nearest: inputs must be contiguous")
    lib = build()
    a = desc_a.to(torch.bfloat16)
    b = desc_b.to(torch.bfloat16)
    win = (0.0, 0.0, 0.0) if window is None else tuple(float(v) for v in window)
    xa = xy_a.data_ptr() if window is not None else None
    xb = xy_b.data_ptr() if window is not None else None
    colbest = torch.empty((B, Kb), dtype=torch.int64, device=dev)
    rdist = torch.empty((B, Ka), dtype=torch.float32, device=dev)
    ridx = torch.empty((B, Ka), dtype=torch.int64, device=dev)
    cdist = torch.empty((B, Kb), dtype=torch.float32, device=dev)
    cidx = torch.empty((B, Kb), dtype=torch.int64, device=dev)
    err = lib.slam_mutual_nearest(
        a.data_ptr(), b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(), xa,
        xb, B, Ka, Kb, D, int(window is not None), *win, colbest.data_ptr(),
        rdist.data_ptr(), ridx.data_ptr(), cdist.data_ptr(), cidx.data_ptr(),
        dev.index, _stream(a))
    _check(err, "mutual_nearest")
    LAUNCHES["mutual_nearest"] += 1
    return rdist, ridx, cdist, cidx


def nearest_neighbor(desc_a, desc_b, valid_b):
    """Row-wise nearest neighbours (dist, idx) of A in the valid rows of B
    (the JAX package's ``nearest_neighbor``): kernel B2 with every row of
    A valid, its column reduction dropped. One pair (K, D) or a batch of
    pairs (B, K, D)."""
    single = desc_a.dim() == 2
    if single:
        desc_a, desc_b, valid_b = desc_a[None], desc_b[None], valid_b[None]
    valid_a = torch.ones(desc_a.shape[:2], dtype=torch.bool,
                         device=desc_a.device)
    rdist, ridx, _, _ = mutual_nearest(desc_a, desc_b, valid_a, valid_b)
    return (rdist[0], ridx[0]) if single else (rdist, ridx)


# ---------------------------------------------------------------------------
# B6: batched Cholesky solve (csrc/cholesky_solve.cu)
# ---------------------------------------------------------------------------

def cholesky_solve_plain(S: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: S x = g by ``torch.linalg.cholesky_ex`` +
    ``cholesky_solve``, with a NaN row wherever the factorization fails."""
    PLAIN_CALLS["cholesky_solve"] += 1
    Lc, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(g[..., None], Lc)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.full_like(x, float("nan")))


def cholesky_solve(S: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel B6: S (B, N, N) float32 SPD (its lower triangle is read) and
    g (B, N) float32 -> x (B, N) float32 with S x = g, refined once
    against the residual summed in float64 (csrc/cholesky_solve.cu); a
    system whose factorization meets a pivot that is not positive or not
    finite gets an all-NaN row (pallas_kernels.cholesky_solve_lanes,
    which clamps such a pivot instead). Raises ValueError for N above what one block's
    shared memory holds (``cholesky_max_n``, 221 on an H100). Besides
    the launch it makes no ctypes call."""
    _require(S.dim() == 3 and S.shape[1] == S.shape[2],
             "cholesky_solve: S must be (B, N, N), got {}", S.shape)
    B, N = S.shape[0], S.shape[1]
    _require(g.shape == (B, N), "cholesky_solve: g must be ({}, {}), got {}",
             B, N, g.shape)
    _require(S.dtype == torch.float32 and g.dtype == torch.float32,
             "cholesky_solve: expected float32, got {}, {}", S.dtype, g.dtype)
    dev = S.device
    _require(g.device == dev, "cholesky_solve: S on {}, g on {}", dev,
             g.device)
    if dev.type == "cpu":
        return cholesky_solve_plain(S, g)
    _require(dev.type == "cuda", "cholesky_solve: unsupported device {}", dev)
    _require(S.is_contiguous() and g.is_contiguous(),
             "cholesky_solve: inputs must be contiguous")
    _require(B > 0 and N > 0, "cholesky_solve: empty input")
    lib = build()
    _require(N <= cholesky_max_n, "cholesky_solve: N={} above the {} one "
             "block's shared memory holds", N, cholesky_max_n)
    x = torch.empty_like(g)
    err = lib.slam_cholesky_solve(S.data_ptr(), g.data_ptr(), x.data_ptr(),
                                  B, N, dev.index, _stream(S))
    _check(err, "cholesky_solve")
    LAUNCHES["cholesky_solve"] += 1
    return x


# ---------------------------------------------------------------------------
# B7: the reduced pose system of bundle adjustment (csrc/schur_reduce.cu)
# ---------------------------------------------------------------------------

def schur_reduce_plain(poses, points, cam_idx, lm_idx, meas, w, calib, slot,
                       lam=None, eps_l: float = 1e-8, eps_s: float = 0.0,
                       huber_delta: float = 0.0):
    """Plain version of B7: ``ops.ba``'s linearization and dense blocks
    (``_linearize``, ``_build_blocks``, ``_damped_system``). Returns (S,
    ghat, Hll_inv, g_l, Bm), the cross blocks as the dense Bm (B, 6P, 3L)
    that ``schur_back_plain`` reads; ``slot`` gives only P and L."""
    from . import ba

    PLAIN_CALLS["schur_reduce"] += 1
    L, P = slot.shape[1], slot.shape[2]
    J_pose, J_lm, r = ba._linearize(poses, points, cam_idx, lm_idx, meas, w,
                                    calib, huber_delta)
    blocks = ba._build_blocks(J_pose, J_lm, r, cam_idx, lm_idx, P, L)
    S, ghat, Bm, Hll_inv = ba._damped_system(blocks, lam, eps_l, eps_s)
    return S, ghat, Hll_inv, blocks[1], Bm


def schur_reduce(poses, points, cam_idx, lm_idx, meas, w, calib, slot,
                 lam=None, eps_l: float = 1e-8, eps_s: float = 0.0,
                 huber_delta: float = 0.0):
    """Kernel B7: the reduced pose system of a batch of bundle windows,
    linearized at their state and built from their observations
    (csrc/schur_reduce.cu). The arguments of ``ops.ba.optimize_bundle``
    (poses (B, P, 4, 4), points (B, L, 3), cam_idx, lm_idx (B, M), meas
    (B, M, 3), w (B, M), calib (5,), float32; the indices read only by the
    plain version), then slot (B, L, P) int32 from ``ops.ba._slot_table``,
    lam (B,) float32 or None for no damping, and ``huber_delta`` (IRLS
    Huber weights when > 0). Returns (S (B, 6P, 6P), ghat (B, 6P),
    Hll_inv (B, L, 3, 3), g_l (B, L, 3), W (B, M, 6, 3)): the damped Schur
    complement on the poses (Hpp + lam I, Hll + lam I + eps_l I), gauge
    rows identity and eps_s added to the diagonal, exactly symmetric;
    ``schur_back`` takes the last three. Raises ValueError for more pose
    rows than the kernel (``schur_max_poses``) or B6 (``cholesky_max_n``)
    takes. Besides the launches it makes no ctypes call."""
    _require(poses.dim() == 4 and poses.shape[2:] == (4, 4),
             "schur_reduce: poses must be (B, P, 4, 4), got {}", poses.shape)
    B, P = poses.shape[:2]
    _require(points.dim() == 3 and points.shape[0] == B
             and points.shape[2] == 3,
             "schur_reduce: points must be ({}, L, 3), got {}", B,
             points.shape)
    L = points.shape[1]
    _require(meas.dim() == 3 and meas.shape[0] == B and meas.shape[2] == 3
             and w.shape == meas.shape[:2],
             "schur_reduce: meas {} and w {} do not match", meas.shape,
             w.shape)
    M = w.shape[1]
    _require(slot.shape == (B, L, P),
             "schur_reduce: slot must be ({}, {}, {}), got {}", B, L, P,
             slot.shape)
    dev = poses.device
    _require(all(t.device == dev for t in (points, meas, w, calib, slot)),
             "schur_reduce: tensors on several devices")
    if dev.type == "cpu":
        return schur_reduce_plain(poses, points, cam_idx, lm_idx, meas, w,
                                  calib, slot, lam, eps_l, eps_s,
                                  huber_delta)
    _require(dev.type == "cuda", "schur_reduce: unsupported device {}", dev)
    _require(all(t.dtype == torch.float32
                 for t in (poses, points, meas, w, calib))
             and slot.dtype == torch.int32 and calib.shape == (5,),
             "schur_reduce: expected float32 state and calib (5,) and an "
             "int32 slot table")
    _require(B > 0 and M > 0 and L > 0 and P > 0, "schur_reduce: empty input")
    if lam is not None:
        _require(lam.shape == (B,) and lam.dtype == torch.float32
                 and lam.device == dev,
                 "schur_reduce: lam must be float32 ({},) on {}", B, dev)
        lam = lam.contiguous()
    lib = build()
    _require(P <= schur_max_poses and 6 * P <= cholesky_max_n,
             "schur_reduce: P={} above the {} pose rows B7 and B6 take", P,
             min(schur_max_poses, cholesky_max_n // 6))
    poses, points, meas, w, calib, slot = (
        t.contiguous() for t in (poses, points, meas, w, calib, slot))
    N = 6 * P
    J_pose = torch.empty((B, M, 3, 6), dtype=torch.float32, device=dev)
    r = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    W = torch.empty((B, M, 6, 3), dtype=torch.float32, device=dev)
    Hll_inv = torch.empty((B, L, 3, 3), dtype=torch.float32, device=dev)
    g_l = torch.empty((B, L, 3), dtype=torch.float32, device=dev)
    S = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    ghat = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = lib.slam_schur_reduce(
        poses.data_ptr(), points.data_ptr(), meas.data_ptr(), w.data_ptr(),
        calib.data_ptr(), float(huber_delta), slot.data_ptr(),
        None if lam is None else lam.data_ptr(), float(eps_l), float(eps_s),
        B, L, P, M, J_pose.data_ptr(), r.data_ptr(), W.data_ptr(),
        Hll_inv.data_ptr(), g_l.data_ptr(), S.data_ptr(), ghat.data_ptr(),
        dev.index, _stream(poses))
    _check(err, "schur_reduce")
    LAUNCHES["schur_reduce"] += 1
    return S, ghat, Hll_inv, g_l, W


def schur_back_plain(dp, slot, cross, Hll_inv, g_l):
    """Plain version of B7's landmark steps: ``ops.ba._back_substitute``
    on the dense Bm (``cross``) of ``schur_reduce_plain``. Counted with
    the reduction it belongs to, not on its own."""
    from . import ba

    return ba._back_substitute(dp, cross, Hll_inv, g_l)


def schur_back(dp, slot, cross, Hll_inv, g_l):
    """B7's second entry point: the landmark steps dl (B, L, 3) =
    -Hll_inv (g_l + sum_p W_pl^T dp_p) from the pose step dp (B, 6P) and
    ``schur_reduce``'s last three outputs (``cross`` is its W on the
    card, the dense Bm of its plain version on the CPU). One launch,
    counted with the reduction's (``LAUNCHES["schur_reduce"]``)."""
    if dp.device.type == "cpu":
        return schur_back_plain(dp, slot, cross, Hll_inv, g_l)
    B, L, P = slot.shape
    M = cross.shape[1]
    _require(dp.shape == (B, 6 * P) and dp.dtype == torch.float32,
             "schur_back: dp must be float32 ({}, {}), got {}", B, 6 * P,
             dp.shape)
    _require(cross.shape == (B, M, 6, 3) and Hll_inv.shape == (B, L, 3, 3)
             and g_l.shape == (B, L, 3),
             "schur_back: W, Hll_inv, g_l are not schur_reduce's")
    lib = build()
    dp = dp.contiguous()
    dl = torch.empty((B, L, 3), dtype=torch.float32, device=dp.device)
    err = lib.slam_schur_back(slot.data_ptr(), cross.data_ptr(),
                              Hll_inv.data_ptr(), g_l.data_ptr(),
                              dp.data_ptr(), B, L, P, M, dl.data_ptr(),
                              dp.device.index, _stream(dp))
    _check(err, "schur_back")
    return dl


# ---------------------------------------------------------------------------
# B8: one SIFT octave's scale space (csrc/sift_octave.cu)
# ---------------------------------------------------------------------------

def sift_octave_plain(level: torch.Tensor, contrast: float,
                      intervals: int = sift.INTERVALS, last: bool = False):
    """Plain version of B8: (resp, nms, s, next) = sift's ladder
    (``gaussian_pyramid_octave``), its DoGs, ``_octave_response``,
    ``features.nms``, the per-pixel interval ``_interval_map`` and, unless
    ``last``, the next octave's base (else None)."""
    PLAIN_CALLS["sift_octave"] += 1
    gauss = sift.gaussian_pyramid_octave(level, intervals)
    dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
    resp, best_i = sift._octave_response(dogs, contrast)
    # gauss[intervals] has sigma 2 sigma0: decimation alone keeps the
    # ladder exact (sigma0 at half resolution)
    nxt = None if last else gauss[intervals][..., ::2, ::2].contiguous()
    return (resp, features.nms(resp), sift._interval_map(dogs, best_i),
            nxt)


@functools.lru_cache(maxsize=None)
def _sift_ladder(intervals: int):
    """The ladder of ``intervals`` as B8 takes it: the blur count, their
    radii (C int[]) and their float32 taps in turn (C float[]; both keep
    their arrays alive), the taps the plain version blurs with. Built
    once per interval count."""
    ladder = sift.blur_ladder(intervals)
    radii = [r for _, r in ladder]
    taps = [v for sig, r in ladder
            for v in features.gaussian_kernel1d(sig, r).tolist()]
    return (len(ladder),
            ctypes.cast((ctypes.c_int * len(radii))(*radii), ctypes.c_void_p),
            ctypes.cast((ctypes.c_float * len(taps))(*taps), ctypes.c_void_p))


def sift_octave(level: torch.Tensor, contrast: float,
                intervals: int = sift.INTERVALS, last: bool = False):
    """Kernel B8: one SIFT octave from its (F, H, W) float32 base level
    (csrc/sift_octave.cu). Returns resp, nms and s, each (F, H, W)
    float32 (the octave's response, its 5x5 NMS map and every pixel's
    continuous interval), and the next octave's base, (F, ceil(H/2),
    ceil(W/2)) float32, or None when ``last``. B8's extremum and edge
    tests read the DoG outside the image as 0 where the plain version
    reads -inf and wraps: resp differs only on the image's outer 1-pixel
    frame and nms within 3 pixels of the edge. Raises ValueError for a
    ladder the kernel does not take (intervals 2 to 5). Besides the launch
    it makes no ctypes call after the first at an interval count."""
    if not _check_images(level, "sift_octave"):
        return sift_octave_plain(level, contrast, intervals, last)
    F, H, W = level.shape
    lib = build()
    _require(2 <= intervals <= 5, "sift_octave: intervals={} is outside "
             "the ladders B8 takes (2 to 5)", intervals)
    nb, radii, taps = _sift_ladder(intervals)
    resp = torch.empty_like(level)
    nms = torch.empty_like(level)
    s = torch.empty_like(level)
    nxt = None if last else torch.empty(
        (F, (H + 1) // 2, (W + 1) // 2), dtype=level.dtype,
        device=level.device)
    err = lib.slam_sift_octave(
        level.data_ptr(), resp.data_ptr(), nms.data_ptr(), s.data_ptr(),
        None if last else nxt.data_ptr(), F, H, W, nb, radii, taps,
        float(contrast), (sift.EDGE_R + 1.0) ** 2 / sift.EDGE_R,
        level.device.index, _stream(level))
    _check(err, "sift_octave")
    LAUNCHES["sift_octave"] += 1
    return resp, nms, s, nxt


# ---------------------------------------------------------------------------
# B9: the dense pose graph's LM system and step (csrc/pose_graph.cu)
# ---------------------------------------------------------------------------

def pg_system_plain(nodes, e_i, e_j, Z_inv, sqrt_info, wE, mask, lam):
    """Plain version of B9's system: ``ops.pose_graph``'s forward-mode
    linearization (``_weighted_res_jac``), ``_assemble`` and
    ``_precondition``, ``lam`` added to the diagonal, and ``_cost`` at
    ``nodes``."""
    from . import pose_graph as pg

    PLAIN_CALLS["pg_system"] += 1
    N = nodes.shape[0]
    r, Ji, Jj = pg._weighted_res_jac(nodes, e_i, e_j, Z_inv, sqrt_info, wE)
    H, g = pg._assemble(N, e_i, e_j, Ji, Jj, r)
    Hs, dscale = pg._precondition(H, mask)
    eye = torch.eye(6 * N, dtype=H.dtype, device=H.device)
    return (Hs + lam * eye, dscale * g * mask, dscale,
            pg._cost(nodes, e_i, e_j, Z_inv, sqrt_info, wE))


def pg_step_plain(nodes, x, dscale, cost, lam, e_i, e_j, Z_inv, sqrt_info,
                  wE) -> None:
    """Plain version of B9's step: ``optimize``'s retraction by -(dscale
    x), the trial cost and its accept rule, written into ``nodes``,
    ``cost`` and ``lam``."""
    from . import pose_graph as pg

    PLAIN_CALLS["pg_step"] += 1
    N = nodes.shape[0]
    new_nodes = se3.retract(nodes, -(dscale * x).reshape(N, 6))
    new_cost = pg._cost(new_nodes, e_i, e_j, Z_inv, sqrt_info, wE)
    ok = torch.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
    nodes.copy_(torch.where(ok, new_nodes, nodes))
    lam.copy_(torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4)))
    cost.copy_(torch.where(ok, new_cost, cost))


def _pg_edges(name, nodes, e_i, e_j, Z_inv, sqrt_info, wE):
    """(N, E, device) of B9's node and edge arguments, checked."""
    _require(nodes.dim() == 3 and nodes.shape[1:] == (4, 4),
             "{}: nodes must be (N, 4, 4), got {}", name, tuple(nodes.shape))
    N, E = nodes.shape[0], e_i.shape[0]
    _require(e_i.dim() == 1 and e_j.shape == (E,)
             and Z_inv.shape == (E, 4, 4) and sqrt_info.shape == (E, 6, 6)
             and wE.shape == (E,),
             "{}: e_j, Z_inv, sqrt_info and wE do not match e_i ({},)", name,
             E)
    dev = nodes.device
    _require(all(t.device == dev for t in (e_i, e_j, Z_inv, sqrt_info, wE)),
             "{}: tensors on several devices", name)
    if dev.type == "cuda":
        _require(all(t.dtype == torch.float32
                     for t in (nodes, Z_inv, sqrt_info, wE))
                 and not e_i.is_floating_point()
                 and not e_j.is_floating_point(),
                 "{}: expected float32 nodes and edges, integer indices",
                 name)
        _require(N > 0, "{}: no nodes", name)
    return N, E, dev


def pg_system(nodes, e_i, e_j, Z_inv, sqrt_info, wE, mask, lam):
    """Kernel B9: the dense pose graph's LM system at ``nodes`` (csrc/
    pose_graph.cu). Nodes (N, 4, 4), the edges e_i, e_j (E,), Z_inv (E, 4,
    4), sqrt_info (E, 6, 6) and their weights wE (E,) (0: padding), the
    node mask (6N,) (0: the gauge node and padded nodes) and the damping
    lam, a 0-dim tensor on the nodes' device (read there, so a CUDA graph
    holds it). Returns (A, rhs, dscale, cost): A (6N, 6N) = the Jacobi-
    preconditioned masked Gauss-Newton matrix + lam I, rhs = dscale g mask
    (6N,), dscale (6N,) and the cost at ``nodes`` (0-dim), float32. The
    kernel's Jacobians are closed-form, computed in float64 (the plain
    version's are forward-mode in float32), its sums in one fixed order,
    and its A exactly symmetric. Raises ValueError for more nodes than it
    takes (``pg_max_nodes``). Besides the launches it makes no ctypes
    call."""
    N, E, dev = _pg_edges("pg_system", nodes, e_i, e_j, Z_inv, sqrt_info, wE)
    _require(mask.shape == (6 * N,) and lam.dim() == 0
             and mask.device == dev and lam.device == dev,
             "pg_system: mask must be ({},) and lam 0-dim, on {}", 6 * N, dev)
    if dev.type == "cpu":
        return pg_system_plain(nodes, e_i, e_j, Z_inv, sqrt_info, wE, mask,
                               lam)
    _require(dev.type == "cuda", "pg_system: unsupported device {}", dev)
    _require(mask.dtype == torch.float32 and lam.dtype == torch.float32,
             "pg_system: mask and lam must be float32")
    lib = build()
    _require(N <= pg_max_nodes, "pg_system: N={} above the {} nodes B9 "
             "takes", N, pg_max_nodes)
    nodes, Z_inv, sqrt_info, wE, mask = (
        t.contiguous() for t in (nodes, Z_inv, sqrt_info, wE, mask))
    e_i, e_j = e_i.long().contiguous(), e_j.long().contiguous()
    f32, f64 = torch.float32, torch.float64
    A = torch.empty((6 * N, 6 * N), dtype=f32, device=dev)
    rhs = torch.empty(6 * N, dtype=f32, device=dev)
    dscale = torch.empty(6 * N, dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    diag = torch.empty((N, 36), dtype=f32, device=dev)
    Pe = torch.empty((max(E, 1), 21), dtype=f64, device=dev)
    ce = torch.empty(max(E, 1), dtype=f64, device=dev)
    err = lib.slam_pg_system(
        nodes.data_ptr(), e_i.data_ptr(), e_j.data_ptr(), Z_inv.data_ptr(),
        sqrt_info.data_ptr(), wE.data_ptr(), mask.data_ptr(), lam.data_ptr(),
        N, E, A.data_ptr(), rhs.data_ptr(), dscale.data_ptr(),
        cost.data_ptr(), diag.data_ptr(), Pe.data_ptr(), ce.data_ptr(),
        dev.index, _stream(nodes))
    _check(err, "pg_system")
    LAUNCHES["pg_system"] += 1
    return A, rhs, dscale, cost


def pg_step(nodes, x, dscale, cost, lam, e_i, e_j, Z_inv, sqrt_info,
            wE) -> None:
    """B9's second entry point, one launch: retract every node by -(dscale
    x) (x (6N,) the solution of ``pg_system``'s A x = rhs), evaluate the
    trial cost and apply ``optimize``'s accept rule (finite and below
    cost (1 - 1e-3)); ``nodes``, ``cost`` and ``lam`` (contiguous float32,
    0-dim the last two) are written in place: the trial nodes, the trial
    cost and lam / 3 (at least 1e-9) if accepted, else lam x 5 (at most
    1e4)."""
    N, E, dev = _pg_edges("pg_step", nodes, e_i, e_j, Z_inv, sqrt_info, wE)
    _require(x.shape == (6 * N,) and dscale.shape == (6 * N,)
             and cost.dim() == 0 and lam.dim() == 0
             and all(t.device == dev for t in (x, dscale, cost, lam)),
             "pg_step: x and dscale must be ({},), cost and lam 0-dim, on {}",
             6 * N, dev)
    if dev.type == "cpu":
        return pg_step_plain(nodes, x, dscale, cost, lam, e_i, e_j, Z_inv,
                             sqrt_info, wE)
    _require(dev.type == "cuda", "pg_step: unsupported device {}", dev)
    _require(all(t.dtype == torch.float32 for t in (x, dscale, cost, lam))
             and all(t.is_contiguous() for t in (nodes, cost, lam)),
             "pg_step: nodes, cost and lam must be contiguous float32 (they "
             "are written in place)")
    lib = build()
    _require(N <= pg_max_nodes, "pg_step: N={} above the {} nodes B9 takes",
             N, pg_max_nodes)
    x, dscale, Z_inv, sqrt_info, wE = (
        t.contiguous() for t in (x, dscale, Z_inv, sqrt_info, wE))
    e_i, e_j = e_i.long().contiguous(), e_j.long().contiguous()
    trial = torch.empty_like(nodes)
    ce = torch.empty(max(E, 1), dtype=torch.float64, device=dev)
    err = lib.slam_pg_step(
        nodes.data_ptr(), x.data_ptr(), dscale.data_ptr(), cost.data_ptr(),
        lam.data_ptr(), e_i.data_ptr(), e_j.data_ptr(), Z_inv.data_ptr(),
        sqrt_info.data_ptr(), wE.data_ptr(), N, E, trial.data_ptr(),
        ce.data_ptr(), dev.index, _stream(nodes))
    _check(err, "pg_step")
    LAUNCHES["pg_step"] += 1


# ---------------------------------------------------------------------------
# the clock stamp (csrc/stamp.cu)
# ---------------------------------------------------------------------------

def stamp_plain(buf: torch.Tensor, i: int) -> None:
    """Plain version of ``stamp``: the host's ``time.perf_counter_ns()``
    into ``buf[i]``."""
    PLAIN_CALLS["stamp"] += 1
    buf[i] = time.perf_counter_ns()


def stamp(buf: torch.Tensor, i: int) -> None:
    """Write the clock in nanoseconds into slot ``i`` of ``buf``, a 1-D
    int64 tensor: on the card its global timer, from one thread launched
    on the current stream (after the work queued before it, before the
    work queued after it; no host read, so a CUDA graph can hold it); on
    the CPU the host's ``perf_counter_ns``. Differences of two stamps of
    one device are durations; stamps of two devices do not compare."""
    _require(buf.dim() == 1 and buf.dtype == torch.int64,
             "stamp: buf must be 1-D int64, got {} {}", buf.dtype,
             tuple(buf.shape))
    _require(0 <= i < buf.shape[0], "stamp: slot {} of {}", i, buf.shape[0])
    dev = buf.device
    if dev.type == "cpu":
        return stamp_plain(buf, i)
    _require(dev.type == "cuda", "stamp: unsupported device {}", dev)
    lib = build()
    _check(lib.slam_stamp(buf.data_ptr(), i, dev.index, _stream(buf)),
           "stamp")
    LAUNCHES["stamp"] += 1
