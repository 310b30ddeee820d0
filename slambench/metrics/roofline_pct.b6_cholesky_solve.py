"""Kernel B6 (``cholesky_solve``: batched Cholesky factorisation and both
substitutions of BA's reduced pose systems, refined once) against its
roofline, in the profiled pass.

A launch solves B systems S x = g of size N: the window BA's at N = 6 x
max_poses (the kernel's block-wide instance), B the windows of the
profiled sequence's slices (at most ``optimize_windows``' 64 a slice, the
tail slice padded to the same B); loop closure's pair at N = 12, B = 1
(the one-warp instance, ``<32>``). Counted as ``chip_smoke.py``'s ``b6_bound``: S's
lower triangle read, g read, x written, N^3 / 3 + 2 N^2 float32
operations per system. The share is the launches' least time over their
device time.
"""

from harness import peaks

NAMES = ("cholesky_solve_kernel<",)
WARP = "cholesky_solve_kernel<32>"
PAIR_N = 12
DEVICE_BATCH = 64


def least_seconds(B: int, N: int) -> float:
    tri = B * N * (N + 1) // 2 * 4
    return peaks.least_seconds(tri + 2 * B * N * 4,
                               B * (N ** 3 / 3 + 2 * N ** 2))


def systems(ctx, ev):
    """B of one launch, from the interface and the sequence it ran in."""
    if WARP in ev.name:
        return 1
    k = ctx.trace.sequence_of(ev)
    if k is None or k >= len(ctx.trace.sequences):
        return None
    return min(DEVICE_BATCH, ctx.trace.sequences[k]["windows"])


def read(ctx):
    if ctx.trace is None:
        return None
    ev = ctx.trace.kernels(NAMES)
    bs = [systems(ctx, e) for e in ev]
    if not ev or None in bs:
        return None
    n_window = 6 * ctx.settings["bundle"]["max_poses"]
    least = sum(least_seconds(b, PAIR_N if WARP in e.name else n_window)
                for e, b in zip(ev, bs))
    return 100.0 * least / (sum(e.dur_us for e in ev) * 1e-6)
