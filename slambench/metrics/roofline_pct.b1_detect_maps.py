"""Kernel B1 (``detect_maps``: Harris response, 5x5 NMS and 8
orientation cell maps in one pass) against its roofline, in the profiled
pass.

Each launch takes one frontend chunk's left and right images,
(2 x chunk_frames, H, W) float32 (the chunk's tail is zero-padded, so
every launch has this shape): 1 plane read, 10 written (response, NMS
map, 8 cell maps), 300 float32 operations per pixel (``chip_smoke.py``'s
``OPS_PER_PIXEL``). The least time of a launch is the larger of bytes
over the memory rate and operations over the float32 peak; the share is
the launches' least time over their device time.
"""

from harness import peaks

NAMES = ("maps_kernel<true, true>",)
OPS_PER_PIXEL = 300
PLANES = 11


def least_seconds(ctx) -> float:
    H, W = ctx.image_hw
    px = 2 * ctx.settings["runtime"]["chunk_frames"] * H * W
    return peaks.least_seconds(4 * px * PLANES, OPS_PER_PIXEL * px)


def read(ctx):
    if ctx.trace is None:
        return None
    ev = ctx.trace.kernels(NAMES)
    if not ev:
        return None
    busy = sum(e.dur_us for e in ev) * 1e-6
    return 100.0 * len(ev) * least_seconds(ctx) / busy
