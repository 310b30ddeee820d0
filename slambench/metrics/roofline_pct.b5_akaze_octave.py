"""Kernel B5 (``akaze_octave``: the PM-g2 diffusion steps, the
scale-normalised Hessian and its 5x5 NMS of one AKAZE octave) against its
roofline, in the profiled pass.

Per frontend chunk B5 runs once per octave, in octave order, on
(2 x chunk_frames, H_o, W_o) float32, H_o = ceil(H / 2^o): 1 plane and
the per-image contrasts read, 3 planes written (diffused image,
response, NMS map), 155 float32 operations per pixel (``chip_smoke.py``).
The share is the launches' least time over their device time.
"""

from harness import peaks

NAMES = ("akaze_octave_kernel<",)
OPS_PER_PIXEL = 155


def octave_seconds(ctx) -> list:
    H, W = ctx.image_hw
    B = 2 * ctx.settings["runtime"]["chunk_frames"]
    out = []
    for _ in range(ctx.settings["features"]["num_levels"]):
        px = B * H * W
        out.append(peaks.least_seconds(4 * px * 4 + 4 * B,
                                       OPS_PER_PIXEL * px))
        H, W = (H + 1) // 2, (W + 1) // 2
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    ev = ctx.trace.kernels(NAMES)
    per_chunk = octave_seconds(ctx)
    if not ev or len(ev) % len(per_chunk):
        return None
    busy = sum(e.dur_us for e in ev) * 1e-6
    return 100.0 * (len(ev) // len(per_chunk)) * sum(per_chunk) / busy
