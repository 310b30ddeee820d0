"""Kernel B8 (``sift_octave``: one SIFT octave's Gaussian ladder, DoGs,
extremum, contrast and edge gates, response, 5x5 NMS and scale map in
one pass) against its roofline, in the profiled pass.

Per frontend chunk B8 runs once per octave, in octave order, on
(2 x chunk_frames, H_o, W_o) float32: the x2-upsampled first octave
(2H, 2W), then H_o = ceil(H_{o-1} / 2), num_levels + 1 octaves (the
frontend's ``detector_levels`` for SIFT). Bytes: the base read, resp,
nms and the scale map written (4 planes), and every octave but the last
writes the next base, (ceil(H_o / 2), ceil(W_o / 2)). Operations: the
blurs' 134 multiply-adds a pixel (radii 4, 5, 6, 7, 9, both passes) and
the 5 DoG subtractions, 273 float32 operations a pixel: what any
implementation must do (``chip_smoke.py``'s ``b8_bound``). The share is
the launches' least time over their device time.
"""

from harness import peaks

NAMES = ("sift_octave_kernel<",)
OPS_PER_PIXEL = 273


def octave_seconds(ctx) -> list:
    features = ctx.settings["features"]
    H, W = ctx.image_hw
    H, W = 2 * H, 2 * W
    B = 2 * ctx.settings["runtime"]["chunk_frames"]
    octaves = max(features["num_levels"], 3) + 1
    out = []
    for o in range(octaves):
        Hn, Wn = (H + 1) // 2, (W + 1) // 2
        px = B * H * W
        n_bytes = 4 * px * 4 + (4 * B * Hn * Wn if o + 1 < octaves else 0)
        out.append(peaks.least_seconds(n_bytes, OPS_PER_PIXEL * px))
        H, W = Hn, Wn
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
