"""Frontend milliseconds per frame in which the host is blocked on the
card, in-memory input: every ``frontend.….wait`` span of the program's
timings (an upload's or a chunk's event synchronised, the checkpoint's
read of the carry) summed over the window's in-memory sequences, over
their frames. ``frontend_ms_per_frame`` less this is the host's own
work and launches."""

from harness import spans


def read(ctx):
    rs = [r for r in ctx.records if not r["from_disk"]]
    if not rs or not spans.recorded(rs):
        return None
    return 1e3 * spans.waits(rs, "frontend") / sum(r["frames"] for r in rs)
