"""Frontend device milliseconds per frame in the temporal match, RANSAC
and the poses: the program's ``frontend.device:motion`` span (the card's
clock, stamped inside the frontend's chunk graph after its features and
after its poses) summed over the window's sequences, over their frames.
A chunk's padded frames count in its time and not among the frames. None
where the program stamps no chunk (no such key in any record)."""

from harness import spans

KEY = "frontend.device:motion"


def read(ctx):
    rs = ctx.records
    if not any(KEY in r["timings"] for r in rs):
        return None
    return 1e3 * spans.seconds(rs, KEY) / sum(r["frames"] for r in rs)
