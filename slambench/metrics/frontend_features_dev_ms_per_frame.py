"""Frontend device milliseconds per frame in detection, description and
the stereo match: the program's ``frontend.device:features`` span (the
card's clock, stamped inside the frontend's chunk graph before and after
its features) summed over the window's sequences, over their frames. A
chunk's padded frames count in its time and not among the frames. None
where the program stamps no chunk (no such key in any record)."""

from harness import spans

KEY = "frontend.device:features"


def read(ctx):
    rs = ctx.records
    if not any(KEY in r["timings"] for r in rs):
        return None
    return 1e3 * spans.seconds(rs, KEY) / sum(r["frames"] for r in rs)
