"""Frontend milliseconds per frame, in-memory input: the program's own
``timings["frontend"]`` span (host clock, ``run_pipeline``'s ``timed``)
summed over the window's in-memory sequences, over their frames. The
frontend's descriptors stay on the card, so some of their device tail
can fall into the next stage's span."""


def read(ctx):
    rs = [r for r in ctx.records if not r["from_disk"]]
    if not rs:
        return None
    return 1e3 * sum(r["timings"]["frontend"] for r in rs) / sum(
        r["frames"] for r in rs)
