"""Track-store milliseconds per frame: ``timings["trackstore"]`` (host
work, the native track chaining) over the window's frames."""


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * sum(r["timings"]["trackstore"] for r in ctx.records) / sum(
        r["frames"] for r in ctx.records)
