"""Share of the profiled pass (first sequence's start to last one's end)
in which no kernel, copy or set ran on the card: 100 x (1 - the union of
the device events' intervals / the pass's length)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
