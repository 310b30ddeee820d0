"""Window-BA milliseconds per window in which the host is blocked on the
card: every ``bundles.….wait`` span of the program's timings (each BA
slice's event synchronised before its read-back, which holds the
device's solve that the host did not overlap) summed over the window's
sequences, over the windows solved."""

from harness import spans


def read(ctx):
    n = sum(r["windows"] for r in ctx.records)
    if not n or not spans.recorded(ctx.records):
        return None
    return 1e3 * spans.waits(ctx.records, "bundles") / n
