"""Loop closure's Mahalanobis gate, milliseconds per sequence: the
program's ``loop_closure.gate`` span (each refresh of the all-pairs gate:
the padded posterior's graphed sweep and the distances' read-back, once
and once more per closure) averaged over the window's sequences."""

from harness import spans


def read(ctx):
    if not ctx.records or not spans.recorded(ctx.records):
        return None
    return 1e3 * spans.seconds(ctx.records, "loop_closure.gate") / len(
        ctx.records)
