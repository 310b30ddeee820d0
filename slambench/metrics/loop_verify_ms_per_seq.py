"""Loop closure's verification, milliseconds per sequence: the program's
``loop_closure.verify`` span (each batched match + RANSAC of the gated
candidates: the uniforms, the graphed call and its read-back) averaged
over the window's sequences."""

from harness import spans


def read(ctx):
    if not ctx.records or not spans.recorded(ctx.records):
        return None
    return 1e3 * spans.seconds(ctx.records, "loop_closure.verify") / len(
        ctx.records)
