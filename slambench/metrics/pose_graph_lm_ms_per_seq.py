"""Pose-graph optimisation, milliseconds per sequence: the program's
``pose_graph.optimize`` (the stage's, an odometry-only graph: the
host's float64 chain) and ``loop_closure.optimize`` (the LM after each
closure, to its read-back of the nodes) spans, averaged over the
window's sequences."""

from harness import spans


def read(ctx):
    if not ctx.records or not spans.recorded(ctx.records):
        return None
    return 1e3 * spans.seconds(ctx.records, "pose_graph.optimize",
                               "loop_closure.optimize") / len(ctx.records)
