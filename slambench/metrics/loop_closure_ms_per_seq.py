"""Pose graph and loop closure, milliseconds per sequence:
``timings["pose_graph"] + timings["loop_closure"]`` averaged over the
window's sequences."""


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * sum(r["timings"]["pose_graph"] + r["timings"]["loop_closure"]
                     for r in ctx.records) / len(ctx.records)
