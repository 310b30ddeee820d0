"""Window-BA host assembly, milliseconds per window: the program's
``bundles.build`` span (keyframe selection, ``build_windows``,
``init_landmarks`` in numpy) summed over the window's sequences, over
the windows solved."""

from harness import spans


def read(ctx):
    n = sum(r["windows"] for r in ctx.records)
    if not n or not spans.recorded(ctx.records):
        return None
    return 1e3 * spans.seconds(ctx.records, "bundles.build") / n
