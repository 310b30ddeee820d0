"""Window-BA milliseconds per window: ``timings["bundles"]`` (ends with
the host's read-back of every slice) over the windows solved."""


def read(ctx):
    n = sum(r["windows"] for r in ctx.records)
    if not n:
        return None
    return 1e3 * sum(r["timings"]["bundles"] for r in ctx.records) / n
