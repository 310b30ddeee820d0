"""Frontend milliseconds per frame from KITTI-layout PNGs: the same span
as ``frontend_ms_per_frame`` on the path route, which also holds the
waits for the prefetcher's PNG decodes."""


def read(ctx):
    rs = [r for r in ctx.records if r["from_disk"]]
    if not rs:
        return None
    return 1e3 * sum(r["timings"]["frontend"] for r in rs) / sum(
        r["frames"] for r in rs)
