"""Kernels: kernel P's least time over its device time, in percent, at the
frames' shape and mode (roofline.cell_sums_bound, linear in the frames a
launch takes). Moves ``frame_ms_p50``."""


def read(ctx):
    got = ctx.trace.kernel_us("P")
    if got is None or got[0] == 0:
        return None
    r = ctx.roofline
    one = r.cell_sums_bound(1, ctx.height, ctx.width,
                            r.grid_cells(ctx.height, ctx.width, ctx.cell_px), ctx.mode)[0]
    return 100.0 * one * ctx.calls * ctx.streams / (got[1] / 1e3)
