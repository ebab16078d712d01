"""Kernels: kernel E's least time over its device time, in percent. E runs
both EM passes of a single-stream frame; each launch's least time is
counted at its own trips, nodes and points in reach (roofline.em_loop_bound).
Moves ``frame_ms_p50``."""


def read(ctx):
    got = ctx.trace.kernel_us("E")
    if got is None or got[0] == 0 or got[0] != 2 * len(ctx.frames):
        return None
    least_ms = 0.0
    for f in ctx.frames:
        least_ms += ctx.roofline.em_loop_bound(f["rows"], f["guide_count"], f["in_reach_pre"],
                                               f["guide_iterations"])[0]
        least_ms += ctx.roofline.em_loop_bound(f["rows"], f["nodes"], f["in_reach_main"],
                                               f["iterations"])[0]
    return 100.0 * least_ms / (got[1] / 1e3)
