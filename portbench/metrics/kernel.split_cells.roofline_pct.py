"""Kernels: kernel X's least time over its device time, in percent
(``portbench.roofline_exact.split_cells_bound``, at the work its own tally
counted over the same calls). None where X is missing, its trace count
differs from its launch counter, or its tally is absent. Moves
``frame_ms_p50``."""

from portbench import roofline_exact

WORK = ("cells", "pixels", "slots", "groups")


def read(ctx):
    x = roofline_exact.split_cells_us(ctx.trace)
    if x is None or x[1] <= 0:
        return None
    work = {k: ctx.trace.counts.get(f"split_cells.{k}") for k in WORK}
    if any(v is None for v in work.values()):
        return None
    blocks = roofline_exact.p_blocks(ctx.height, ctx.width, ctx.cell_px, ctx.mode)
    least_ms = roofline_exact.split_cells_bound(x[0] * ctx.streams, blocks, work["cells"],
                                                work["pixels"], work["slots"], work["groups"])[0]
    return 100.0 * least_ms / (x[1] / 1e3)
