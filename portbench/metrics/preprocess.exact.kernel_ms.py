"""Preprocessing on the exact route: device ms per call of kernels P (cell
sums), C (compaction) and X (the split channel-cells, looked up by
``portbench.roofline_exact.split_cells_us``), each held against its launch
counter; None where a trace count differs from a counter, or where the
program has no kernel X. Moves ``frame_ms_p50``."""

from portbench import roofline_exact


def read(ctx):
    p_c = ctx.per_call_ms(("P", "C"))
    x = roofline_exact.split_cells_us(ctx.trace)
    if p_c is None or x is None:
        return None
    return p_c + x[1] / 1e3 / ctx.calls
