"""Preprocessing: device ms per call of kernels P (cell sums) and C
(compaction). Moves ``frame_ms_p50``."""


def read(ctx):
    return ctx.per_call_ms(("P", "C"))
