"""Priors: device ms per call of kernel W (the prior walks). Moves
``frame_ms_p50``."""


def read(ctx):
    return ctx.per_call_ms(("W",))
