"""Visibility: device ms per call of kernel V. Moves ``frame_ms_p50``."""


def read(ctx):
    return ctx.per_call_ms(("V",))
