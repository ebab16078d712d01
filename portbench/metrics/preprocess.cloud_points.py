"""Preprocessing: mean valid points of a stream-frame's cloud (the step's
``n_points``, ``ctx.frames``), the rows the EM and the visibility take.
Moves ``frame_ms_p50``."""


def read(ctx):
    if not ctx.frames:
        return None
    return sum(f["n_points"] for f in ctx.frames) / len(ctx.frames)
