"""EM: mean EM iterations a stream-frame needs, both passes
(``guide_iterations + iterations`` of the step's outputs). Moves
``frame_ms_p50``."""


def read(ctx):
    if not ctx.frames:
        return None
    return sum(f["guide_iterations"] + f["iterations"] for f in ctx.frames) / len(ctx.frames)
