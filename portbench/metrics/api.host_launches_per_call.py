"""Step API: CUDA runtime calls that hand the card work (kernel launches,
graph launches, copies, sets) per call, from the trace's host-side runtime
events. Moves ``frame_ms_p50``."""


def read(ctx):
    n = ctx.trace.runtime_calls()
    return n / ctx.calls if n else None
