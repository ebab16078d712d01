"""Device: the share of the calls' host time in which nothing ran on the
card, in percent: one less the union of the device events' intervals in
the traced window over the host seconds of the same calls made untraced
just before it, so that the profiler's own host time does not count as
idle. Read only where the trace holds every launch of every port kernel
that the port's counters counted. Moves ``stream_frames_per_s``."""


def read(ctx):
    if not ctx.trace.all_kernels_match() or not ctx.trace.device or not ctx.plain_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e6 / ctx.plain_s)
