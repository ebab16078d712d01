"""EM: iterations the lockstep loops ran for the streams over the iterations
the streams needed. The loops' trips come from kernel L's tally on the card
(the ``loop_flag`` launches, less one opening launch a loop: two loops a
cohort a call), each trip run for every stream of its cohort; the needed
iterations from the step's outputs. Read only where the trips the tally
gives equal those the outputs imply (each loop runs its cohort's slowest
stream). Moves ``stream_frames_per_s``."""


def read(ctx):
    cohort = ctx.cohort
    flags = ctx.trace.counts.get("loop_flag", 0)
    if cohort <= 1 or flags == 0 or not ctx.frames:
        return None
    opened = 2 * (ctx.streams // cohort) * ctx.calls
    trips = flags - opened
    slowest: dict = {}
    for f in ctx.frames:
        for key, it in (("pre", f["guide_iterations"]), ("main", f["iterations"])):
            loop = (f["call"], f["stream"] // cohort, key)
            slowest[loop] = max(slowest.get(loop, 0), it)
    if trips != sum(slowest.values()):
        return None
    needed = sum(f["guide_iterations"] + f["iterations"] for f in ctx.frames)
    return trips * cohort / needed if needed else None
