"""Useful units against units the compacted body computed: the window's
dirty units over the capacities its chunks picked
(``runner.bucket_picks``)."""


def read(ctx):
    d, picks = ctx.dirty, ctx.picks
    if not d or not picks:
        return None
    room = sum(c * n for c, n in picks.items())
    return 100.0 * d["dirty_units"] / room if room else None
