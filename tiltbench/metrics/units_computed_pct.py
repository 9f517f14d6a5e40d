"""Share of the window's work units (keys x segments) that the sparse body
computed: ``Runner.dirty_stats()`` over the window."""


def read(ctx):
    d = ctx.dirty
    if not d or not d["units"]:
        return None
    return 100.0 * d["dirty_units"] / d["units"]
