"""Device busy milliseconds a chunk in the open-loop traced stretch."""


def read(ctx):
    if ctx.loop != "open" or ctx.trace is None or not ctx.trace_chunks:
        return None
    return ctx.trace["busy_s"] / ctx.trace_chunks * 1e3
