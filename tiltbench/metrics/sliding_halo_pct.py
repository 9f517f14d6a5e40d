"""Share of the ticks ``sliding_assoc`` reads in a chunk that lie before
their unit's core: the lookback every unit evaluates again, as the window
kernels see it.  Over the shapes recorded while the dense body was built,
``sum R (T - core) / sum R T``, with ``core = keyticks_per_chunk / units``
the ticks a unit adds.  (The runner's gauge ``runner.halo_eval_pct.<input>``
is the same share of one input's evaluated window.)"""


def read(ctx):
    calls = (ctx.shapes.per_units.get(ctx.units, [])
             if ctx.shapes is not None else [])
    rows = [key[:2] for kernel, key, _ in calls if kernel == "sliding_assoc"]
    if not rows or not ctx.units:
        return None
    core = ctx.keyticks_per_chunk / ctx.units
    return (100.0 * sum(R * (T - core) for R, T in rows)
            / sum(R * T for R, T in rows))
