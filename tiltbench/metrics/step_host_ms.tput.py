"""Host milliseconds inside ``Runner.step`` a chunk in the closed-loop
window (the benchmark's own clock around each call)."""
from tiltbench.readers import step_host_ms


def read(ctx):
    return step_host_ms(ctx) if ctx.loop == "closed" else None
