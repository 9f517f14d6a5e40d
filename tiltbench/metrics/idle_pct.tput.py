"""Share of the closed-loop traced stretch with nothing on the card."""
from tiltbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.loop == "closed" else None
