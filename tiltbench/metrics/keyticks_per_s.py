"""Key-ticks of every chunk stepped in the window over the window's time
(first dispatch to the closing synchronize).  A key-tick is one slot of
one key's stream, counted from the chunk geometry."""


def read(ctx):
    if ctx.loop != "closed" or ctx.window_s <= 0:
        return None
    return ctx.chunks * ctx.keyticks_per_chunk / ctx.window_s
