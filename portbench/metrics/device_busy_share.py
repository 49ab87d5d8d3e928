"""Device: the union of the card's operation intervals in the traced
window over the window's length, in % (at most 100 by construction)."""

from portbench import trace


def read(ctx):
    return trace.busy_s(ctx.dev) / ctx.window_s * 100
