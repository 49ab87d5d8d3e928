"""Tick kernel B1 (the ring engine's full tick kernel): device ms a
tick."""

from portbench import trace


def read(ctx):
    if ctx.engine != "ring":
        return None
    return trace.seconds_of(ctx.dev, trace.TICK_KERNEL) / ctx.ticks * 1e3 or None
