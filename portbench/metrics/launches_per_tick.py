"""Tick graph: device operations (kernels, copies, memsets) a tick on the
card's timeline in the trace."""


def read(ctx):
    return len(ctx.dev) / ctx.ticks
