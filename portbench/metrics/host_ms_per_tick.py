"""Chunk driver (``train.Chunk``): host wall ms a tick to enqueue a
chunk (the table walk, its copy, a row copy and a graph replay a tick),
timed before the chunk's readback, over untraced chunks."""


def read(ctx):
    return ctx.host_ms_per_tick
