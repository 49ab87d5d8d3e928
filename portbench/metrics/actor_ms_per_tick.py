"""Actor (the fused engine's drone-0 Q forward outside the tick kernels;
for a conv net its module's forward, cuDNN's convolution on the card):
device ms a tick of the operations that each tick runs after its row
copy and before its B4, the draw kernels left out: the observation's
layout copy, the convolution and its ReLU, the dense head, the argmax
and the epsilon select.

A range inside a graph replay records nothing, so the ticks are told
apart on the card's timeline: a tick's row copy is the device-to-device
copy (``Memcpy DtoD``) that the chunk launches before each replay, and
its B4 the next ``env_kernel``. The opponents' draw and the actor's
epsilon draws run in between as ``draw_kernel`` launches."""

from portbench import trace
from portbench.metrics import b4_ms_per_tick

ROW_COPY = "Memcpy DtoD"
DRAW_KERNEL = "draw_kernel"


def actor_ops(dev):
    """The actor's operations of every tick in ``dev`` (start order): for
    each B4, those since the row copy before it, draws left out."""
    out, tick = [], []
    for op in dev:
        if ROW_COPY in op.name:
            tick = []
        elif b4_ms_per_tick.ENV_KERNEL in op.name:
            out += tick
            tick = []
        elif DRAW_KERNEL not in op.name:
            tick.append(op)
    return out


def read(ctx):
    if ctx.engine != "fused":
        return None
    ops = actor_ops(ctx.dev)
    return (sum(op.end_us - op.start_us for op in ops) / 1e3 / ctx.ticks
            or None)
