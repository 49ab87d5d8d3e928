"""Tick kernel B1: the least time of its work (``roofline.
tick_kernel_bound`` on the bf16 ring) over its device ms, in %."""

from portbench import roofline
from portbench.metrics import b1_ms_per_tick


def read(ctx):
    ms = b1_ms_per_tick.read(ctx)
    if not ms:
        return None
    bound = roofline.tick_kernel_bound(ctx.net, ctx.n_drones, ctx.cells,
                                       ctx.num_envs, 2)[0]
    return bound / ms * 100
