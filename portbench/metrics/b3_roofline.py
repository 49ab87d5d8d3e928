"""Tick kernel B3: the least time of its work (``roofline.
tick_kernel_bound`` on f32 observations) over its device ms, in %."""

from portbench import roofline
from portbench.metrics import b3_ms_per_tick


def read(ctx):
    ms = b3_ms_per_tick.read(ctx)
    if not ms:
        return None
    bound = roofline.tick_kernel_bound(ctx.net, ctx.n_drones, ctx.cells,
                                       ctx.num_envs, 4)[0]
    return bound / ms * 100
