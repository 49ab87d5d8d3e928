"""Tick kernel B4 (the fused engine's env tick kernel, ``env_kernel.cu``
launched by ``tick_launch``): device ms a tick."""

from portbench import trace

ENV_KERNEL = "env_kernel"


def read(ctx):
    if ctx.engine != "fused":
        return None
    return trace.seconds_of(ctx.dev, ENV_KERNEL) / ctx.ticks * 1e3 or None
