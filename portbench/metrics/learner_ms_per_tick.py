"""Learner kernel (``td_adam.cu``): device ms a tick."""

from portbench import trace


def read(ctx):
    return (trace.seconds_of(ctx.dev, trace.LEARNER_KERNEL) / ctx.ticks
            * 1e3 or None)
