"""Tick graph: device ms a tick outside the tick kernel, the learner
kernel and the replay sample kernel: the launch floor, the StreamReplay
push, the row copy, the schedules."""

from portbench import trace


def read(ctx):
    named = sum(trace.seconds_of(ctx.dev, k) for k in (
        trace.TICK_KERNEL, trace.LEARNER_KERNEL, trace.SAMPLE_KERNEL))
    total = sum(op.end_us - op.start_us for op in ctx.dev) / 1e6
    return (total - named) / ctx.ticks * 1e3
