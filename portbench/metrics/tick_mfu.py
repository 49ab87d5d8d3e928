"""Device: the model FLOPs of a tick (``roofline.tick_model_flops``) over
the wall time of a tick of untraced chunks at the dense bf16 peak of
989 TFLOP/s, in %."""

from portbench import roofline


def read(ctx):
    flops = roofline.tick_model_flops(ctx.net, ctx.num_envs, ctx.batch)
    return flops / (ctx.wall_ms_per_tick / 1e3 * roofline.PEAK_BF16) * 100
