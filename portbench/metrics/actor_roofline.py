"""Actor: the least time of its work over its device ms, in %.

The actor reads every env's f32 observation once (4 D E bytes), the
online net's weights once (4 bytes a parameter) and writes drone 0's
actions (4 E bytes), at 3.35 TB/s; its Q forward of E observations takes
at least ``roofline.actor_seconds(net, "f32", E)`` (the layer that reads
the observation in f32-accurate bf16 products on the tensor cores, the
hidden layers so too, the output layer at the f32 rate). The least time
is the larger of the two. For dqn-agent-5 at 65,536 envs: 77.4 MB,
0.0231 ms, against 0.0189 ms of products: bound by bytes."""

from portbench import roofline
from portbench.metrics import actor_ms_per_tick


def bound_ms(ctx) -> float:
    net, e = ctx.net, ctx.num_envs
    weight_bytes = 4 * sum(layer.weights for layer in net.layers)
    t_bytes = (4 * net.obs_dim * e + weight_bytes + 4 * e) / roofline.PEAK_BYTES
    return max(t_bytes, roofline.actor_seconds(net, "f32", e)) * 1e3


def read(ctx):
    ms = actor_ms_per_tick.read(ctx)
    if not ms:
        return None
    return bound_ms(ctx) / ms * 100
