"""The work of a training tick counted from its shapes, and the least time
one NVIDIA H100 (SXM, 700 W) could take for it: the yardstick of the
per-layer shares.

The peaks are NVIDIA's published dense rates: HBM at 3.35 TB/s, 67
TFLOP/s in f32 on the CUDA cores, 989 TFLOP/s in bf16 on the tensor
cores. The tick kernels run every dense layer but the last on the tensor
cores as f32-accurate bf16 products (the weights in three bf16 pieces,
and f32 operands split in three as well: 3 products against the bf16
ring's exact observations, 6 otherwise); their FLOPs count at the bf16
rate times those products, the output layer's at the f32 rate.

Caveat: the integer work of the Threefry hashes is priced at the f32
rate, which is no lower than the card's int32 rate, so every bound here
stays a lower bound on the time and every share stays at most 100%.

The counts are the work a stage needs, whatever kernel does it: a change
that moves work between kernels cannot raise a share past 100%.
"""

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
FIRST_LAYER_PRODUCTS = {"bf16": 3, "f32": 6}
HIDDEN_PRODUCTS = 6
ADAM_OPS = 13          # per parameter: m 3, v 4, the update 6
SYNC_OPS = 3           # per parameter: tau p + (1 - tau) t


def hash_ops(rounds: int = 20) -> int:
    """Integer operations of one Threefry-2x32 hash of ``rounds`` rounds:
    3 a round, 3 a key injection (one every 4 rounds), 4 to start and
    finish (79 at 20 rounds)."""
    return 3 * rounds + 3 * (rounds // 4) + 4


def layer_products(widths):
    """``in x out`` of each dense layer of a net of ``widths``."""
    return [i * o for i, o in zip(widths, widths[1:])]


def forward_flops(widths) -> int:
    """FLOPs of one forward of one observation (a multiply and an add a
    weight): 10,080 for (294, 16, 16, 5), 92,288 for (294, 128, 64, 5)."""
    return 2 * sum(layer_products(widths))


def actor_seconds(widths, scheme: str, num_envs: int) -> float:
    """Least seconds of the Q forward of ``num_envs`` observations, the
    layers but the last on the tensor cores in ``scheme``'s products."""
    flops = [num_envs * 2 * p for p in layer_products(widths)]
    t = FIRST_LAYER_PRODUCTS[scheme] * flops[0] / PEAK_BF16
    if len(flops) > 1:
        t += HIDDEN_PRODUCTS * sum(flops[1:-1]) / PEAK_BF16
        t += flops[-1] / PEAK_F32
    return t


def env_bound(n, c, obs_bytes, extra_bytes=0, flops=0, hashes_per_env=0,
              flop_seconds=None, num_envs=1):
    """The least ms of one env-side launch over ``num_envs`` envs: the
    state read and written once (ground C bytes; a drone's x, y, carry,
    charge), the actions read and rewards and dones written, ``obs_bytes``
    of observations, plus ``extra_bytes``; the operations: ``flops`` (at
    the f32 rate, or taking ``flop_seconds``) and the hashes at 79
    operations each. Returns (ms, "bytes" or "operations", bytes, ops)."""
    state_bytes = num_envs * (c + n * (4 + 4 + 1 + 4))
    io_bytes = num_envs * n * (4 + 4 + 1)
    total_bytes = 2 * state_bytes + io_bytes + obs_bytes + extra_bytes
    ops = flops + hash_ops() * hashes_per_env * num_envs
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    if flop_seconds is not None:
        t_ops += (flop_seconds - flops / PEAK_F32) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", total_bytes, ops)


def tick_kernel_bound(widths, n, c, num_envs, obs_itemsize):
    """B1 (a bf16 ring, ``obs_itemsize`` 2) or B3 (f32 observations, 4):
    drone 0's observation read and the next one written, the state, the
    weights; the actor's Q forward of every env; the hashes of an env
    (its key's splits, the actor's N + 1 uniforms, 2 C spawn scores)."""
    scheme = "bf16" if obs_itemsize == 2 else "f32"
    weight_bytes = 4 * sum(p + o for p, o in zip(layer_products(widths),
                                                  widths[1:]))
    obs_bytes = 2 * widths[0] * num_envs * obs_itemsize
    return env_bound(n, c, obs_bytes, weight_bytes + 4,
                     num_envs * forward_flops(widths), 4 + (n + 1) + 2 * c,
                     actor_seconds(widths, scheme, num_envs), num_envs)


def learner_bound(widths, batch, sync):
    """The least ms of one TD(0) + Adam step: each parameter read as
    params, target, mu and nu and written as params, mu, nu (and target
    with ``sync``), the batch read once, the loss written; two forwards,
    the backward and the Adam pass at the f32 rate."""
    io = layer_products(widths)
    p = sum(io) + sum(widths[1:])
    total_bytes = (4 * p * (7 + sync) + 2 * widths[0] * batch * 4
                   + 3 * batch * 4 + 4)
    flops = (batch * (2 * 2 * sum(io) + 2 * sum(io) + 2 * sum(io[1:]))
             + (ADAM_OPS + SYNC_OPS * sync) * p)
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", total_bytes, flops)


def tick_model_flops(widths, num_envs, batch) -> int:
    """The model FLOPs of one trained tick: the actor's Q forward of every
    env, and over the batch the online forward, the target forward, the
    weights' gradients and the inputs' gradients of every layer but the
    first (Adam's elementwise pass is not model work)."""
    io = layer_products(widths)
    return (num_envs * forward_flops(widths)
            + batch * (2 * sum(io) * 3 + 2 * sum(io[1:])))
