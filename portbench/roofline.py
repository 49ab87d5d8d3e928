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
that moves work between kernels cannot raise a share past 100%. A net is
counted from its layer table (:class:`Net`), which :func:`net_of` builds
from a cell's CLI flags for any Q-net the CLI builds: a dense layer
multiplies in x out, a conv layer only its in-bounds taps (a product with
a padding zero is work any kernel may skip), however a kernel lowers it.
"""

import json
from typing import NamedTuple, Tuple

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


NUM_ACTIONS = 5
OBS_CHANNELS = 6


class Layer(NamedTuple):
    """One layer of a Q-net: its multiplies for one sample, its weights
    (kernel and bias), whether it reads the observation (the first layer)
    and whether it is the output layer."""
    products: int
    weights: int
    reads_obs: bool
    output: bool


class Net(NamedTuple):
    """A Q-net's layer table and the observation features it reads."""
    obs_dim: int
    layers: Tuple[Layer, ...]


def dense_net(widths) -> Net:
    """The dense net of ``widths`` (observation, hidden..., actions)."""
    last = len(widths) - 2
    return Net(widths[0], tuple(
        Layer(i * o, i * o + o, n == 0, n == last)
        for n, (i, o) in enumerate(zip(widths, widths[1:]))))


def in_bounds_taps(size: int, k: int, stride: int, padding: int) -> int:
    """(output index, tap) pairs along one axis whose input index lies
    inside ``size``."""
    out = (size + 2 * padding - k) // stride + 1
    return sum(0 <= o * stride + d - padding < size
               for o in range(out) for d in range(k))


def conv_net(obs_shape, conv_specs, dense_layers) -> Net:
    """``ConvQNet``: (Conv + ReLU)* on the (H, W, C) observation, then the
    flattened (Dense + ReLU)* and the output layer. A conv layer
    multiplies each in-bounds (position, tap) pair by C_in x C_out:
    17,328 for dqn-agent-5's 3x3, 6 -> 8, padding 1 on a 7x7 window."""
    h, w, c = obs_shape
    layers = []
    for spec in conv_specs:
        k, co = spec["kernel_size"], spec["out_channels"]
        s, p = spec.get("stride", 1), spec.get("padding", 0)
        taps = in_bounds_taps(h, k, s, p) * in_bounds_taps(w, k, s, p)
        layers.append(Layer(taps * c * co, k * k * c * co + co,
                            not layers, False))
        h, w, c = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, co
    first = not layers
    layers += [layer._replace(reads_obs=layer.reads_obs and first)
               for layer in dense_net((h * w * c, *dense_layers,
                                       NUM_ACTIONS)).layers]
    return Net(obs_shape[0] * obs_shape[1] * obs_shape[2], tuple(layers))


def conv_specs_of(value):
    """``--conv_layers`` as the CLI takes it (a JSON list of layer dicts,
    or one dict) as a tuple of dicts."""
    layers = json.loads(value) if isinstance(value, str) else value
    return (layers,) if isinstance(layers, dict) else tuple(layers)


def net_of(flags: dict) -> Net:
    """The layer table of the Q-net that the CLI builds from ``flags``:
    ``network_type``, ``hidden_layers`` or ``conv_layers`` and
    ``conv_dense_layers``, on the view's side (``grid_size`` under the
    global wrapper, else 2 ``window_radius`` + 1)."""
    side = (flags["grid_size"] if flags.get("wrapper") == "global"
            else 2 * flags["window_radius"] + 1)
    obs_shape = (side, side, OBS_CHANNELS)
    if flags["network_type"] == "dense":
        return dense_net((side * side * OBS_CHANNELS,
                          *flags["hidden_layers"], NUM_ACTIONS))
    return conv_net(obs_shape, conv_specs_of(flags["conv_layers"]),
                    flags.get("conv_dense_layers", ()))


def layer_products(net: Net):
    """The multiplies of each layer for one sample."""
    return [layer.products for layer in net.layers]


def forward_flops(net: Net) -> int:
    """FLOPs of one forward of one observation (a multiply and an add a
    product): 10,080 for dense (294, 16, 16, 5), 92,288 for (294, 128,
    64, 5), 47,360 for dqn-agent-5."""
    return 2 * sum(layer_products(net))


def actor_seconds(net: Net, scheme: str, num_envs: int) -> float:
    """Least seconds of the Q forward of ``num_envs`` observations: the
    layer that reads the observation on the tensor cores in ``scheme``'s
    products, the hidden layers in f32-accurate bf16 products, the
    output layer at the f32 rate."""
    def flops(keep):
        return sum(num_envs * 2 * layer.products for layer in net.layers
                   if keep(layer))

    return (FIRST_LAYER_PRODUCTS[scheme] * flops(lambda x: x.reads_obs)
            / PEAK_BF16
            + HIDDEN_PRODUCTS * flops(lambda x: not (x.reads_obs or x.output))
            / PEAK_BF16
            + flops(lambda x: x.output and not x.reads_obs) / PEAK_F32)


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


def tick_kernel_bound(net: Net, n, c, num_envs, obs_itemsize):
    """B1 (a bf16 ring, ``obs_itemsize`` 2) or B3 (f32 observations, 4):
    drone 0's observation read and the next one written, the state, the
    weights; the actor's Q forward of every env; the hashes of an env
    (its key's splits, the actor's N + 1 uniforms, 2 C spawn scores)."""
    scheme = "bf16" if obs_itemsize == 2 else "f32"
    weight_bytes = 4 * sum(layer.weights for layer in net.layers)
    obs_bytes = 2 * net.obs_dim * num_envs * obs_itemsize
    return env_bound(n, c, obs_bytes, weight_bytes + 4,
                     num_envs * forward_flops(net), 4 + (n + 1) + 2 * c,
                     actor_seconds(net, scheme, num_envs), num_envs)


def learner_bound(net: Net, batch, sync):
    """The least ms of one TD(0) + Adam step: each parameter read as
    params, target, mu and nu and written as params, mu, nu (and target
    with ``sync``), the batch read once, the loss written; two forwards,
    the backward and the Adam pass at the f32 rate."""
    io = layer_products(net)
    p = sum(layer.weights for layer in net.layers)
    total_bytes = (4 * p * (7 + sync) + 2 * net.obs_dim * batch * 4
                   + 3 * batch * 4 + 4)
    flops = (batch * (2 * 2 * sum(io) + 2 * sum(io) + 2 * inner(net))
             + (ADAM_OPS + SYNC_OPS * sync) * p)
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", total_bytes, flops)


def inner(net: Net) -> int:
    """The multiplies of the layers that do not read the observation: the
    input gradients a backward pass computes."""
    return sum(layer.products for layer in net.layers if not layer.reads_obs)


def tick_model_flops(net: Net, num_envs, batch) -> int:
    """The model FLOPs of one trained tick: the actor's Q forward of every
    env, and over the batch the online forward, the target forward, the
    weights' gradients and the inputs' gradients of every layer but the
    first (Adam's elementwise pass is not model work)."""
    return (num_envs * forward_flops(net)
            + batch * (2 * sum(layer_products(net)) * 3 + 2 * inner(net)))
