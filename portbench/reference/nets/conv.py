"""The conv Q-net: (Conv + ReLU)* on the (H, W, C) observation, the
activations flattened in (C, H, W) order (the JAX package's ConvQNet
transposes to NCHW before it flattens, as droneRL's PyTorch net does),
then (Dense + ReLU)* -> Dense(5). Leaves ``[K0, c0, ..., W0, b0, ...]``:
a conv kernel (C_out, C_in, k, k), as the program keeps it, and its bias;
a dense kernel (in, out) and its bias.

``init`` is flax's: each module (``Conv_i``, then ``Dense_i``) draws its
kernel from the module's first ``make_rng`` key, ``lecun_normal``
(variance scaling 1, fan-in, truncated normal) on every layer, a conv
kernel in flax's (k, k, C_in, C_out) layout with fan-in k·k·C_in; biases
are zero.

``forward_t`` runs each conv layer as its patches (``F.unfold``) times
the (C_out, C_in·k·k) kernel through the ``matmul`` it is given, so that
the TF32 control reaches the conv as well."""

import json
import math

import torch
import torch.nn.functional as F

from portbench.reference import env, threefry
from portbench.reference.nets import dense
from portbench.reference.nets.dense import NUM_ACTIONS, TRUNCATED_STD


def conv_specs(flags: dict):
    """``(kernel_size, out_channels, stride, padding)`` of each conv layer
    of ``--conv_layers`` (a JSON list of layer dicts, or one dict)."""
    layers = flags["conv_layers"]
    layers = json.loads(layers) if isinstance(layers, str) else layers
    layers = [layers] if isinstance(layers, dict) else layers
    return [(s["kernel_size"], s["out_channels"], s.get("stride", 1),
             s.get("padding", 0)) for s in layers]


def _out(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def _kernel(key: torch.Tensor, name: str, shape, fan_in: int):
    std = (torch.sqrt(torch.tensor(1.0 / fan_in, dtype=torch.float32))
           / torch.tensor(TRUNCATED_STD, dtype=torch.float32))
    k = threefry.flax_param_key(key, (name, 1))
    return threefry.truncated_normal(k, -2.0, 2.0, shape) * std


def init(key: torch.Tensor, obs_dim: int, flags: dict):
    h = w = math.isqrt(obs_dim // env.CHANNELS)
    c = env.CHANNELS
    leaves = []
    for i, (k, co, s, p) in enumerate(conv_specs(flags)):
        kernel = _kernel(key, f"Conv_{i}", (k, k, c, co), k * k * c)
        leaves += [kernel.permute(3, 2, 0, 1).contiguous(), torch.zeros(co)]
        h, w, c = _out(h, k, s, p), _out(w, k, s, p), co
    widths = (h * w * c, *flags.get("conv_dense_layers", ()), NUM_ACTIONS)
    for i, (fan_in, out) in enumerate(zip(widths[:-1], widths[1:])):
        leaves += [_kernel(key, f"Dense_{i}", (fan_in, out), fan_in),
                   torch.zeros(out)]
    return leaves


def forward_t(leaves, obs_t: torch.Tensor, matmul, flags: dict):
    """(H·W·C, B) observations, (y, x, c) order -> (5, B)."""
    dim, b = obs_t.shape
    side = math.isqrt(dim // env.CHANNELS)
    x = obs_t.t().reshape(b, side, side, env.CHANNELS).permute(0, 3, 1, 2)
    convs = conv_specs(flags)
    for i, (k, co, s, p) in enumerate(convs):
        kernel, bias = leaves[2 * i], leaves[2 * i + 1]
        h, w = _out(x.shape[2], k, s, p), _out(x.shape[3], k, s, p)
        cols = F.unfold(x, k, padding=p, stride=s)        # (B, C k k, L)
        cols = cols.permute(1, 0, 2).reshape(cols.shape[1], -1)
        y = matmul(kernel.reshape(co, -1), cols) + bias[:, None]
        x = torch.relu(y).reshape(co, b, h, w).permute(1, 0, 2, 3)
    return dense.forward_t(leaves[2 * len(convs):], x.reshape(b, -1).t(),
                           matmul)
