"""The dense Q-net: (Dense + ReLU)* -> Dense(5), weights in flax's layout
(kernel (in, out), bias (out,)), leaves ``[W0, b0, W1, b1, ...]``.

``init`` is flax's: each layer ``Dense_i`` draws its kernel from the
layer's first ``make_rng`` key, ``variance_scaling(scale, "fan_in",
"truncated_normal")`` with scale 2 (He) on the hidden layers and 1 (LeCun)
on the output layer; biases are zero."""

import torch

from portbench.reference import threefry

NUM_ACTIONS = 5
TRUNCATED_STD = 0.87962566103423978


def widths(obs_dim: int, flags: dict):
    return (obs_dim, *flags["hidden_layers"], NUM_ACTIONS)


def init(key: torch.Tensor, obs_dim: int, flags: dict):
    w = widths(obs_dim, flags)
    leaves = []
    for i, (fan_in, out) in enumerate(zip(w[:-1], w[1:])):
        scale = 2.0 if i < len(w) - 2 else 1.0
        std = (torch.sqrt(torch.tensor(scale / fan_in, dtype=torch.float32))
               / torch.tensor(TRUNCATED_STD, dtype=torch.float32))
        k = threefry.flax_param_key(key, (f"Dense_{i}", 1))
        leaves += [threefry.truncated_normal(k, -2.0, 2.0, (fan_in, out))
                   * std, torch.zeros(out)]
    return leaves


def forward_t(leaves, obs_t: torch.Tensor, matmul,
              flags=None) -> torch.Tensor:
    """(in, B) -> (5, B): ``W^T x + b`` a layer, ReLU between layers (the
    widths are the leaves'; ``flags`` is not needed)."""
    x = obs_t
    n = len(leaves) // 2
    for i in range(n):
        x = matmul(leaves[2 * i].t(), x) + leaves[2 * i + 1][:, None]
        if i < n - 1:
            x = torch.relu(x)
    return x
