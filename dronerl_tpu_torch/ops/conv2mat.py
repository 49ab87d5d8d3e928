"""Convolution layers as im2col weight matrices (counterpart of
``dronerl_tpu/ops/conv2mat.py``).

A 2-D convolution is a linear map, so a conv layer lowers to the shape
of a dense layer: a static scatter places each weight element
``W[co, ci, dy, dx]`` (the port keeps torch's OIHW layout; flax's HWIO
element is the same number) into an ``(in_dim, out_dim)`` matrix ``M``
with

    in_row  = (yi · W_in + xi) · C_in + ci          (NHWC flatten)
    out_row = (yo · W_out + xo) · C_out + co        (NHWC flatten)
              or co · H_out·W_out + yo · W_out + xo (NCHW: the final conv
              layer, as ConvQNet flattens after its transpose)
    yi = yo·stride + dy − padding,  xi = xo·stride + dx − padding

The scatter only moves values, so ``M`` equals the JAX package's matrix
bit for bit, and it is differentiable: the learner's gradient reaches
the conv kernel through it. The full tick kernel (B1, B3) runs the
resulting chain as it runs a dense net's layers (``fused_tick``), and
``DQN.q_values*`` with ``conv_matmul`` runs the same chain.
"""

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["net_layer_specs", "effective_dense_params", "conv_out_hw"]


def conv_out_hw(h: int, w: int, k: int, stride: int,
                padding: int) -> Tuple[int, int]:
    return ((h + 2 * padding - k) // stride + 1,
            (w + 2 * padding - k) // stride + 1)


def net_layer_specs(config, obs_shape) -> Optional[Tuple]:
    """Per-layer descriptors of a conv network: ``("conv", H_in, W_in,
    C_in, C_out, k, stride, padding, nchw_out)`` or ``("dense",)``, the
    output layer included; ``None`` for a dense network."""
    if config.network_type != "conv":
        return None
    h, w, c = obs_shape
    specs = []
    conv_specs = config.conv_specs()
    for i, spec in enumerate(conv_specs):
        k = spec["kernel_size"]
        s = spec.get("stride", 1)
        p = spec.get("padding", 0)
        co = spec["out_channels"]
        specs.append(("conv", h, w, c, co, k, s, p, i == len(conv_specs) - 1))
        h, w = conv_out_hw(h, w, k, s, p)
        c = co
    for _ in tuple(config.conv_dense_layers) + (1,):
        specs.append(("dense",))
    return tuple(specs)


@functools.lru_cache(maxsize=64)
def _conv_indices(h: int, w: int, ci: int, co: int, k: int, stride: int,
                  padding: int, nchw_out: bool):
    """The static scatter, computed once per layer shape: (in_rows,
    out_rows, OIHW flat weight index) int64 arrays, h_out, w_out. The
    entries are in the JAX package's order (output position, tap, input
    channel, output channel)."""
    h_out, w_out = conv_out_hw(h, w, k, stride, padding)
    yo, xo, dy, dx, c_in, c_out = np.meshgrid(
        np.arange(h_out), np.arange(w_out), np.arange(k), np.arange(k),
        np.arange(ci), np.arange(co), indexing="ij")
    yi = yo * stride + dy - padding
    xi = xo * stride + dx - padding
    keep = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    yo, xo, dy, dx, c_in, c_out, yi, xi = (
        a[keep] for a in (yo, xo, dy, dx, c_in, c_out, yi, xi))
    in_rows = (yi * w + xi) * ci + c_in
    if nchw_out:
        out_rows = c_out * h_out * w_out + yo * w_out + xo
    else:
        out_rows = (yo * w_out + xo) * co + c_out
    w_idx = ((c_out * ci + c_in) * k + dy) * k + dx
    return (in_rows.astype(np.int64), out_rows.astype(np.int64),
            w_idx.astype(np.int64), h_out, w_out)


@functools.lru_cache(maxsize=64)
def _device_indices(shape, device: torch.device):
    """:func:`_conv_indices` as tensors on ``device``, copied there once."""
    *index, h_out, w_out = _conv_indices(*shape)
    return (*(torch.from_numpy(a).to(device) for a in index), h_out, w_out)


def conv_layer_matrix(kernel: torch.Tensor, bias: torch.Tensor, spec):
    """(OIHW kernel, (C_out,) bias) → (M (in_dim, out_dim), bias
    (out_dim,)), both f32, on the kernel's device."""
    _, h, w, ci, co, k, stride, padding, nchw = spec
    in_rows, out_rows, w_idx, h_out, w_out = _device_indices(
        spec[1:], kernel.device)
    values = kernel.to(torch.float32).reshape(-1)[w_idx]
    m = torch.zeros((h * w * ci, h_out * w_out * co), dtype=torch.float32,
                    device=kernel.device).index_put((in_rows, out_rows),
                                                    values)
    bias = bias.to(torch.float32)
    if nchw:
        return m, bias.repeat_interleave(h_out * w_out)
    return m, bias.repeat(h_out * w_out)


def effective_dense_params(net, net_spec) -> List[torch.Tensor]:
    """A ``ConvQNet`` → its matmul chain ``[W0 (in, out), b0 (out,), W1,
    b1, ...]``, the conv layers lowered by :func:`conv_layer_matrix` and
    the dense layers as they are."""
    chain, conv_i, dense_i = [], 0, 0
    for spec in net_spec:
        if spec[0] == "conv":
            chain += conv_layer_matrix(net.conv_kernels[conv_i],
                                       net.conv_biases[conv_i], spec)
            conv_i += 1
        else:
            chain += [net.kernels[dense_i], net.biases[dense_i]]
            dense_i += 1
    return chain
