"""Carry the JAX package's training state into the port, and back.

The inputs are the JAX package's structures after ``jax.device_get``:
numpy arrays inside flax parameter dicts, optax states and the ring
trainer's carry. This module reads them by key and attribute name only,
so it imports neither JAX nor the JAX package. The he-normal init of the
two frameworks draws different bits, so tests that compare the two
trainers start both from one state carried across this way.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from dronerl_tpu_torch.agents.dqn import (
    AdamState, ConvQNet, DenseQNet, DQNState, QNet)
from dronerl_tpu_torch.ops.fused_tick import TState
from dronerl_tpu_torch.replay import ReplayState


def tensor(arr, device="cpu") -> torch.Tensor:
    """numpy (bfloat16 included, as ml_dtypes stores it) → torch."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        raw = torch.from_numpy(np.array(arr, copy=True).view(np.int16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _count(layers, prefix: str) -> int:
    return sum(1 for name in layers if name.startswith(prefix))


def qnet_from_flax(params: Dict[str, Any], device="cpu", obs_shape=None,
                   conv_specs=None) -> QNet:
    """flax ``{"params": {"Dense_i" / "Conv_i": {"kernel", "bias"}}}`` →
    a ``DenseQNet``, or with ``Conv_i`` layers a ``ConvQNet`` of
    ``obs_shape`` (H, W, C) and ``conv_specs`` (``DQNConfig.conv_specs()``:
    stride and padding are not in the params), its HWIO conv kernels made
    OIHW."""
    layers = params["params"]
    n_conv, n_dense = _count(layers, "Conv_"), _count(layers, "Dense_")
    kernels = [np.asarray(layers[f"Dense_{i}"]["kernel"])
               for i in range(n_dense)]
    hidden = tuple(k.shape[1] for k in kernels[:-1])
    if n_conv:
        if obs_shape is None or conv_specs is None:
            raise ValueError("a conv net needs its obs_shape and conv_specs")
        net = ConvQNet(obs_shape, conv_specs, hidden, device)
    else:
        net = DenseQNet(kernels[0].shape[0], hidden, device)
    with torch.no_grad():
        for i, (w, b) in enumerate(zip(getattr(net, "conv_kernels", ()),
                                       getattr(net, "conv_biases", ()))):
            w.copy_(tensor(layers[f"Conv_{i}"]["kernel"], device).permute(
                3, 2, 0, 1))
            b.copy_(tensor(layers[f"Conv_{i}"]["bias"], device))
        for i, (w, b) in enumerate(zip(net.kernels, net.biases)):
            w.copy_(tensor(layers[f"Dense_{i}"]["kernel"], device))
            b.copy_(tensor(layers[f"Dense_{i}"]["bias"], device))
    return net


def qnet_to_flax(net: QNet) -> Dict[str, Any]:
    """A Q-net → flax-layout numpy dict (OIHW conv kernels back to
    HWIO)."""
    layers = {
        f"Dense_{i}": {"kernel": w.detach().cpu().numpy(),
                       "bias": b.detach().cpu().numpy()}
        for i, (w, b) in enumerate(zip(net.kernels, net.biases))}
    for i, (w, b) in enumerate(zip(getattr(net, "conv_kernels", ()),
                                   getattr(net, "conv_biases", ()))):
        layers[f"Conv_{i}"] = {
            "kernel": w.detach().permute(2, 3, 1, 0).contiguous().cpu()
            .numpy(), "bias": b.detach().cpu().numpy()}
    return {"params": layers}


def _leaves(tree: Dict[str, Any]) -> List[np.ndarray]:
    """flax leaves in the port's flat order (conv_kernel_0, conv_bias_0,
    ..., kernel_0, bias_0, ...), conv kernels as OIHW."""
    layers = tree["params"]
    out = []
    for i in range(_count(layers, "Conv_")):
        out += [np.ascontiguousarray(np.transpose(
            np.asarray(layers[f"Conv_{i}"]["kernel"]), (3, 2, 0, 1))),
            layers[f"Conv_{i}"]["bias"]]
    for i in range(_count(layers, "Dense_")):
        out += [layers[f"Dense_{i}"]["kernel"], layers[f"Dense_{i}"]["bias"]]
    return out


def adam_from_optax(opt_state, device="cpu") -> AdamState:
    """optax.adam's state ``(ScaleByAdamState(count, mu, nu), ...)``."""
    adam = opt_state[0]
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu=[tensor(x, device) for x in _leaves(adam.mu)],
        nu=[tensor(x, device) for x in _leaves(adam.nu)])


def dqn_state_from_jax(ag_state, device="cpu", obs_shape=None,
                       conv_specs=None) -> DQNState:
    """The JAX ``DQNState`` (after ``jax.device_get``) → the port's; a
    conv net needs its ``obs_shape`` and ``conv_specs``
    (:func:`qnet_from_flax`)."""
    return DQNState(
        params=qnet_from_flax(ag_state.params, device, obs_shape, conv_specs),
        target_params=qnet_from_flax(ag_state.target_params, device, obs_shape,
                                conv_specs),
        opt_state=adam_from_optax(ag_state.opt_state, device),
        epsilon=tensor(np.float32(np.asarray(ag_state.epsilon)), device))


def tstate_from_jax(tstate, device="cpu") -> TState:
    return TState(*(tensor(getattr(tstate, f), device).contiguous()
                    for f in TState._fields))


def batch_from_jax(batch, device="cpu") -> Dict[str, torch.Tensor]:
    """A feature-major replay batch (obs / next_obs (obs_dim, B), actions,
    rewards, dones (B,)) → f32 tensors, actions int32."""
    return {k: tensor(np.asarray(v).astype(
        np.int32 if k == "actions" else np.float32), device)
        for k, v in batch.items()}


def _host_key(rng) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rng).astype(np.uint32).astype(np.int64))


def replay_state_from_jax(bstate, device="cpu") -> ReplayState:
    """``replay.ReplayState`` (storage dict, cursor, size) → the port's,
    with cursor and size as host ints."""
    return ReplayState(
        storage={k: tensor(v, device) for k, v in bstate.storage.items()},
        cursor=int(np.asarray(bstate.cursor)),
        size=int(np.asarray(bstate.size)))


def stream_carry_from_jax(carry, device="cpu", **net):
    """The JAX full or fused trainer's carry ``(rng, tstate, obs_t,
    ag_state, bstate, step)`` → the port's (the rng key on the host,
    ``step`` a Python int; ``net``: a conv net's ``obs_shape`` and
    ``conv_specs``)."""
    rng, tstate, obs_t, ag_state, bstate, step = carry
    return (_host_key(rng), tstate_from_jax(tstate, device),
            tensor(obs_t, device).contiguous(),
            dqn_state_from_jax(ag_state, device, **net),
            replay_state_from_jax(bstate, device), int(np.asarray(step)))


def ring_carry_from_jax(carry, device="cpu", **net):
    """The JAX ring trainer's carry ``(rng, (tstate, ring), (a_ring,
    r_ring, d_ring), ag_state, aux, step)`` → the port's carry (the rng
    key stays on the host; ``step`` becomes a Python int; ``aux``, the
    in-kernel TD path's carried batch, becomes a dict of tensors, or
    stays ``()``; ``net``: a conv net's ``obs_shape`` and
    ``conv_specs``)."""
    rng, (tstate, ring), scalar_rings, ag_state, aux, step = carry
    return (
        _host_key(rng),
        (tstate_from_jax(tstate, device), tensor(ring, device)),
        tuple(tensor(r, device) for r in scalar_rings),
        dqn_state_from_jax(ag_state, device, **net),
        batch_from_jax(aux, device) if len(aux) else (),
        int(np.asarray(step)),
    )
