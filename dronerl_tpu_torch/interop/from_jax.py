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

from dronerl_tpu_torch.agents.dqn import AdamState, DenseQNet, DQNState
from dronerl_tpu_torch.ops.fused_tick import TState
from dronerl_tpu_torch.replay import ReplayState


def tensor(arr, device="cpu") -> torch.Tensor:
    """numpy (bfloat16 included, as ml_dtypes stores it) → torch."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        raw = torch.from_numpy(np.array(arr, copy=True).view(np.int16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def qnet_from_flax(params: Dict[str, Any], device="cpu") -> DenseQNet:
    """flax ``{"params": {"Dense_i": {"kernel", "bias"}}}`` → DenseQNet."""
    layers = params["params"]
    kernels = [np.asarray(layers[f"Dense_{i}"]["kernel"])
               for i in range(len(layers))]
    net = DenseQNet(kernels[0].shape[0],
                    tuple(k.shape[1] for k in kernels[:-1]), device)
    with torch.no_grad():
        for i, (w, b) in enumerate(zip(net.kernels, net.biases)):
            w.copy_(tensor(layers[f"Dense_{i}"]["kernel"], device))
            b.copy_(tensor(layers[f"Dense_{i}"]["bias"], device))
    return net


def qnet_to_flax(net: DenseQNet) -> Dict[str, Any]:
    """DenseQNet → flax-layout numpy dict (for comparisons)."""
    return {"params": {
        f"Dense_{i}": {"kernel": w.detach().cpu().numpy(),
                       "bias": b.detach().cpu().numpy()}
        for i, (w, b) in enumerate(zip(net.kernels, net.biases))}}


def _leaves(tree: Dict[str, Any]) -> List[np.ndarray]:
    """Dense flax leaves in the port's flat order (kernel_0, bias_0, ...)."""
    layers = tree["params"]
    out = []
    for i in range(len(layers)):
        out += [layers[f"Dense_{i}"]["kernel"], layers[f"Dense_{i}"]["bias"]]
    return out


def adam_from_optax(opt_state, device="cpu") -> AdamState:
    """optax.adam's state ``(ScaleByAdamState(count, mu, nu), ...)``."""
    adam = opt_state[0]
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu=[tensor(x, device) for x in _leaves(adam.mu)],
        nu=[tensor(x, device) for x in _leaves(adam.nu)])


def dqn_state_from_jax(ag_state, device="cpu") -> DQNState:
    return DQNState(
        params=qnet_from_flax(ag_state.params, device),
        target_params=qnet_from_flax(ag_state.target_params, device),
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


def stream_carry_from_jax(carry, device="cpu"):
    """The JAX full or fused trainer's carry ``(rng, tstate, obs_t,
    ag_state, bstate, step)`` → the port's (the rng key on the host,
    ``step`` a Python int)."""
    rng, tstate, obs_t, ag_state, bstate, step = carry
    return (_host_key(rng), tstate_from_jax(tstate, device),
            tensor(obs_t, device).contiguous(),
            dqn_state_from_jax(ag_state, device),
            replay_state_from_jax(bstate, device), int(np.asarray(step)))


def ring_carry_from_jax(carry, device="cpu"):
    """The JAX ring trainer's carry ``(rng, (tstate, ring), (a_ring,
    r_ring, d_ring), ag_state, aux, step)`` → the port's carry (the rng
    key stays on the host; ``step`` becomes a Python int; ``aux``, the
    in-kernel TD path's carried batch, becomes a dict of tensors, or
    stays ``()``)."""
    rng, (tstate, ring), scalar_rings, ag_state, aux, step = carry
    return (
        _host_key(rng),
        (tstate_from_jax(tstate, device), tensor(ring, device)),
        tuple(tensor(r, device) for r in scalar_rings),
        dqn_state_from_jax(ag_state, device),
        batch_from_jax(aux, device) if len(aux) else (),
        int(np.asarray(step)),
    )
