"""The batched env step on row-major state: one kernel launch per step.

Counterpart of ``dronerl_tpu/ops/step_kernel.py`` (``_step_kernel``,
launched by ``step_batch_fused``, B5): per-env threefry keys, movement,
collisions, battery, pickup and delivery, packet / dropzone / drone
respawns and rewards, on the row-major ``EnvState`` (ground (E, G, G),
drone fields (E, N)), with no observation. Bit-equal to
``core.step_batch(split(step_key, E), states, actions, params)``.

On CUDA tensors :func:`step_batch_fused` launches the hand-written kernel
of ``csrc/env_kernel.cu`` in its row-major layout (``step_launch``: a
block stages its envs' contiguous spans through shared memory and steps
each env with one warp on ``csrc/env_warp.cuh``, the kernel B4 runs
feature-major) and counts the launch in ``step_batch_fused.launches``;
on CPU tensors it runs :func:`step_batch_plain`, the port's
``core.step_batch``. No trainer calls it, as in the JAX package.
"""

import ctypes
from typing import List, Tuple

import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.ops import _build
from dronerl_tpu_torch.ops.fused_tick import EnvArgs, key_words
from dronerl_tpu_torch.ops.learner_kernel import check_tensor

# The JAX kernel's limits (dronerl_tpu/ops/step_kernel.py), which
# csrc/env_kernel.cu's row-major step takes too.
MAX_CELLS = 512
MAX_DRONES = 64
MIN_ENVS = 8


def kernel_problems(params: EnvParams, num_envs: int) -> List[str]:
    """What the CUDA step kernel does not take in this configuration."""
    problems = []
    if params.num_cells > MAX_CELLS:
        problems.append(f"{params.num_cells} cells > {MAX_CELLS}")
    if params.n_drones > MAX_DRONES:
        problems.append(f"n_drones={params.n_drones} > {MAX_DRONES}")
    if params.num_packets < params.n_drones:
        problems.append("num_packets < n_drones")
    if num_envs < MIN_ENVS:
        problems.append(f"num_envs={num_envs} < {MIN_ENVS}")
    return problems


def supports(params: EnvParams, num_envs: int) -> bool:
    """Whether the kernel covers this configuration (the JAX package's
    ``step_kernel.supports``)."""
    return not kernel_problems(params, num_envs)


@rng.plain_draws()
def step_batch_plain(step_key: torch.Tensor, states: EnvState,
                     actions: torch.Tensor, params: EnvParams):
    """The kernel's function in plain PyTorch, on any device."""
    num_envs = states.charge.shape[0]
    keys = rng.split(step_key.to(states.charge.device), num_envs)
    return core.step_batch(keys, states, actions, params)


def _kernel_args(step_key, states: EnvState, actions, params: EnvParams
                 ) -> Tuple[EnvArgs, Tuple[EnvState, torch.Tensor,
                                           torch.Tensor]]:
    """Check the inputs, allocate the outputs and fill the launch's
    argument block. Returns ``(args, (state', rewards, dones))``."""
    device = states.charge.device
    num_envs = states.charge.shape[0]
    g, n = params.grid_size, params.n_drones
    problems = kernel_problems(params, num_envs)
    if problems:
        raise ValueError("the CUDA step kernel does not take this "
                         "configuration: " + "; ".join(problems))
    check_tensor(states.ground, "ground", torch.int8, (num_envs, g, g),
                 device)
    for name, t, dt in (("air_x", states.air_x, torch.int32),
                        ("air_y", states.air_y, torch.int32),
                        ("carrying_package", states.carrying_package,
                         torch.bool),
                        ("charge", states.charge, torch.float32),
                        ("actions", actions, torch.int32)):
        check_tensor(t, name, dt, (num_envs, n), device)
    if step_key.device.type != "cpu" or tuple(step_key.shape) != (2,):
        raise ValueError("step_key must be a host key of shape (2,)")

    # bool tensors hold one byte of 0 or 1: the kernel's int8 flags.
    ins = (states.ground, states.air_x, states.air_y,
           states.carrying_package, states.charge)
    outs = EnvState(*(torch.empty_like(t) for t in ins))
    rewards = torch.empty((num_envs, n), dtype=torch.float32, device=device)
    dones = torch.empty((num_envs, n), dtype=torch.bool, device=device)

    a = EnvArgs()  # obs_out stays null: the step writes no observation
    (a.ground_in, a.ax_in, a.ay_in, a.carry_in, a.charge_in) = (
        t.data_ptr() for t in ins)
    a.actions = actions.data_ptr()
    (a.ground_out, a.ax_out, a.ay_out, a.carry_out, a.charge_out) = (
        t.data_ptr() for t in (outs.ground, outs.air_x, outs.air_y,
                               outs.carrying_package, outs.charge))
    a.rewards, a.dones = rewards.data_ptr(), dones.data_ptr()
    a.num_envs = num_envs
    a.key_words = key_words(step_key, device)  # kept alive with the block
    a.key = a.key_words.data_ptr()
    a.pickup_reward = params.pickup_reward
    a.delivery_reward = params.delivery_reward
    a.crash_reward = params.crash_reward
    a.charge_reward = params.charge_reward
    return a, (outs, rewards, dones)


def step_batch_fused(step_key: torch.Tensor, states: EnvState,
                     actions: torch.Tensor, params: EnvParams):
    """One step of every env: env e with row e of ``split(step_key, E)``
    and its actions ``actions[e]`` (E, N) int32. ``step_key`` is a host
    key (2,). Returns ``(state', rewards (E, N) f32, dones (E, N)
    bool)``."""
    if not states.charge.is_cuda:
        return step_batch_plain(step_key, states, actions, params)
    args, outs = _kernel_args(step_key, states, actions, params)
    lib = _build.load(_build.env_config(params))
    stream = torch.cuda.current_stream(states.charge.device).cuda_stream
    err = lib.step_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError("step_launch failed: "
                           + _build.error_string(lib, err))
    step_batch_fused.launches += 1
    return outs


step_batch_fused.launches = 0
