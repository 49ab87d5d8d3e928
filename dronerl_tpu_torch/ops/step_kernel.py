"""The batched env step on row-major state: one kernel launch per step.

Counterpart of ``dronerl_tpu/ops/step_kernel.py`` (``_step_kernel``,
launched by ``step_batch_fused``, B5): per-env threefry keys, movement,
collisions, battery, pickup and delivery, packet / dropzone / drone
respawns and rewards, on the row-major ``EnvState`` (ground (E, G, G),
drone fields (E, N)). Bit-equal to ``core.step_batch(split(step_key, E),
states, actions, params)``; with ``collect`` = k it also writes the
first k drones' observations of the stepped state, ``core.observe_batch(
state', params, k)`` as the jnp engine's (E, k, obs_dim) f32 array (the
charge channel within 1.3e-7, as B4's).

On CUDA tensors :func:`step_batch_fused` launches the hand-written kernel
of ``csrc/env_kernel.cu`` in its row-major layout (``step_launch``: a
block stages its envs' contiguous spans through shared memory, steps
each env with one warp on ``csrc/env_warp.cuh``, the kernel B4 runs
feature-major, and writes the observation in one block-wide pass) and
counts the launch in ``step_batch_fused.launches``; on CPU tensors it
runs :func:`step_batch_plain`, the port's ``core.step_batch`` (and
``observe_batch``). The jnp engine's tick calls it with the observation
on a card (``train.step_route``), the counterpart of the step and
observation that XLA fuses in the JAX package's jnp engine (whose Pallas
step kernel no trainer calls).
"""

import ctypes
from typing import List, Optional, Tuple

import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.ops import _build, fused_tick
from dronerl_tpu_torch.ops.fused_tick import EnvArgs, key_words
from dronerl_tpu_torch.ops.learner_kernel import check_tensor

# The JAX kernel's limits (dronerl_tpu/ops/step_kernel.py), which
# csrc/env_kernel.cu's row-major step takes too.
MAX_CELLS = 512
MAX_DRONES = 64
MIN_ENVS = 8
# The step's observation exists within the tick kernels' limits
# (env_kernel.cu's TICK).
OBS_MAX_CELLS = 256
OBS_MAX_DRONES = 32


def observation_problems(params: EnvParams, collect: int) -> List[str]:
    """What the CUDA step kernel's observation does not take: the tick
    kernels' cells and drones, ``collect`` in [1, n_drones]."""
    problems = []
    if params.num_cells > OBS_MAX_CELLS:
        problems.append(f"{params.num_cells} cells > {OBS_MAX_CELLS} (the "
                        "step's observation)")
    if params.n_drones > OBS_MAX_DRONES:
        problems.append(f"n_drones={params.n_drones} > {OBS_MAX_DRONES} "
                        "(the step's observation)")
    if not 1 <= collect <= params.n_drones:
        problems.append(f"collect_drones={collect} outside [1, "
                        f"{params.n_drones}]")
    return problems


def board_problems(params: EnvParams) -> List[str]:
    """What the CUDA step kernel does not take of this env: more than
    MAX_CELLS cells or MAX_DRONES drones, fewer packets than drones."""
    problems = []
    if params.num_cells > MAX_CELLS:
        problems.append(f"{params.num_cells} cells > {MAX_CELLS}")
    if params.n_drones > MAX_DRONES:
        problems.append(f"n_drones={params.n_drones} > {MAX_DRONES}")
    if params.num_packets < params.n_drones:
        problems.append("num_packets < n_drones")
    return problems


def kernel_problems(params: EnvParams, num_envs: int) -> List[str]:
    """The JAX package's gate (``step_kernel.supports``): the board's
    limits and its kernel's MIN_ENVS. The CUDA kernel takes any count
    from 1 (a block's partial tile); the jnp engine's route
    (``train.step_problems``) asks the board and the observation only."""
    problems = board_problems(params)
    if num_envs < MIN_ENVS:
        problems.append(f"num_envs={num_envs} < {MIN_ENVS}")
    return problems


def supports(params: EnvParams, num_envs: int) -> bool:
    """Whether the kernel covers this configuration (the JAX package's
    ``step_kernel.supports``)."""
    return not kernel_problems(params, num_envs)


@rng.plain_draws()
def step_batch_plain(step_key: torch.Tensor, states: EnvState,
                     actions: torch.Tensor, params: EnvParams,
                     collect: Optional[int] = None):
    """The kernel's function in plain PyTorch, on any device: the step,
    and with ``collect`` the observation (:func:`step_batch_fused`).
    ``step_key`` as there: int64 words or a row's int32 words."""
    num_envs = states.charge.shape[0]
    device = states.charge.device
    key = step_key.to(device, torch.int64) & rng.MASK32
    out = core.step_batch(rng.split(key, num_envs), states, actions, params)
    if collect is None:
        return out
    obs = core.observe_batch(out[0], params, collect).reshape(
        num_envs, collect, -1)
    return (*out, obs)


def _kernel_args(step_key, states: EnvState, actions, params: EnvParams,
                 collect: Optional[int] = None) -> Tuple[EnvArgs, tuple]:
    """Check the inputs, allocate the outputs and fill the launch's
    argument block. Returns ``(args, (state', rewards, dones[, obs]))``."""
    device = states.charge.device
    num_envs = states.charge.shape[0]
    g, n = params.grid_size, params.n_drones
    problems = board_problems(params)
    if collect is not None:
        problems += observation_problems(params, collect)
    if num_envs < 1:
        problems.append("no env")
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

    # bool tensors hold one byte of 0 or 1: the kernel's int8 flags.
    ins = (states.ground, states.air_x, states.air_y,
           states.carrying_package, states.charge)
    outs = EnvState(*(torch.empty_like(t) for t in ins))
    rewards = torch.empty((num_envs, n), dtype=torch.float32, device=device)
    dones = torch.empty((num_envs, n), dtype=torch.bool, device=device)

    a = EnvArgs()  # obs_out stays null where no observation is asked for
    outputs = (outs, rewards, dones)
    if collect is not None:
        obs = torch.empty((num_envs, collect, fused_tick.obs_rows(params)),
                          dtype=torch.float32, device=device)
        a.obs_out = obs.data_ptr()
        outputs += (obs,)
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
    return a, outputs


def step_batch_fused(step_key: torch.Tensor, states: EnvState,
                     actions: torch.Tensor, params: EnvParams,
                     collect: Optional[int] = None):
    """One step of every env: env e with row e of ``split(step_key, E)``
    and its actions ``actions[e]`` (E, N) int32. ``step_key`` (2,) is a
    host key, or the step key's two words on the state's device (int64
    words, or a chunk row's int32 words, which the kernel reads by
    pointer: a CUDA graph's replay reads its row's key). Returns
    ``(state', rewards (E, N) f32, dones (E, N) bool)``, and with
    ``collect`` = k the first k drones' observations of ``state'``, (E,
    k, obs_dim) f32, last. The library is the env's at k drones
    collected and 20 rounds (``_build.env_config(params, k)``)."""
    if not states.charge.is_cuda:
        return step_batch_plain(step_key, states, actions, params, collect)
    args, outs = _kernel_args(step_key, states, actions, params, collect)
    lib = _build.load(_build.env_config(params, collect or 1))
    stream = torch.cuda.current_stream(states.charge.device).cuda_stream
    err = lib.step_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError("step_launch failed: "
                           + _build.error_string(lib, err))
    step_batch_fused.launches += 1
    return outs


step_batch_fused.launches = 0
