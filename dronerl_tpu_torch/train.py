"""DQN training (counterpart of ``dronerl_tpu/train.py``): the ring engine,
the two StreamReplay engines and the jnp engine.

Ring engine (:func:`build_train_step_ring`). One tick: split the host
key three ways; one launch of the fused tick kernel (the whole env side:
actor, physics, respawns, observation, the periodic reset, the write of
the next observation into the replay ring); the scalar-ring writes; a
uniform replay sample off the ring; the TD(0) Adam step; the target and
ε schedules. The replay ring IS the kernel's observation buffer, written
in place.

With ``in_kernel_td`` the TD(0) + Adam step is one launch of the learner
kernel right after the tick kernel's, on the batch gathered after the
tick before (carried in the carry's ``aux`` slot), as the JAX trainer's
in-kernel TD path pipelines it; the default is the PyTorch learner
(``DQN.train_step_t``), as in the JAX trainer.

Full engine (:func:`build_train_step_full`). One tick: split the host
key three ways; one launch of the full tick kernel (B3: the actor on the
carried observation, the env side, the periodic reset, the next
observation into a new array); push the tick's input observation and
drone 0's action, reward and done into a ``replay.StreamReplay``; sample
and take the TD(0) Adam step once the replay can be sampled; the
schedules.

Fused engine (:func:`build_train_step_fused`). One tick: split the host
key six ways; random opponents and drone 0's ε-greedy action
(``DQN.act_t``, any net: the CLI runs it for conv nets without
``--conv_matmul``, whose actor the tick kernels do not run) drawn on the
device; one launch of the env tick kernel (B4); push, sample, learn and
schedules as the full engine; on a reset tick, ``core.reset_batch`` and
``observe_batch`` in plain PyTorch.

The ring and full engines hand the tick kernels the actor as a matmul
chain (``fused_tick.flatten_net_params``): a dense net's layers, or with
``conv_matmul`` a conv net's im2col lowering, rebuilt from the live
weights every tick as the JAX trainers rebuild it.

jnp engine (:func:`build_train_step`, plain PyTorch). One tick: split
the host key six ways; random opponents and drone 0's ε-greedy action
(``DQN.act``); ``core.step_batch`` and ``observe_batch``; push the whole
transitions (``next_obs`` included) into a row-major
``replay.ReplayBuffer``; sample and take the TD(0) Adam step once the
buffer holds a batch; the schedules; the periodic reset. It launches no
kernel of the port: the JAX CLI runs it where its fused kernels do not
apply (fewer than 128 envs, among others), and so does this one.

With ``collect_drones`` = k the first k drones of every env feed the
replay, as in the JAX trainers: the ring engine's columns hold k row
groups of observations, its scalar rings (k, columns), and a sample draws
batch_size // k columns per drone; the StreamReplay engines push E · k
transitions a tick (the drones' observations concatenated drone-major);
the actor still acts for drone 0 alone. ``rng_rounds`` /
``actor_rng_rounds`` (the CLI's ``--fast_rng``) reach the tick kernels'
in-kernel hashes; the host's draws (the per-tick split, the replay
sample, the fused engine's opponents and ``act_t``) stay at 20 rounds.

The CLI chooses an engine as the JAX CLI does (:func:`choose_engine`)
and runs the JAX CLI's lifecycle around it (:func:`train`): the warm
start and resume, chunks of ``--max_scan_steps`` ticks with per-chunk
scalars and histograms, the eval while training and the final eval
(:func:`evaluate`, the plain env core with the seeds as a batch),
``--profile``, ``--inspect_memory``, both weights checkpoints, the train
state, the video and ``metrics.json``. It takes every flag of the JAX
CLI but the sharding flags and ``--jax_cache_dir`` (``REFUSED_FLAGS``).

The step counter, the ring slot arithmetic, the reset flag, the count of
valid columns, the replay's cursor and size and the rng chain stay on the
host: they are a few scalar hashes a tick, and reading them back from the
device every tick would serialise the loop. The key words reach the
kernels as launch arguments.

Run:  python -m dronerl_tpu_torch.train --num_envs 65536 --num_steps 300
"""

import argparse
import ast
import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import statistics
import sys
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from dronerl_tpu_torch import replay, resolve_device, rng as rng_mod
from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DQN, DQNConfig)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams, EnvState, env_fields
from dronerl_tpu_torch.evaluator.evaluator import seed_keys
from dronerl_tpu_torch.interop import safetensors_io, train_state_io
from dronerl_tpu_torch.interop.from_jax import qnet_from_flax
from dronerl_tpu_torch.ops import fused_tick
from dronerl_tpu_torch.utils import profiling
from dronerl_tpu_torch.utils.graphs import scan
from dronerl_tpu_torch.utils.metrics import NoLogger, build_logger

logger = logging.getLogger("dronerl_tpu_torch.train")

TRAIN_STATE_FILE = "train_state.safetensors"


def build_train_step_ring(agent: DQN, env_params: EnvParams, num_envs: int,
                          capacity: int, batch_size: int,
                          reset_env_every: int, collect_drones: int = 1,
                          in_kernel_td: Optional[bool] = None,
                          rng_rounds: int = 20,
                          actor_rng_rounds: Optional[int] = None):
    """The ring-engine tick: ``tick(carry) -> (carry, (rewards (E,),
    epsilon, loss))``, with the JAX trainer's carry layout ``(rng,
    (tstate, ring), (a_ring, r_ring, d_ring), ag_state, aux, step)``.

    ``capacity`` counts ring columns; each holds ``collect_drones`` = k
    transitions (pass the same k to :func:`init_ring_carry`), and
    ``batch_size`` must be a multiple of k. ``loss`` is ``NO_TRAIN_LOSS``
    on ticks where the ring holds fewer than ``batch_size // k`` complete
    columns. With ``in_kernel_td`` (pass the same to
    :func:`init_ring_carry`) the learner kernel trains inside tick t+1 on
    the batch gathered after tick t, carried in ``aux``; tick 0 never
    trains.
    """
    k = collect_drones
    if capacity % num_envs != 0 or capacity < 2 * num_envs:
        raise ValueError("capacity must be a multiple of num_envs, >= 2x")
    if batch_size % k != 0:
        raise ValueError("batch_size must be a multiple of collect_drones")
    _require_kernel_actor(agent, "ring")
    if in_kernel_td and agent.config.network_type != "dense":
        raise ValueError(
            "in_kernel_td requires a dense network (got network_type=%s)"
            % agent.config.network_type)
    nb = capacity // num_envs  # ring length in ticks
    device = agent.device
    rng_collect = dict(collect=k, rng_rounds=rng_rounds,
                       actor_rng_rounds=actor_rng_rounds)
    td_hparams = None
    if in_kernel_td:
        td_hparams = (float(agent.config.gamma),
                      float(agent.config.learning_rate),
                      ADAM_B1, ADAM_B2, ADAM_EPS)  # optax.adam's defaults

    def tick(carry):
        rng, (tstate, ring), (a_ring, r_ring, d_ring), ag_state, aux, step = (
            carry)
        keys = rng_mod.split(rng, 3)
        rng, step_key, sample_key = keys[0], keys[1], keys[2]

        read_slot = (step % nb) * num_envs
        write_slot = ((step + 1) % nb) * num_envs
        chain = fused_tick.flatten_net_params(ag_state.params,
                                              agent.net_spec)
        args = (step_key, tstate, ring, read_slot, write_slot, chain,
                ag_state.epsilon, step % reset_env_every == 0, env_params)
        if td_hparams is not None:
            # The carried batch was gathered after the tick before with
            # valid = min(step, nb-1) columns (zero-seeded at step 0,
            # which never trains).
            can_train = min(step, nb - 1) * num_envs >= batch_size // k
            adam = ag_state.opt_state
            tstate, rewards_t, dones_t, actions_t, ring, _, _, _, loss = (
                fused_tick.full_tick_fused_ring(
                    *args, td_hparams=td_hparams, td_batch=aux,
                    td_aux=(ag_state.params, ag_state.target_params,
                            adam.mu, adam.nu, can_train, adam.count),
                    **rng_collect))
            if can_train:
                adam.count += 1
        else:
            tstate, rewards_t, dones_t, actions_t, ring = (
                fused_tick.full_tick_fused_ring(*args, **rng_collect))

        # Scalars live at the same slot as this tick's input observation.
        a_ring, r_ring, d_ring = fused_tick.ring_scalar_writes(
            a_ring, r_ring, d_ring, actions_t, rewards_t, dones_t, read_slot,
            k)

        # Complete columns after tick t: steps [max(0, t+2-nb), t].
        valid = min(step + 1, nb - 1) * num_envs
        if td_hparams is not None or valid >= batch_size // k:
            batch = fused_tick.ring_gather_batch(
                sample_key, ring, a_ring, r_ring, d_ring, valid,
                max(0, step + 2 - nb), num_envs=num_envs, capacity=capacity,
                batch_size=batch_size, collect=k, obs_dim=agent.obs_dim)
        if td_hparams is not None:
            aux = batch  # trained on inside the next tick
        elif valid >= batch_size // k:
            ag_state, loss = agent.train_step_t(ag_state, batch)
        else:
            loss = torch.tensor(NO_TRAIN_LOSS, device=device)
        ag_state = agent.apply_schedules(ag_state, step, dones_t[0, 0])

        carry = (rng, (tstate, ring), (a_ring, r_ring, d_ring), ag_state,
                 aux, step + 1)
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return tick


def init_ring_carry(agent: DQN, env_params: EnvParams, num_envs: int,
                    capacity: int, rng: torch.Tensor,
                    obs_dtype=torch.float32,
                    batch_size: Optional[int] = None,
                    in_kernel_td: Optional[bool] = None,
                    collect_drones: int = 1):
    """Initial carry for :func:`build_train_step_ring`: envs reset with
    ``rng``, the ring (k · obs_dim rows for ``collect_drones`` = k, the
    drones' observations drone-major) seeded with their observations at
    slot 0, scalar rings (capacity,) for k = 1 and (k, capacity) beyond, a
    fresh agent drawn from ``rng`` as the JAX trainer draws it.

    With ``in_kernel_td`` (pass the same to the tick's builder) ``aux``
    is a zero batch of ``batch_size`` columns, never trained on; else
    ``()``.
    """
    device = agent.device
    if in_kernel_td and batch_size is None:
        raise ValueError("in_kernel_td carries the replay batch through "
                         "the carry: pass batch_size")
    aux = ()
    if in_kernel_td:
        zeros = functools.partial(torch.zeros, device=device)
        aux = {
            "obs": zeros((agent.obs_dim, batch_size), dtype=torch.float32),
            "next_obs": zeros((agent.obs_dim, batch_size),
                              dtype=torch.float32),
            "actions": zeros((batch_size,), dtype=torch.int32),
            "rewards": zeros((batch_size,), dtype=torch.float32),
            "dones": zeros((batch_size,), dtype=torch.float32),
        }
    k = collect_drones
    env_states = env_core.reset_batch(rng.to(device), env_params, num_envs)
    tstate = fused_tick.to_tstate(env_states)
    ring = torch.zeros((k * agent.obs_dim, capacity), dtype=obs_dtype,
                       device=device)
    ring[:, :num_envs] = _stacked_obs(env_states, env_params, k).to(
        obs_dtype)
    scalar_shape = (capacity,) if k == 1 else (k, capacity)
    return (
        rng.cpu(), (tstate, ring),
        (torch.zeros(scalar_shape, dtype=torch.int32, device=device),
         torch.zeros(scalar_shape, dtype=torch.float32, device=device),
         torch.zeros(scalar_shape, dtype=torch.int8, device=device)),
        agent.init_state(rng), aux, 0,
    )


def _stacked_obs(states, env_params: EnvParams, k: int) -> torch.Tensor:
    """The first k drones' observations of every env, feature-major and
    drone-major: (k · obs_dim, E) f32."""
    obs = env_core.observe_batch(states, env_params, k)
    return obs.reshape(obs.shape[0], -1).t().contiguous()


def _require_kernel_actor(agent: DQN, engine: str) -> None:
    """The ring and full engines run the actor inside the tick kernel: a
    dense net, or a conv net's im2col chain (``conv_matmul``)."""
    if agent.config.network_type == "conv" and agent.net_spec is None:
        raise ValueError(
            f"the {engine} engine runs the actor in-kernel; conv networks "
            "need conv_matmul=True (CLI: --conv_matmul) so the kernel and "
            "the learner share the im2col contraction structure")


# --- the StreamReplay engines -----------------------------------------------

def _push_and_learn(agent: DQN, buffer: replay.StreamReplay, bstate,
                    ag_state, sample_key, obs_t, actions_t, rewards_t,
                    dones_t, k: int):
    """Push the tick's input observations of the first k drones (the
    drones' row groups side by side, drone-major: (obs_dim, k · E)) with
    their actions, rewards and dones; sample and take the TD step once
    the replay can be sampled (else loss ``NO_TRAIN_LOSS``). Returns
    ``(bstate, ag_state, loss)``."""
    obs_dim = agent.obs_dim
    num_envs = obs_t.shape[-1]
    obs = obs_t if k == 1 else obs_t.reshape(k, obs_dim, num_envs).permute(
        1, 0, 2).reshape(obs_dim, k * num_envs)
    bstate = buffer.push_many(bstate, {
        "obs": obs, "actions": actions_t[:k].reshape(-1),
        "rewards": rewards_t[:k].reshape(-1),
        "dones": dones_t[:k].reshape(-1)})
    if buffer.can_sample(bstate):
        batch = buffer.sample(sample_key, bstate)
        batch["dones"] = batch["dones"].to(torch.float32)
        ag_state, loss = agent.train_step_t(ag_state, batch)
    else:
        loss = torch.tensor(NO_TRAIN_LOSS, device=agent.device)
    return bstate, ag_state, loss


def build_train_step_full(agent: DQN, buffer: replay.StreamReplay,
                          env_params: EnvParams, num_envs: int,
                          reset_env_every: int, collect_drones: int = 1,
                          rng_rounds: int = 20,
                          actor_rng_rounds: Optional[int] = None):
    """The full-engine tick around the full tick kernel (B3): ``tick(carry)
    -> (carry, (rewards (E,), epsilon, loss))`` with the JAX trainer's
    carry ``(rng, tstate, obs_t, ag_state, bstate, step)``
    (:func:`init_stream_carry`). The replay's stride is E ·
    ``collect_drones``. ``loss`` is ``NO_TRAIN_LOSS`` on ticks where the
    replay holds fewer than a batch of transitions."""
    k = collect_drones
    _require_kernel_actor(agent, "full")

    def tick(carry):
        rng, tstate, obs_t, ag_state, bstate, step = carry
        rng, step_key, sample_key = rng_mod.split(rng, 3)
        chain = fused_tick.flatten_net_params(ag_state.params,
                                              agent.net_spec)
        tstate, rewards_t, dones_t, actions_t, next_obs_t = (
            fused_tick.full_tick_fused(
                step_key, tstate, obs_t, chain, ag_state.epsilon,
                step % reset_env_every == 0, env_params, k, rng_rounds,
                actor_rng_rounds))
        bstate, ag_state, loss = _push_and_learn(
            agent, buffer, bstate, ag_state, sample_key, obs_t, actions_t,
            rewards_t, dones_t, k)
        ag_state = agent.apply_schedules(ag_state, step, dones_t[0, 0])
        carry = (rng, tstate, next_obs_t, ag_state, bstate, step + 1)
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return tick


def build_train_step_fused(agent: DQN, buffer: replay.StreamReplay,
                           env_params: EnvParams, num_envs: int,
                           reset_env_every: int, collect_drones: int = 1,
                           rng_rounds: int = 20):
    """The fused-engine tick around the env tick kernel (B4), for any net:
    the actions come from outside the kernel (random opponents and drone
    0's ``DQN.act_t``, drawn on the device at 20 rounds; a conv net's own
    forward) and the periodic reset runs after the step in plain PyTorch
    at 20 rounds, as in the JAX trainer; ``rng_rounds`` reaches the
    kernel. Carry and outputs as :func:`build_train_step_full`."""
    k = collect_drones
    obs_dim = agent.obs_dim
    device = agent.device

    def tick(carry):
        rng, tstate, obs_t, ag_state, bstate, step = carry
        rng, rand_key, act_key, step_key, sample_key, reset_key = (
            rng_mod.split(rng, 6))
        # N x E and E counters: hashed on the device, not the host.
        actions_t = rng_mod.randint(rand_key.to(device),
                                    (env_params.n_drones, num_envs), 0,
                                    NUM_ACTIONS)
        actions_t[0] = agent.act_t(act_key, obs_t[:obs_dim], ag_state)
        tstate, rewards_t, dones_t, next_obs_t = fused_tick.tick_fused(
            step_key, tstate, actions_t, env_params, k, rng_rounds)
        bstate, ag_state, loss = _push_and_learn(
            agent, buffer, bstate, ag_state, sample_key, obs_t, actions_t,
            rewards_t, dones_t, k)
        ag_state = agent.apply_schedules(ag_state, step, dones_t[0, 0])
        if step % reset_env_every == 0:
            states = env_core.reset_batch(reset_key.to(device), env_params,
                                          num_envs)
            tstate = fused_tick.to_tstate(states)
            next_obs_t = _stacked_obs(states, env_params, k)
        carry = (rng, tstate, next_obs_t, ag_state, bstate, step + 1)
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return tick


def init_stream_carry(agent: DQN, env_params: EnvParams, num_envs: int,
                      buffer: replay.StreamReplay, rng: torch.Tensor,
                      collect_drones: int = 1):
    """Initial carry ``(rng, tstate, obs_t, ag_state, bstate, 0)`` for the
    StreamReplay engines: envs reset with ``rng``, the first
    ``collect_drones`` = k drones' observations (k · obs_dim, E) f32,
    drone-major, a fresh agent drawn from ``rng`` as the JAX trainer draws
    it and an empty replay on the agent's device."""
    device = agent.device
    env_states = env_core.reset_batch(rng.to(device), env_params, num_envs)
    obs_t = _stacked_obs(env_states, env_params, collect_drones)
    bstate = buffer.init({
        "obs": torch.zeros((agent.obs_dim,), dtype=torch.float32),
        "actions": torch.zeros((), dtype=torch.int32),
        "rewards": torch.zeros((), dtype=torch.float32),
        "dones": torch.zeros((), dtype=torch.bool),
    }, device=device)
    return (rng.cpu(), fused_tick.to_tstate(env_states), obs_t,
            agent.init_state(rng), bstate, 0)


# --- the jnp engine ----------------------------------------------------------

def build_train_step(agent: DQN, buffer: replay.ReplayBuffer,
                     env_params: EnvParams, num_envs: int,
                     reset_env_every: int, collect_drones: int = 1):
    """The jnp-engine tick (``dronerl_tpu/train.py::build_train_step``):
    ``tick(carry) -> (carry, (rewards (E,), epsilon, loss))`` with the
    carry ``(rng, env_states, obs (E, k, obs_dim), ag_state, bstate,
    step)`` (:func:`init_jnp_carry`); ``k`` = ``collect_drones`` drones
    of every env feed the replay. ``loss`` is ``NO_TRAIN_LOSS`` until the
    buffer holds a batch."""
    obs_dim = agent.obs_dim
    device = agent.device
    k = collect_drones

    def learner_obs(states):
        return env_core.observe_batch(states, env_params, k).reshape(
            num_envs, k, obs_dim)

    def tick(carry):
        rng, env_states, obs, ag_state, bstate, step = carry
        rng, rand_key, act_key, step_key, sample_key, reset_key = (
            rng_mod.split(rng, 6))
        actions = rng_mod.randint(rand_key.to(device),
                                  (num_envs, env_params.n_drones), 0,
                                  NUM_ACTIONS)
        actions[:, 0] = agent.act(act_key, obs[:, 0], ag_state)
        step_keys = rng_mod.split(step_key.to(device), num_envs)
        env_states, rewards, dones = env_core.step_batch(
            step_keys, env_states, actions, env_params)
        next_obs = learner_obs(env_states)
        bstate = buffer.push_many(bstate, {
            "obs": obs.reshape(num_envs * k, obs_dim),
            "actions": actions[:, :k].reshape(-1),
            "rewards": rewards[:, :k].reshape(-1),
            "next_obs": next_obs.reshape(num_envs * k, obs_dim),
            "dones": dones[:, :k].reshape(-1),
        })
        if buffer.can_sample(bstate):
            batch = buffer.sample(sample_key, bstate)
            batch["dones"] = batch["dones"].to(torch.float32)
            ag_state, loss = agent.train_step(ag_state, batch)
        else:
            loss = torch.tensor(NO_TRAIN_LOSS, device=device)
        ag_state = agent.apply_schedules(ag_state, step, dones[0, 0])
        if step % reset_env_every == 0:
            env_states = env_core.reset_batch(reset_key.to(device),
                                              env_params, num_envs)
            next_obs = learner_obs(env_states)
        carry = (rng, env_states, next_obs, ag_state, bstate, step + 1)
        return carry, (rewards[:, 0], ag_state.epsilon, loss)

    return tick


def init_jnp_carry(agent: DQN, env_params: EnvParams, num_envs: int,
                   buffer: replay.ReplayBuffer, rng: torch.Tensor,
                   collect_drones: int = 1):
    """Initial carry ``(rng, env_states, obs, ag_state, bstate, 0)`` for
    :func:`build_train_step`, as the JAX CLI builds it: envs reset with
    ``rng``, the learner drones' observations (E, k, obs_dim), a fresh
    agent drawn from ``rng`` and an empty row-major replay of whole
    transitions on the agent's device."""
    device = agent.device
    env_states = env_core.reset_batch(rng.to(device), env_params, num_envs)
    obs = env_core.observe_batch(env_states, env_params,
                                 collect_drones).reshape(
        num_envs, collect_drones, agent.obs_dim)
    obs_leaf = torch.zeros((agent.obs_dim,), dtype=torch.float32)
    bstate = buffer.init({
        "obs": obs_leaf,
        "actions": torch.zeros((), dtype=torch.int32),
        "rewards": torch.zeros((), dtype=torch.float32),
        "next_obs": obs_leaf,
        "dones": torch.zeros((), dtype=torch.bool),
    }, device=device)
    return (rng.cpu(), env_states, obs,
            agent.init_state(rng), bstate, 0)


# --- engine choice -----------------------------------------------------------

def ring_skip_reasons(dense: bool, ring_capacity: int, push_size: int,
                      batch_size: int, collect_drones: int) -> list:
    """Why a configuration of the fused family falls off the ring engine:
    the JAX CLI's ``use_ring`` gate, one reason per failed condition."""
    reasons = []
    if not dense:
        reasons.append(
            "conv network without --conv_matmul (the im2col lowering lets "
            "conv nets run in-kernel)")
    if ring_capacity > 4 * push_size:
        reasons.append(
            f"replay ring of {ring_capacity} transitions > 4 env-batches "
            f"({4 * push_size}); shrink --memory_size or raise --num_envs "
            "to run the ring engine")
    if batch_size % collect_drones != 0:
        reasons.append(f"--batch_size {batch_size} not divisible by "
                       f"--collect_drones {collect_drones}")
    return reasons


def fused_engine_problems(env_params: EnvParams, num_envs: int) -> list:
    """Why the fused family (ring and full engines) does not run this
    configuration: the JAX CLI's ``fused_engine_problems`` with the card
    in the TPU's place, i.e. the kernels' limits
    (``fused_tick.kernel_problems``) and the JAX kernels' 128-lane env
    blocks, which the JAX CLI keeps as its gate."""
    problems = fused_tick.kernel_problems(env_params, num_envs)
    if num_envs < 128:
        problems.append(f"num_envs={num_envs} < 128 (small batches belong "
                        "on the jnp engine)")
    elif num_envs % 128 != 0:
        problems.append(f"num_envs={num_envs} is not a multiple of 128")
    return problems


def choose_engine(args, env_params: EnvParams,
                  agent_config: Optional[DQNConfig] = None) -> str:
    """``"jnp"``, ``"ring"``, ``"full"`` or ``"fused"``, by the JAX CLI's
    rule: the jnp engine for ``--engine jnp`` and, under ``auto``, wherever
    :func:`fused_engine_problems` finds a reason; else the ring engine
    when the ring holds at most 4 env-batches and the actor runs in the
    kernel (``ring_skip_reasons`` is empty), else over a StreamReplay the
    full engine where the actor runs in the kernel (a dense net, or a conv
    net with ``--conv_matmul``) and the fused engine where it does not.
    ``--engine fused`` on a configuration with problems raises, naming
    them. The net is ``agent_config``'s where given (a warm start's comes
    from its checkpoint), else the CLI's. Logs the choice and why the
    faster engines were skipped."""
    problems = fused_engine_problems(env_params, args.num_envs)
    if args.engine == "fused" and problems:
        raise ValueError("--engine fused is not available for this "
                         "config: " + "; ".join(problems))
    if args.engine == "jnp" or problems:
        logger.info("Engine: jnp")
        if problems:
            logger.info("Fused engines skipped (%s)", "; ".join(problems))
        return "jnp"
    push_size = args.num_envs * args.collect_drones
    capacity = math.ceil(args.memory_size / push_size) * push_size
    cfg = agent_config or args
    dense = cfg.network_type == "dense" or cfg.conv_matmul
    skip = ring_skip_reasons(dense, max(capacity, 2 * push_size), push_size,
                             args.batch_size, args.collect_drones)
    engine = "ring" if not skip else ("full" if dense else "fused")
    logger.info("Engine: %s", engine)
    if skip:
        logger.info("Ring engine skipped (%s)", "; ".join(skip))
    return engine


def rng_rounds_from_args(args):
    """``--fast_rng {off,actor,full}`` as the tick kernels' round counts
    ``(rng_rounds, actor_rng_rounds)``, as the JAX CLI maps it: ``off`` is
    (20, None), everything at ``jax.random``'s 20 rounds; ``actor`` (20,
    8), the actor's uniform field alone at 8 rounds, the env's
    transitions unchanged; ``full`` (8, None), every in-kernel hash at 8
    rounds, the transitions no longer the reference env's."""
    mode = getattr(args, "fast_rng", "off")
    if mode in (False, None, "off"):
        return 20, None
    if mode == "actor":
        return 20, 8
    return 8, None


def engine_rng_rounds(args, engine: str):
    """The round counts that ``engine`` runs for ``--fast_rng``, with the
    JAX CLI's two warnings: the jnp engine launches no tick kernel and
    runs 20 rounds; ``actor`` changes nothing on the fused engine, whose
    actor runs outside the kernel (its kernel takes ``rng_rounds``
    only)."""
    rng_rounds, actor_rng_rounds = rng_rounds_from_args(args)
    if (rng_rounds, actor_rng_rounds) != (20, None) and engine == "jnp":
        logger.warning("--fast_rng only affects the fused engines; the jnp "
                       "engine always uses 20-round threefry draws")
        return 20, None
    if actor_rng_rounds is not None and engine == "fused":
        logger.warning(
            "--fast_rng actor is a no-op on the fused engine: the actor "
            "runs outside the kernel; env uniforms stay at the parity 20 "
            "rounds")
    return rng_rounds, actor_rng_rounds


# --- CLI ---------------------------------------------------------------------

def env_params_from_args(args, eval_mode: bool = False) -> EnvParams:
    """The train arena, or with ``eval_mode`` the eval arena
    (``--eval_n_drones``, ``--eval_grid_size``), validated up front so an
    impossible eval arena fails before training: the global wrapper's
    observation is the whole board, so a trained net cannot evaluate on
    another grid size."""
    n_drones, grid_size = args.n_drones, args.grid_size
    if eval_mode:
        n_drones = args.eval_n_drones or n_drones
        grid_size = args.eval_grid_size or grid_size
        if args.wrapper == "global" and grid_size != args.grid_size:
            raise ValueError(
                f"--eval_grid_size {grid_size} != --grid_size "
                f"{args.grid_size} is impossible with --wrapper global: "
                "the full-grid observation's dimensionality is the grid, "
                "so the trained network cannot evaluate on another size")
    params = EnvParams(
        n_drones=n_drones,
        grid_size=grid_size,
        window_radius=args.window_radius,
        wrapper=args.wrapper,
        pickup_reward=args.pickup_reward,
        delivery_reward=args.delivery_reward,
        crash_reward=args.crash_reward,
        charge_reward=args.charge_reward,
        packets_factor=args.packets_factor,
        dropzones_factor=args.dropzones_factor,
        stations_factor=args.stations_factor,
        skyscrapers_factor=args.skyscrapers_factor,
    )
    if eval_mode:
        params.validate()
    return params


def agent_config_from_args(args) -> DQNConfig:
    if args.epsilon_decay is None:
        # ε reaches 50% of its range after the configured half-life
        # fraction of training (the JAX trainer's rule).
        eps_decay = (
            1 - 0.5 * (1 - args.epsilon_end / args.epsilon_start)
        ) ** (1 / (args.epsilon_decay_half_life_fraction * args.num_steps))
    else:
        eps_decay = args.epsilon_decay
    return DQNConfig(
        network_type=args.network_type,
        conv_matmul=args.conv_matmul,
        hidden_layers=tuple(args.hidden_layers),
        conv_layers=args.conv_layers,
        conv_dense_layers=tuple(args.conv_dense_layers),
        target_update_interval=args.target_update_interval,
        epsilon_start=args.epsilon_start,
        epsilon_decay=eps_decay,
        epsilon_end=args.epsilon_end,
        epsilon_decay_every=args.epsilon_decay_every,
        gamma=args.gamma,
        learning_rate=args.learning_rate,
        tau=args.tau,
    )


# --- evaluation ----------------------------------------------------------------

def _eval_tick_keys(keys: torch.Tensor):
    """Four independent streams per eval tick, split from each key (...,
    2): the carry, the opponents' random actions, the agent's act call and
    the env step."""
    split = rng_mod.split(keys, 4)
    return tuple(split[..., i, :] for i in range(4))


def evaluate(args, agent: DQN, ag_state):
    """Greedy drone 0 against random opponents over ``--num_evals`` seeds
    (``--eval_seed`` on), ``--num_eval_steps`` ticks each, every seed an
    env of one batch on the agent's device (the ticks one CUDA graph on
    the card, ``utils.graphs.scan``). Returns ``((mean, std), (random
    mean, random std))`` of the per-seed mean rewards of drone 0 and
    drone 1."""
    env_params = env_params_from_args(args, eval_mode=True)
    device = agent.device
    num_seeds = args.num_evals
    keys = seed_keys(args.eval_seed + np.arange(num_seeds)).to(device)
    state = env_core.reset_keys(keys, env_params)

    def tick(carry):
        keys, state = carry[0], EnvState(*carry[1:])
        keys, opp_key, act_key, step_key = _eval_tick_keys(keys)
        actions = rng_mod.randint(opp_key, (env_params.n_drones,), 0,
                                  NUM_ACTIONS)
        obs = env_core.observe_batch(state, env_params, 1).reshape(
            num_seeds, agent.obs_dim)
        actions[:, 0] = agent.act(act_key, obs, ag_state, greedy=True)
        state, rewards, _ = env_core.step_batch(step_key, state, actions,
                                                env_params)
        return (keys, *env_fields(state)), (rewards,)

    with torch.no_grad():
        _, (rewards,) = scan(tick, (keys, *env_fields(state)),
                             args.num_eval_steps)  # (steps, seeds, N)
    per_seed_agent = rewards[:, :, 0].mean(dim=0).tolist()
    per_seed_random = (rewards[:, :, 1].mean(dim=0).tolist()
                       if env_params.n_drones > 1 else [0.0] * num_seeds)
    spread = statistics.stdev if num_seeds > 1 else (lambda _: 0.0)
    return ((statistics.mean(per_seed_agent), spread(per_seed_agent)),
            (statistics.mean(per_seed_random), spread(per_seed_random)))


def log_chunk_histograms(metrics_logger, agent: DQN, carry, losses,
                         use_ring: bool, use_fused: bool, step: int,
                         probe: int = 1024) -> None:
    """Per-chunk q-value, TD-loss and replay-action histograms: the TD
    losses of the chunk's trained ticks, the online net's Q-values on a
    probe of replay observations and the replay's action column. On the
    ring engine only the slots written so far count (obs slot 0 is seeded
    before the first tick, each tick writes one env-batch of columns and
    its scalars at the read slot), and with ``collect_drones`` > 1 drone
    0's rows."""
    losses = torch.as_tensor(losses).reshape(-1)
    trained = losses[losses >= 0.0]
    if trained.numel():
        metrics_logger.log_histogram("td_loss", trained, step)
    ag_state = carry[-3]
    if use_ring:
        tstate, ring = carry[1]
        num_envs = tstate.ground.shape[1]  # feature-major: (cells, E)
        steps_done = int(carry[-1])
        if not steps_done:
            return
        valid_obs = min(ring.shape[1], (steps_done + 1) * num_envs)
        obs = ring[:agent.obs_dim, :min(probe, valid_obs)].t().float()
        actions = carry[2][0]
        if actions.dim() == 2:  # (k, capacity) scalar rings: drone 0's row
            actions = actions[0]
        actions = actions[:min(actions.shape[0], steps_done * num_envs)]
    else:
        bstate = carry[-2]
        if not bstate.size:
            return
        obs = bstate.storage["obs"]
        obs = (obs[:, :min(probe, bstate.size)].t() if use_fused
               else obs[:min(probe, bstate.size)])
        actions = bstate.storage["actions"][:bstate.size]
    with torch.no_grad():
        q = agent.q_values(ag_state.params, obs.float())
    metrics_logger.log_histogram("q_values", q, step)
    metrics_logger.log_histogram("replay_actions", actions, step)


# --- the trainer ---------------------------------------------------------------

def parse_conv_layers(value: str):
    """``--conv_layers``: a JSON (or Python literal) list of conv layer
    dicts, or one dict."""
    try:
        layers = json.loads(value)
    except json.JSONDecodeError:
        try:
            layers = ast.literal_eval(value)
        except (SyntaxError, ValueError):
            raise argparse.ArgumentTypeError(
                f"Invalid format for conv_layers: {value}")
    if isinstance(layers, dict):
        return (layers,)
    return tuple(layers)


# The JAX CLI's options the port refuses, and why.
_MULTI_GPU = "multi-GPU training waits for a later slice of the port"
REFUSED_FLAGS = {
    **dict.fromkeys(("--use_sharding", "--coordinator_address",
                     "--num_processes", "--process_id"), _MULTI_GPU),
    "--jax_cache_dir": "it has no counterpart: the port caches its nvcc "
    "builds under dronerl_tpu_torch/ops/_build/",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="DQN training (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # env
    p.add_argument("--n_drones", type=int, default=4)
    p.add_argument("--grid_size", type=int, default=9)
    p.add_argument("--window_radius", type=int, default=3)
    p.add_argument("--wrapper", choices=["window", "global"],
                   default="window")
    p.add_argument("--packets_factor", type=int, default=3)
    p.add_argument("--dropzones_factor", type=int, default=2)
    p.add_argument("--stations_factor", type=int, default=2)
    p.add_argument("--skyscrapers_factor", type=int, default=3)
    p.add_argument("--pickup_reward", type=float, default=0.0)
    p.add_argument("--delivery_reward", type=float, default=1.0)
    p.add_argument("--crash_reward", type=float, default=-1.0)
    p.add_argument("--charge_reward", type=float, default=-0.1)
    p.add_argument("--num_envs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    # training
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--memory_size", type=int, default=100_000)
    p.add_argument("--max_scan_steps", type=int, default=100_000,
                   help="ticks a chunk: per-chunk scalars and the eval "
                   "while training come between chunks, and a run takes "
                   "ceil(num_steps / max_scan_steps) whole chunks")
    p.add_argument("--network_type", choices=["dense", "conv"],
                   default="dense")
    p.add_argument("--hidden_layers", nargs="+", type=int, default=(16, 16))
    p.add_argument(
        "--conv_layers", type=parse_conv_layers,
        default='[{"kernel_size": 3, "out_channels": 8, "padding": 1, '
        '"stride": 1}]')
    p.add_argument("--conv_dense_layers", nargs="+", type=int, default=())
    p.add_argument("--conv_matmul", action="store_true",
                   help="compute conv layers as im2col weight matrices "
                   "(ops/conv2mat.py): the same parameters, float sums in "
                   "matmul order; lets the ring and full engines run a "
                   "conv net's actor in the tick kernel")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--epsilon_start", type=float, default=1.0)
    p.add_argument("--epsilon_decay", type=float, default=None)
    p.add_argument("--epsilon_decay_half_life_fraction", type=float,
                   default=0.2)
    p.add_argument("--epsilon_end", type=float, default=0.01)
    p.add_argument("--epsilon_decay_every", type=int, default=5)
    p.add_argument("--target_update_interval", type=int, default=10)
    p.add_argument("--reset_env_every", type=int, default=100)
    p.add_argument("--tau", type=float, default=1.0,
                   help="target update: 1.0 a hard copy, < 1 an EMA")
    p.add_argument("--collect_drones", type=int, default=1,
                   help="learn from the first k drones of every env")
    p.add_argument(
        "--fast_rng", nargs="?", const="full", default="off",
        choices=["off", "actor", "full"],
        help="the tick kernels' reduced-round Threefry-2x32-8: 'full' (also "
        "the bare flag) runs every in-kernel hash at 8 rounds, and the env "
        "transitions are no longer the reference's at a fixed seed; "
        "'actor' only the epsilon-greedy actor's uniforms, the env's stay "
        "at 20 rounds")
    p.add_argument("--ring_obs_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16", help="the ring engine's ring")
    p.add_argument("--engine", choices=["auto", "fused", "jnp"],
                   default="auto",
                   help="auto: the jnp engine where the fused kernels do "
                   "not apply (fewer than 128 envs, or not a multiple of "
                   "128), else, as with fused, the ring engine when the "
                   "replay holds at most 4 env-batches and the actor runs "
                   "in the kernel, and otherwise over a StreamReplay the "
                   "full engine, or for a conv net without --conv_matmul "
                   "the fused engine; jnp: plain PyTorch over a row-major "
                   "ReplayBuffer")
    p.add_argument("--in_kernel_td", action="store_true",
                   help="ring engine, dense nets: the TD(0) + Adam step as "
                   "one launch of the learner kernel after the tick "
                   "kernel's, on the batch gathered the tick before")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    # checkpoints, state, diagnostics
    p.add_argument("--save_final_checkpoint", action="store_true",
                   help="write the online net as agent_<steps>_steps_jax"
                   ".safetensors and _torch.safetensors in the run dir")
    p.add_argument(
        "--load_from_checkpoint", type=str, default=None,
        help="warm-start the online and target nets from a safetensors "
        "checkpoint (either format); the topology comes from its metadata")
    p.add_argument("--save_train_state", action="store_true",
                   help="write the whole carry (nets, Adam, epsilon, "
                   "replay, envs, key, step) to train_state.safetensors in "
                   "the run dir")
    p.add_argument("--resume_from", type=str, default=None,
                   help="a train state of this port to resume from")
    p.add_argument(
        "--tensorboard_dir", type=str, default=None,
        help="write per-chunk training curves (reward/ε/TD loss) and "
        "eval points to TensorBoard under this directory")
    p.add_argument(
        "--log_histograms", action=argparse.BooleanOptionalAction,
        default=True,
        help="with an active metrics sink, also log per-chunk q-value / "
        "TD-loss / replay-action histograms")
    p.add_argument("--run_dir", type=str, default=None)
    p.add_argument("--profile", action="store_true",
                   help="after one untimed chunk, trace the run with "
                   "torch.profiler into <run_dir>/profile/trace.json")
    p.add_argument("--inspect_memory", action="store_true",
                   help="dump replay-buffer diagnostics (action/reward/done "
                   "distributions, top states) after training")
    # eval
    p.add_argument("--eval_n_drones", type=int, default=None)
    p.add_argument("--eval_grid_size", type=int, default=None)
    p.add_argument("--eval_seed", type=int, default=0)
    p.add_argument("--num_eval_steps", type=int, default=10_000)
    p.add_argument("--num_evals", type=int, default=5)
    p.add_argument("--eval_while_training", action="store_true")
    p.add_argument("--skip_final_eval", action="store_true")
    # video
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--render_video_steps", type=int, default=200)
    # W&B
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="dronerl-tpu")
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    args, unknown = p.parse_known_args(argv)
    refused = [f"{flag}: {why}" for flag, why in REFUSED_FLAGS.items()
               if any(u.split("=")[0] == flag for u in unknown)]
    if refused:
        raise SystemExit("not supported by the PyTorch port: "
                         + "; ".join(refused))
    if unknown:
        raise SystemExit(
            "not supported by the PyTorch port yet: " + " ".join(unknown))
    if isinstance(args.conv_layers, str):
        args.conv_layers = parse_conv_layers(args.conv_layers)
    if args.num_envs <= 0:
        raise ValueError("num_envs must be >= 1")
    if args.num_steps <= 0:
        raise ValueError("num_steps must be >= 1")
    if args.collect_drones < 1 or args.collect_drones > args.n_drones:
        raise ValueError("collect_drones must be in [1, n_drones]")
    return args


def _warm_start(args, agent_config: DQNConfig):
    """``--load_from_checkpoint``: (the agent config with the
    checkpoint's topology, its flax params), or (config, None)."""
    if not args.load_from_checkpoint:
        return agent_config, None
    ckpt_config, params = safetensors_io.load_checkpoint(
        args.load_from_checkpoint)
    agent_config = dataclasses.replace(
        agent_config, network_type=ckpt_config.network_type,
        hidden_layers=ckpt_config.hidden_layers,
        conv_layers=ckpt_config.conv_layers,
        conv_dense_layers=ckpt_config.conv_dense_layers)
    logger.info("Warm start from %s (%s network)", args.load_from_checkpoint,
                ckpt_config.network_type)
    return agent_config, params


def _build_engine(args, agent: DQN, env_params: EnvParams, engine: str,
                  rng_rounds: int, actor_rng_rounds: Optional[int]):
    """The engine's tick and its initial carry from ``--seed``."""
    num_envs, k = args.num_envs, args.collect_drones
    device = agent.device
    # The replay rounded up to whole pushes of E · k transitions.
    push_size = num_envs * k
    capacity = math.ceil(args.memory_size / push_size) * push_size
    ring_capacity = max(capacity, 2 * push_size)
    rng = rng_mod.PRNGKey(args.seed)
    if args.in_kernel_td and engine != "ring":
        raise ValueError(f"--in_kernel_td runs on the ring engine only; this "
                         f"configuration runs the {engine} engine")
    if engine == "jnp":
        logger.info("env %s | agent %s | %d envs, ReplayBuffer of %d slots "
                    "(float32) on %s", env_params, agent.config, num_envs,
                    capacity, device)
        buffer = replay.ReplayBuffer(capacity, args.batch_size,
                                     uniform_pushes=True)
        tick = build_train_step(agent, buffer, env_params, num_envs,
                                args.reset_env_every, k)
        return tick, init_jnp_carry(agent, env_params, num_envs, buffer, rng,
                                    k)
    if engine == "ring":
        ring_columns = ring_capacity // k  # k transitions a column
        logger.info("env %s | agent %s | %d envs, ring %d columns (%s)%s on "
                    "%s", env_params, agent.config, num_envs, ring_columns,
                    args.ring_obs_dtype,
                    ", in-kernel TD" if args.in_kernel_td else "", device)
        tick = build_train_step_ring(
            agent, env_params, num_envs, ring_columns, args.batch_size,
            args.reset_env_every, k, in_kernel_td=args.in_kernel_td,
            rng_rounds=rng_rounds, actor_rng_rounds=actor_rng_rounds)
        return tick, init_ring_carry(
            agent, env_params, num_envs, ring_columns, rng,
            obs_dtype=getattr(torch, args.ring_obs_dtype),
            batch_size=args.batch_size, in_kernel_td=args.in_kernel_td,
            collect_drones=k)
    logger.info("env %s | agent %s | %d envs, StreamReplay of %d slots "
                "(float32) on %s", env_params, agent.config, num_envs,
                ring_capacity, device)
    buffer = replay.StreamReplay(ring_capacity, args.batch_size,
                                 stride=push_size)
    if engine == "full":
        tick = build_train_step_full(
            agent, buffer, env_params, num_envs, args.reset_env_every, k,
            rng_rounds, actor_rng_rounds)
    else:
        tick = build_train_step_fused(
            agent, buffer, env_params, num_envs, args.reset_env_every, k,
            rng_rounds)
    return tick, init_stream_carry(agent, env_params, num_envs, buffer, rng,
                                   k)


def train(args, metrics_logger=None) -> dict:
    """The JAX CLI's run: the engine of :func:`choose_engine`; the warm
    start (``--load_from_checkpoint``: the loaded net in the online and
    target nets, a fresh Adam and ε), then ``--resume_from`` (which
    overrides it), both before the kernels are built; ``ceil(num_steps /
    max_scan_steps)`` chunks of ``max_scan_steps`` ticks (with
    ``--profile`` one more, untimed, before the trace), an eval before
    every chunk but the first with ``--eval_while_training``, per-chunk
    scalars and histograms into ``metrics_logger``; then
    ``--inspect_memory``, ``--save_final_checkpoint``,
    ``--save_train_state``, the final eval unless ``--skip_final_eval``,
    ``--render_video`` and ``metrics.json`` in the run dir."""
    device = resolve_device(args.device)
    env_params = env_params_from_args(args)
    env_params.validate()
    if args.eval_while_training or not args.skip_final_eval:
        env_params_from_args(args, eval_mode=True)
    agent_config, warm_params = _warm_start(args, agent_config_from_args(args))

    run = None
    if args.wandb:
        import wandb

        run = wandb.init(project=args.wandb_project, group=args.wandb_group,
                         entity=args.wandb_entity, config=vars(args))
    if metrics_logger is None:
        metrics_logger = build_logger(tensorboard_dir=args.tensorboard_dir,
                                      wandb_run=run)
    log_metrics = not isinstance(metrics_logger, NoLogger)
    run_dir = args.run_dir or os.path.join(
        "output", f"run_{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    os.makedirs(run_dir, exist_ok=True)
    logger.info("Run dir: %s", run_dir)

    agent = DQN(agent_config, env_params, device=device)
    engine = choose_engine(args, env_params, agent_config)
    rng_rounds, actor_rng_rounds = engine_rng_rounds(args, engine)
    tick, carry = _build_engine(args, agent, env_params, engine, rng_rounds,
                                actor_rng_rounds)
    if warm_params is not None:
        agent.state_with_params(carry[3], qnet_from_flax(
            warm_params, device, env_params.obs_shape,
            agent_config.conv_specs()))
    if args.resume_from:
        carry = train_state_io.restore(args.resume_from, carry)
        logger.info("Resumed training state from %s (step %s)",
                    args.resume_from, carry[-1])
    if device.type == "cuda" and engine != "jnp":
        t0 = time.perf_counter()
        fused_tick.prepare_kernel(
            env_params, None if engine == "fused" else
            fused_tick.flatten_net_params(carry[3].params, agent.net_spec),
            in_kernel_td=args.in_kernel_td, env_tick=engine == "fused",
            collect=args.collect_drones, rng_rounds=rng_rounds,
            actor_rng_rounds=None if engine == "fused" else actor_rng_rounds)
        logger.info("kernel ready in %.1fs", time.perf_counter() - t0)
        torch.cuda.synchronize(device)

    scan_steps = min(args.num_steps, args.max_scan_steps)
    num_chunks = math.ceil(args.num_steps / scan_steps)

    def run_chunk(carry):
        rewards, losses = [], []
        for _ in range(scan_steps):
            carry, (reward, epsilon, loss) = tick(carry)
            losses.append(loss)
            if log_metrics or not rewards:
                rewards.append(reward)
            else:
                rewards[0] = reward
        return carry, (rewards, epsilon, losses)

    profile_dir = os.path.join(run_dir, "profile")
    if args.profile:
        carry, _ = run_chunk(carry)  # warm-up outside the trace
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    all_losses = []
    with (profiling.trace(profile_dir) if args.profile
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        for chunk in range(num_chunks):
            if args.eval_while_training and chunk > 0:
                step = chunk * scan_steps
                (emean, estd), (rmean, rstd) = evaluate(args, agent,
                                                        carry[3])
                logger.info("eval @ step %s: agent %.3f ± %.3f | random "
                            "%.3f ± %.3f", f"{step:,}", emean, estd, rmean,
                            rstd)
                metrics_logger.log_scalars(
                    {"eval_reward": emean, "random_reward": rmean},
                    step=step)
            carry, (rewards, epsilon, losses) = run_chunk(carry)
            all_losses += losses
            if log_metrics:
                _log_chunk(metrics_logger, args, agent, carry, engine,
                           rewards, epsilon, losses, chunk,
                           (chunk + 1) * scan_steps)
        mean_reward = float(rewards[-1].mean())  # host sync: the loop is done
        elapsed = time.perf_counter() - t0
    if args.profile:
        logger.info("Profiler trace written under %s", profile_dir)

    total_steps = num_chunks * scan_steps
    losses = torch.stack(all_losses).cpu()
    trained = losses[losses >= 0]
    metrics = {"obs_per_sec": args.num_envs * total_steps / elapsed,
               "time_taken": elapsed}
    logger.info("Trained %s steps × %s envs in %.2fs → %s obs/s on %s "
                "(%s engine)", f"{total_steps:,}", f"{args.num_envs:,}",
                elapsed, f"{metrics['obs_per_sec']:,.0f}",
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu", engine)

    ag_state = carry[3]
    if args.inspect_memory:
        if engine == "ring":
            logger.warning("--inspect_memory: the ring engine keeps no "
                           "ReplayState (observations live in the kernel's "
                           "ring); use --engine jnp or a larger "
                           "--memory_size")
        else:
            replay.inspect_memory(carry[4], printer=logger.info,
                                  slot_axis=0 if engine == "jnp" else -1)
    if args.save_final_checkpoint:
        jax_path = os.path.join(
            run_dir, f"agent_{args.num_steps}_steps_jax.safetensors")
        torch_path = os.path.join(
            run_dir, f"agent_{args.num_steps}_steps_torch.safetensors")
        agent.save(jax_path, ag_state)
        agent.save_as_torch(torch_path, ag_state)
        logger.info("Saved checkpoints: %s, %s", jax_path, torch_path)
        if run:
            import wandb

            artifact = wandb.Artifact(
                name=f"checkpoint_{args.num_steps}_steps", type="model")
            artifact.add_file(local_path=jax_path)
            artifact.add_file(local_path=torch_path)
            run.log_artifact(artifact)
    if args.save_train_state:
        state_path = os.path.join(run_dir, TRAIN_STATE_FILE)
        train_state_io.save(state_path, carry)
        logger.info("Saved full training state to %s", state_path)
    if not args.skip_final_eval:
        (emean, estd), (rmean, rstd) = evaluate(args, agent, ag_state)
        metrics["eval_reward_mean"] = emean
        metrics["eval_reward_std"] = estd
        logger.info("Final eval: agent %.3f ± %.3f | random %.3f ± %.3f",
                    emean, estd, rmean, rstd)
        metrics_logger.log_scalars(
            {"eval_reward": emean, "random_reward": rmean},
            step=args.num_steps)
    if args.render_video:
        from dronerl_tpu_torch.render.video import render_policy_video

        video_path = os.path.join(
            run_dir, f"training_{args.num_steps}_steps.mp4")
        video_path = render_policy_video(
            env_params, agent, ag_state, video_path,
            num_steps=args.render_video_steps)
        logger.info("Rendered video: %s", video_path)
        if run:
            import wandb

            run.log({"eval_video": wandb.Video(video_path, format="mp4")},
                    step=args.num_steps)

    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    metrics_logger.close()
    if run:
        run.finish()
    return {**metrics, "engine": engine,
            "last_reward_mean": mean_reward, "epsilon": float(epsilon),
            "td_loss_mean": float(trained.mean()) if len(trained) else None,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def _log_chunk(metrics_logger, args, agent: DQN, carry, engine: str,
               rewards, epsilon, losses, chunk: int, step: int) -> None:
    """A chunk's scalars (the mean reward of drone 0, the last ε, the mean
    TD loss over the trained ticks: warm-up ticks carry NO_TRAIN_LOSS,
    which is negative, and a NaN loss is kept and warned about) and,
    with ``--log_histograms``, its histograms."""
    flat = torch.stack(losses).reshape(-1).cpu()
    trained = ~(flat < 0.0)
    n_trained = int(trained.sum())
    scalars = {"train_reward": float(torch.stack(rewards).mean()),
               "epsilon": float(epsilon)}
    if n_trained:
        scalars["td_loss"] = float(
            torch.where(trained, flat, 0.0).sum() / n_trained)
        if not math.isfinite(scalars["td_loss"]):
            logger.warning("non-finite TD loss in chunk %d (training has "
                           "diverged?)", chunk)
    metrics_logger.log_scalars(scalars, step=step)
    if args.log_histograms:
        log_chunk_histograms(metrics_logger, agent, carry, flat,
                             engine == "ring", engine in ("full", "fused"),
                             step=step)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)-5.5s] [%(name)-12.12s]: %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
