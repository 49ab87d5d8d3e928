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

The CLI chooses an engine as the JAX CLI does (:func:`choose_engine`).

The step counter, the ring slot arithmetic, the reset flag, the count of
valid columns, the replay's cursor and size and the rng chain stay on the
host: they are a few scalar hashes a tick, and reading them back from the
device every tick would serialise the loop. The key words reach the
kernels as launch arguments.

Run:  python -m dronerl_tpu_torch.train --num_envs 65536 --num_steps 300
"""

import argparse
import ast
import functools
import json
import logging
import math
import sys
import time
from typing import Optional

import torch

from dronerl_tpu_torch import replay, resolve_device, rng as rng_mod
from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DQN, DQNConfig)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import fused_tick

logger = logging.getLogger("dronerl_tpu_torch.train")


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


def choose_engine(args, env_params: EnvParams) -> str:
    """``"jnp"``, ``"ring"``, ``"full"`` or ``"fused"``, by the JAX CLI's
    rule: the jnp engine for ``--engine jnp`` and, under ``auto``, wherever
    :func:`fused_engine_problems` finds a reason; else the ring engine
    when the ring holds at most 4 env-batches and the actor runs in the
    kernel (``ring_skip_reasons`` is empty), else over a StreamReplay the
    full engine where the actor runs in the kernel (a dense net, or a conv
    net with ``--conv_matmul``) and the fused engine where it does not.
    ``--engine fused`` on a configuration with problems raises, naming
    them. Logs the choice and why the faster engines were skipped."""
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
    dense = args.network_type == "dense" or args.conv_matmul
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

def env_params_from_args(args) -> EnvParams:
    return EnvParams(
        n_drones=args.n_drones,
        grid_size=args.grid_size,
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
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel) or cpu (the plain PyTorch path)")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        raise SystemExit(
            "not supported by the PyTorch port yet: " + " ".join(unknown))
    if args.num_envs <= 0:
        raise ValueError("num_envs must be >= 1")
    if args.num_steps <= 0:
        raise ValueError("num_steps must be >= 1")
    if args.collect_drones < 1 or args.collect_drones > args.n_drones:
        raise ValueError("collect_drones must be in [1, n_drones]")
    return args


def train(args) -> dict:
    device = resolve_device(args.device)
    env_params = env_params_from_args(args)
    env_params.validate()
    agent = DQN(agent_config_from_args(args), env_params, device=device)
    num_envs, k = args.num_envs, args.collect_drones
    # The replay rounded up to whole pushes of E · k transitions.
    push_size = num_envs * k
    capacity = math.ceil(args.memory_size / push_size) * push_size
    ring_capacity = max(capacity, 2 * push_size)
    engine = choose_engine(args, env_params)
    rng_rounds, actor_rng_rounds = engine_rng_rounds(args, engine)
    rng = rng_mod.PRNGKey(args.seed)
    if engine == "jnp":
        logger.info("env %s | agent %s | %d envs, ReplayBuffer of %d slots "
                    "(float32) on %s", env_params, agent.config, num_envs,
                    capacity, device)
        buffer = replay.ReplayBuffer(capacity, args.batch_size,
                                     uniform_pushes=True)
        tick = build_train_step(agent, buffer, env_params, num_envs,
                                args.reset_env_every, k)
        carry = init_jnp_carry(agent, env_params, num_envs, buffer, rng, k)
    elif engine == "ring":
        ring_columns = ring_capacity // k  # k transitions a column
        logger.info("env %s | agent %s | %d envs, ring %d columns (%s) on %s",
                    env_params, agent.config, num_envs, ring_columns,
                    args.ring_obs_dtype, device)
        tick = build_train_step_ring(
            agent, env_params, num_envs, ring_columns, args.batch_size,
            args.reset_env_every, k, rng_rounds=rng_rounds,
            actor_rng_rounds=actor_rng_rounds)
        carry = init_ring_carry(agent, env_params, num_envs, ring_columns,
                                rng, obs_dtype=getattr(
                                    torch, args.ring_obs_dtype),
                                collect_drones=k)
    else:
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
            actor_rng_rounds = None  # the kernel has no actor
        carry = init_stream_carry(agent, env_params, num_envs, buffer, rng,
                                  k)
    if device.type == "cuda" and engine != "jnp":
        t0 = time.perf_counter()
        fused_tick.prepare_kernel(
            env_params, None if engine == "fused" else
            fused_tick.flatten_net_params(carry[3].params, agent.net_spec),
            env_tick=engine == "fused", collect=k, rng_rounds=rng_rounds,
            actor_rng_rounds=actor_rng_rounds)
        logger.info("kernel ready in %.1fs", time.perf_counter() - t0)
        torch.cuda.synchronize(device)

    losses = []
    t0 = time.perf_counter()
    for _ in range(args.num_steps):
        carry, (rewards, epsilon, loss) = tick(carry)
        losses.append(loss)
    mean_reward = float(rewards.mean())  # host sync: the loop is done
    elapsed = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    trained = losses[losses >= 0]
    metrics = {
        "engine": engine,
        "obs_per_sec": num_envs * args.num_steps / elapsed,
        "time_taken": elapsed,
        "last_reward_mean": mean_reward,
        "epsilon": float(epsilon),
        "td_loss_mean": float(trained.mean()) if len(trained) else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    logger.info("Trained %s steps × %s envs in %.2fs → %s obs/s on %s "
                "(%s engine)", f"{args.num_steps:,}", f"{num_envs:,}",
                elapsed, f"{metrics['obs_per_sec']:,.0f}", metrics["device"],
                engine)
    return metrics


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)-5.5s] [%(name)-12.12s]: %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
