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
in-kernel TD path pipelines it; by default the step trains on the batch
gathered in the same tick, as in the JAX trainer.

The default TD step (every engine's, on the tick's own batch) is chosen
once, when the tick is built (:func:`learner_route`, recorded in
``Tick.learner``): on a CUDA card one launch of the learner kernel
(:func:`kernel_train_step`, ``learner_kernel.td_adam`` with learn on and
no sync or decay), the counterpart of the learner that XLA fuses around
the JAX trainer's Pallas calls. It stays on the autograd learner
(``DQN.train_step_t``, the jnp engine's ``train_step``: optax's formulas,
and the plain version the kernel is held to) on the CPU; on a tick that
averages its gradients over a process group (the sharded trainers), whose
all-reduce sits between the backward pass and Adam; for conv nets and
``conv_matmul`` chains; and where ``learner_kernel.kernel_problems``
refuses the net or the batch (a batch above 256, widths whose slices do
not fit a CTA's shared memory). A kernel that fails to build or launch
raises: nothing gives way to autograd at run time.

Full engine (:func:`build_train_step_full`). One tick: split the host
key three ways; one launch of the full tick kernel (B3: the actor on the
carried observation, the env side, the periodic reset, the push of the
tick's input observation and drone 0's action, reward and done into a
``replay.StreamReplay`` at the row's start slot, and the next observation
written over the carried one, in place); sample and take the TD(0) Adam
step once the replay can be sampled; the schedules.

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

jnp engine (:func:`build_train_step`). One tick: split the host key six
ways; random opponents and drone 0's ε-greedy action (``DQN.act``); the
env step and the learner drones' observation; push the whole transitions
(``next_obs`` included) into a row-major ``replay.ReplayBuffer``; sample
and take the TD(0) Adam step once the buffer holds a batch; the
schedules; the periodic reset (``core.reset_batch`` and
``observe_batch``: neither package has a reset kernel for this layout).
The JAX CLI runs it where its fused kernels do not apply (fewer than 128
envs, among others), and so does this one. The step and observation,
which XLA fuses in the JAX package, are chosen once when the tick is
built (:func:`step_route`, recorded in ``Tick.env_step``): on a CUDA card
within the observation's limits one launch of the step kernel
(``step_kernel.step_batch_fused`` with ``collect``, B5), else
``core.step_batch`` and ``observe_batch`` in plain PyTorch. The replay
sample is one launch of the sample kernel on a card
(``ReplayBuffer.sample_batch``), which writes the batch feature-major for
the learner kernel where that is the TD step's route.

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
CLI but ``--jax_cache_dir`` (``REFUSED_FLAGS``). With ``--use_sharding``
each process is one rank of a process group and runs its shard of the
sharded engine (:func:`sharded_engine`, ``parallel.DistributedTrainer``:
the single-card tick with the JAX sharded trainers' key chain and one
gradient all-reduce a trained tick) as a :class:`Chunk` too.

The step counter, the ring slot arithmetic, the reset flag, the count of
valid columns, the replay's cursor and size and the rng chain stay on the
host: they are a few scalar hashes a tick, and reading them back from the
device every tick would serialise the loop. Each engine's chunk
(:class:`Chunk`, the CLI's) walks them for the whole chunk at
its entry: the key words, the Adam count, the learner's bias corrections
and the replay's words (the push's start slot, the sample's bound and
base) go to the device as one table, and on the card each tick is one
replay of the CUDA graph of its static signature (the ring's slot and
valid columns, the reset, the schedules, whether it trains; never the
replay's cursor or size), which reads its words from device memory. A
sharded rank's graphs hold its gradient all-reduce over NCCL; over gloo
(and on the CPU) the rows run eagerly.

Run:  python -m dronerl_tpu_torch.train --num_envs 65536 --num_steps 300
"""

import argparse
import ast
import collections
import contextlib
import copy
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
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from dronerl_tpu_torch import replay, resolve_device, rng as rng_mod
from dronerl_tpu_torch.agents import dqn as dqn_module
from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DQN, DQNConfig, adam_bias_corrections)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams, EnvState, env_fields
from dronerl_tpu_torch.evaluator.evaluator import seed_keys
from dronerl_tpu_torch.interop import safetensors_io, train_state_io
from dronerl_tpu_torch.interop.from_jax import qnet_from_flax
from dronerl_tpu_torch.ops import (
    _build, draws, fused_tick, learner_kernel, step_kernel)
from dronerl_tpu_torch.utils import profiling
from dronerl_tpu_torch.utils.graphs import GraphSet, scan, upload
from dronerl_tpu_torch.utils.metrics import NoLogger, build_logger

logger = logging.getLogger("dronerl_tpu_torch.train")

TRAIN_STATE_FILE = "train_state.safetensors"
TRAIN_STATE_RANK_FILE = "train_state.rank{rank}.safetensors"


def host_keys(num: int):
    """The single-card trainers' per-tick keys: ``rng, k_1 .. k_num =
    split(rng, num + 1)``, as ``keys(rng, step) -> (rng', (num, 2) keys)``.
    A tick builder's ``keys`` takes any such function (the sharded
    trainers' is ``parallel.distributed.shard_keys``) and its ``group``
    the process group its learner averages its gradients over (None: no
    all-reduce)."""

    def keys(rng, step):
        split = rng_mod.split(rng, num + 1)
        return split[0], split[1:]

    def table(rng, length: int, step: int = 0):
        """``length`` ticks' keys at once: ``(rng', (length, num, 2)
        uint32)``, the chain's key (counter 0) hashed tick by tick on
        Python ints, the ticks' keys (counters 1..num) for every tick at
        once on numpy words. ``step``, the first tick's, is not hashed
        here (the sharded chain's ``table`` folds it in)."""
        end, chain = rng_mod.chain_words(rng, length, 0)
        out = np.empty((length, num, 2), dtype=np.uint32)
        for i in range(num):
            out[:, i, 0], out[:, i, 1] = rng_mod.threefry_words(
                chain[:, 0], chain[:, 1], 0, i + 1)
        return end, out

    keys.table = table
    return keys


class HostChain(NamedTuple):
    """The host values that a tick walks and its carry keeps: the rng key,
    the step, the Adam count and, over a replay, its cursor and size."""

    rng: torch.Tensor
    step: int
    count: int
    cursor: Optional[int] = None
    size: Optional[int] = None


def _host_chain(carry) -> HostChain:
    """The carry's host values (its replay's where ``carry[4]`` is one)."""
    bstate = carry[4]
    ints = ((bstate.cursor, bstate.size)
            if isinstance(bstate, replay.ReplayState) else ())
    return HostChain(carry[0], carry[-1], carry[3].opt_state.count, *ints)


def _settle(carry, chain: HostChain):
    """``carry`` with its host values set from ``chain``: rng, step, the
    Adam count and the replay's cursor and size."""
    carry[3].opt_state.count = chain.count
    aux = carry[4]
    if chain.cursor is not None:
        aux = replay.ReplayState(aux.storage, chain.cursor, chain.size)
    return (chain.rng, *carry[1:4], aux, chain.step)


class RowLayout:
    """A tick's per-tick words, int32 columns of one row: each of its
    ``num_keys`` keys' two uint32 words, the Adam count before the step,
    the bias corrections of the autograd learner's step (f32 bits), the
    tick's index in its chunk and, over a replay (``push``), the push's
    start slot, the sample's upper bound and its base slot
    (``replay.PushWords``)."""

    def __init__(self, num_keys: int, push: bool = False):
        n = 2 * num_keys
        self.num_keys = num_keys
        self.count, self.corrections, self.tick = n, slice(n + 1, n + 3), n + 3
        self.start, self.bound, self.base = n + 4, n + 5, n + 6
        self.words = n + (7 if push else 4)

    def make(self, keys, count: int, tick: int, push=None) -> np.ndarray:
        """One tick's row from its host keys ((num_keys, 2) words, a host
        tensor or an array), the Adam count before it and its push's
        words."""
        row = np.zeros(self.words, dtype=np.uint32)
        row[:2 * self.num_keys] = np.asarray(keys).reshape(-1).astype(
            np.int64) & rng_mod.MASK32
        row[self.count] = learner_kernel.check_count(count)
        row[self.corrections] = np.array(adam_bias_corrections(count + 1),
                                         dtype=np.float32).view(np.uint32)
        row[self.tick] = tick
        if push is not None:
            row[self.start], row[self.bound], row[self.base] = push[:3]
        return row.view(np.int32)

    def keys(self, row: torch.Tensor):
        """The row's keys as int64 (2,) tensors on the row's device."""
        words = row[:2 * self.num_keys].to(torch.int64) & rng_mod.MASK32
        return words.view(self.num_keys, 2).unbind(0)

    def bias_corrections(self, row: torch.Tensor) -> torch.Tensor:
        """The autograd learner's bias corrections, (2,) f32 on the row's
        device (``DQN.train_step_t``'s ``corrections``)."""
        return row[self.corrections].view(torch.float32)

    def key_words(self, row: torch.Tensor, index: int) -> torch.Tensor:
        """Key ``index``'s two words as the row's int32 (2,) view, which a
        kernel reads by pointer (``fused_tick.key_words`` takes it as
        it is)."""
        return row[2 * index:2 * index + 2]

    def host_key(self, host: np.ndarray, index: int) -> torch.Tensor:
        """Key ``index`` of ``host``, a row on the host, as an int64 (2,)
        host tensor."""
        words = host[2 * index:2 * index + 2].view(np.uint32)
        return torch.from_numpy(words.astype(np.int64))

    def replay_words(self, row: torch.Tensor, key: torch.Tensor,
                     host: Optional[np.ndarray], index: int):
        """The push's start slot and the replay sample's key, upper bound
        and base slot: the row's words as 0-d tensors and ``key`` (the
        row's key ``index``), on the row's device; or, given ``host`` (the
        row on the host), its words as ints and its key ``index``, which
        push with slices and draw on the host in far fewer launches (an
        eager tick's)."""
        if host is None:
            return row[self.start], key, row[self.bound], row[self.base]
        return (int(host[self.start]), self.host_key(host, index),
                int(host[self.bound]), int(host[self.base]))


KERNEL, IN_KERNEL_TD, AUTOGRAD, PLAIN = (
    "kernel", "in_kernel_td", "autograd", "plain")


def learner_problems(agent: DQN, batch_size: int, group=None,
                     device=None) -> list:
    """Why the learner kernel does not take a tick's default TD step on
    ``device`` (the agent's by default): empty where it does. It takes a
    dense net with no ``net_spec`` (the JAX trainer's ``td_ok``) on a
    CUDA card, with no process ``group`` (the gradient all-reduce sits
    between the backward pass and Adam), at a batch and widths that
    ``learner_kernel.kernel_problems`` accepts."""
    device = agent.device if device is None else torch.device(device)
    problems = []
    if device.type != "cuda":
        problems.append(f"a {device.type} device (the kernel runs on a "
                        "CUDA card)")
    if group is not None:
        problems.append("a process group (the gradient all-reduce sits "
                        "between the backward pass and Adam)")
    cfg = agent.config
    if cfg.network_type != "dense" or agent.net_spec is not None:
        problems.append(f"a {cfg.network_type} network (the kernel takes "
                        "dense nets)")
    else:
        problems += learner_kernel.kernel_problems(
            (agent.obs_dim, *cfg.hidden_layers, NUM_ACTIONS), batch_size)
    return problems


def learner_route(agent: DQN, batch_size: int, group=None) -> str:
    """The default TD step's route, chosen once when a tick is built:
    ``KERNEL``, or ``AUTOGRAD`` followed by :func:`learner_problems`'
    reasons."""
    problems = learner_problems(agent, batch_size, group)
    return KERNEL if not problems else (
        f"{AUTOGRAD} ({'; '.join(problems)})")


def step_problems(env_params: EnvParams, num_envs: int,
                  collect_drones: int = 1, device="cuda") -> list:
    """Why the jnp engine's tick does not step its envs and observe its
    learner drones with one launch of the step kernel (B5 with its
    observation) on ``device``: empty where it does. It takes a CUDA card,
    a board within the observation's limits (the tick kernels' 256 cells
    and 32 drones, ``collect_drones`` in [1, n_drones]) and the step's
    (``num_packets >= n_drones``), at any env count from 1 (the JAX
    gate's 8 envs, ``step_kernel.MIN_ENVS``, is its Pallas kernel's)."""
    device = torch.device(device)
    problems = []
    if device.type != "cuda":
        problems.append(f"a {device.type} device (the kernel runs on a "
                        "CUDA card)")
    problems += step_kernel.board_problems(env_params)
    problems += step_kernel.observation_problems(env_params, collect_drones)
    if num_envs < 1:
        problems.append(f"num_envs={num_envs} < 1")
    return problems


def step_route(env_params: EnvParams, num_envs: int,
               collect_drones: int = 1, device="cuda") -> str:
    """The jnp engine's env step and observation, chosen once when its
    tick is built: ``KERNEL``, or ``PLAIN`` followed by
    :func:`step_problems`' reasons."""
    problems = step_problems(env_params, num_envs, collect_drones, device)
    return KERNEL if not problems else f"{PLAIN} ({'; '.join(problems)})"


def kernel_train_step(agent: DQN, state, batch, count):
    """The default TD(0) + Adam step as one launch of the learner kernel
    (``learner_kernel.td_adam``: learn on, no target sync, no ε decay, the
    config's γ and learning rate) on a feature-major batch, in place;
    ``count``, the Adam count before the step, a host int or a row's int32
    word (a CUDA graph's launch reads it by pointer). Increments the host
    count and returns ``(state, loss)`` as ``DQN.train_step_t``, the loss
    a device tensor the kernel writes."""
    adam = state.opt_state
    loss = learner_kernel.td_adam(
        batch, state.params, state.target_params, adam.mu, adam.nu, count,
        learn=True, sync_target=False, decay_eps=False, epsilon=None,
        gamma=float(agent.config.gamma),
        lr=float(agent.config.learning_rate))
    adam.count += 1
    return state, loss


def learner_step(agent: DQN, route: str, ag_state, batch,
                 row: torch.Tensor, layout: RowLayout, group=None,
                 row_major: bool = False):
    """A tick's default TD step on its own batch, by ``route``: the
    learner kernel (:func:`kernel_train_step` on a feature-major batch,
    the count from the row), else the autograd learner (``train_step`` on
    a ``row_major`` batch, ``train_step_t`` on a feature-major one) over
    ``group`` with the row's bias corrections. Returns ``(ag_state,
    loss)``."""
    if route == KERNEL:
        return kernel_train_step(agent, ag_state, batch, row[layout.count])
    step = agent.train_step if row_major else agent.train_step_t
    return step(ag_state, batch, group,
                corrections=layout.bias_corrections(row))


@dataclasses.dataclass
class Tick:
    """An engine's tick: ``tick(carry) -> (carry, (rewards (E,), epsilon,
    loss))`` runs it eagerly, and :class:`Chunk` runs chunks of it.

    ``body(carry, row, sig, host=None)`` is the tick on the words of one
    row of ``layout`` (an int32 tensor on ``device``) under its static
    signature ``sig``: it reads no host value that varies within a
    signature, copies nothing from the host and leaves the carry's
    ``rng``, ``step``, Adam count and replay cursor and size to its
    caller. ``host``, the same row on the host, has the body take from
    it the push's start slot, the replay sample's key, bound and base and
    the ε draw's key, which then push with slices and split and draw on
    the host: the eager tick passes it, for far fewer launches (a graph
    cannot). ``walk(chain, t,
    tick_keys) -> (row, sig, chain')`` makes tick ``t``'s row and
    signature from the host chain before it and the tick's keys, and
    returns the chain after it but its rng. ``keys`` and ``group`` as
    :func:`host_keys`'s (a chunk needs ``keys.table``); ``signature``,
    the ring's ``signature(step)``; ``learner``, the route of its TD step
    (:func:`learner_route`, or ``IN_KERNEL_TD``); ``env_step``, the jnp
    engine's route of its env step and observation (:func:`step_route`),
    None where a tick kernel steps the envs."""

    body: Callable
    walk: Callable
    keys: Callable
    layout: RowLayout
    device: torch.device
    group: Any = None
    signature: Optional[Callable] = None
    learner: str = AUTOGRAD
    env_step: Optional[str] = None

    @property
    def graphed(self) -> bool:
        """How a :class:`Chunk` runs the tick: as CUDA graphs on a card
        where it averages over no process group or over an NCCL one (a
        graph captures NCCL's all-reduce); else as eager rows, on the CPU
        and over a gloo group on a card (gloo stages a CUDA tensor through
        the host, which no graph holds)."""
        if self.device.type != "cuda":
            return False
        return (self.group is None
                or torch.distributed.get_backend(self.group) == "nccl")

    def __call__(self, carry):
        """Walk the carry's chain one tick, copy the row over, run the body
        (its replay sample drawn on the host) and set the carry's host
        values from the chain."""
        chain = _host_chain(carry)
        rng, tick_keys = self.keys(chain.rng, chain.step)
        row, sig, chain = self.walk(chain, 0, tick_keys)
        carry, outs = self.body(carry, upload(row, torch.int32, self.device),
                                sig, row)
        return _settle(carry, chain._replace(rng=rng)), outs


class Signature(NamedTuple):
    """The host values that fix a replay engine's tick (jnp, full, fused):
    whether it trains (``can_sample`` after the push, worked out on the
    host), the reset, the target sync and the ε decay (None where it
    follows the episode's done). Nothing of the replay's cursor or size,
    so at most 2 · 2 · 2 · 3 graphs whatever the replay's capacity."""

    trains: bool
    reset: bool
    sync: bool
    decay: Optional[bool]


def _replay_walk(agent: DQN, buffer, layout: RowLayout,
                 reset_env_every: int, push_size: int):
    """A replay engine's ``walk``: the push's words from the replay's
    cursor and size (``buffer.push_words``, a push of ``push_size``
    transitions), the signature, the Adam count advanced where the tick
    trains."""
    def walk(chain: HostChain, t: int, tick_keys):
        push = buffer.push_words(chain.cursor, chain.size, push_size)
        trains = buffer.can_sample(replay.ReplayState({}, 0, push.size))
        sig = Signature(trains, chain.step % reset_env_every == 0,
                        *agent.schedule_flags(chain.step))
        row = layout.make(tick_keys, chain.count, t, push)
        return row, sig, HostChain(chain.rng, chain.step + 1,
                                   chain.count + trains, push.cursor,
                                   push.size)

    return walk


class RingSignature(NamedTuple):
    """The host values that fix a ring tick's launches (its static
    signature): the read slot ``step % nb``, the complete columns ``min(step
    + 1, nb - 1)`` that the replay samples from, the reset, the target
    sync, the ε decay (None where it follows the episode's done) and
    whether the tick trains. Ticks of one signature launch the same
    kernels with the same arguments but the per-tick words."""

    slot: int
    valid_cols: int
    reset: bool
    sync: bool
    decay: Optional[bool]
    trains: bool


def build_train_step_ring(agent: DQN, env_params: EnvParams, num_envs: int,
                          capacity: int, batch_size: int,
                          reset_env_every: int, collect_drones: int = 1,
                          in_kernel_td: Optional[bool] = None,
                          rng_rounds: int = 20,
                          actor_rng_rounds: Optional[int] = None,
                          keys=None, group=None):
    """The ring-engine tick: ``tick(carry) -> (carry, (rewards (E,),
    epsilon, loss))``, with the JAX trainer's carry layout ``(rng,
    (tstate, ring), (a_ring, r_ring, d_ring), ag_state, aux, step)``.
    ``keys`` and ``group`` as :func:`host_keys` (the tick draws a step key
    and a sample key).

    ``capacity`` counts ring columns; each holds ``collect_drones`` = k
    transitions (pass the same k to :func:`init_ring_carry`), and
    ``batch_size`` must be a multiple of k. ``loss`` is ``NO_TRAIN_LOSS``
    on ticks where the ring holds fewer than ``batch_size // k`` complete
    columns. With ``in_kernel_td`` (pass the same to
    :func:`init_ring_carry`) the learner kernel trains inside tick t+1 on
    the batch gathered after tick t, carried in ``aux``; tick 0 never
    trains.

    The tick is a :class:`Tick` on rows of ``RowLayout(2)`` (the step
    and sample keys, the Adam count, the bias corrections) under the
    static signature ``tick.signature(step)`` (:class:`RingSignature`).
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
    layout = RowLayout(2)
    td_hparams = None
    route = (IN_KERNEL_TD if in_kernel_td
             else learner_route(agent, batch_size, group))
    if in_kernel_td:
        if group is not None:
            raise ValueError(
                "in_kernel_td runs Adam inside the learner kernel, with no "
                "point for the gradient all-reduce")
        td_hparams = (float(agent.config.gamma),
                      float(agent.config.learning_rate),
                      ADAM_B1, ADAM_B2, ADAM_EPS)  # optax.adam's defaults

    def signature(step: int) -> RingSignature:
        valid_cols = min(step + 1, nb - 1)
        # The in-kernel learner trains on the batch gathered after the
        # tick before, with min(step, nb - 1) complete columns.
        cols = min(step, nb - 1) if td_hparams is not None else valid_cols
        sync, decay = agent.schedule_flags(step)
        return RingSignature(step % nb, valid_cols,
                             step % reset_env_every == 0, sync, decay,
                             cols * num_envs >= batch_size // k)

    def walk(chain: HostChain, t: int, tick_keys):
        sig = signature(chain.step)
        row = layout.make(tick_keys, chain.count, t)
        return row, sig, chain._replace(step=chain.step + 1,
                                        count=chain.count + sig.trains)

    def body(carry, row, sig: RingSignature, host=None):
        _, (tstate, ring), (a_ring, r_ring, d_ring), ag_state, aux, _ = carry
        step_key, sample_key = layout.keys(row)
        if host is not None:
            sample_key = layout.host_key(host, 1)
        read_slot = sig.slot * num_envs
        write_slot = ((sig.slot + 1) % nb) * num_envs
        chain = fused_tick.flatten_net_params(ag_state.params,
                                              agent.net_spec)
        args = (step_key, tstate, ring, read_slot, write_slot, chain,
                ag_state.epsilon, sig.reset, env_params)
        if td_hparams is not None:
            adam = ag_state.opt_state
            tstate, rewards_t, dones_t, actions_t, ring, _, _, _, loss = (
                fused_tick.full_tick_fused_ring(
                    *args, td_hparams=td_hparams, td_batch=aux,
                    td_aux=(ag_state.params, ag_state.target_params,
                            adam.mu, adam.nu, sig.trains, row[layout.count]),
                    **rng_collect))
            if sig.trains:
                adam.count += 1
        else:
            tstate, rewards_t, dones_t, actions_t, ring = (
                fused_tick.full_tick_fused_ring(*args, **rng_collect))

        # Scalars live at the same slot as this tick's input observation.
        a_ring, r_ring, d_ring = fused_tick.ring_scalar_writes(
            a_ring, r_ring, d_ring, actions_t, rewards_t, dones_t, read_slot,
            k)

        # Complete columns after tick t: steps [max(0, t+2-nb), t], whose
        # first slot is (t + 2) % nb once t + 2 >= nb.
        if td_hparams is not None or sig.trains:
            base = 0 if sig.valid_cols < nb - 1 else (sig.slot + 2) % nb
            batch = fused_tick.ring_gather_batch(
                sample_key, ring, a_ring, r_ring, d_ring,
                sig.valid_cols * num_envs, base, num_envs=num_envs,
                capacity=capacity, batch_size=batch_size, collect=k,
                obs_dim=agent.obs_dim)
        if td_hparams is not None:
            aux = batch  # trained on inside the next tick
        elif sig.trains:
            ag_state, loss = learner_step(agent, route, ag_state, batch,
                                          row, layout, group)
        else:
            loss = torch.full((), NO_TRAIN_LOSS, dtype=torch.float32,
                              device=device)
        ag_state = agent.apply_schedules(ag_state, None, dones_t[0, 0],
                                         flags=(sig.sync, sig.decay))

        carry = (carry[0], (tstate, ring), (a_ring, r_ring, d_ring),
                 ag_state, aux, carry[-1])
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return Tick(body, walk, keys or host_keys(layout.num_keys), layout,
                device, group, signature, route)


class Chunk:
    """An engine's chunk, the counterpart of the JAX trainers' ``run_chunk``
    and sharded ``build_chunk`` (``jax.jit(lax.scan(tick))``, per shard
    under ``shard_map``): ``chunk(carry, length) -> (carry, (rewards
    (length, E), epsilon (length,), loss (length,)))``, ``length`` ticks
    of ``tick`` (the :class:`Tick` of :func:`build_train_step_ring`,
    :func:`build_train_step_full`, :func:`build_train_step_fused` or
    :func:`build_train_step`, with one card's keys or, from
    ``parallel.DistributedTrainer``, a shard's keys and a process group).

    At entry the host walks the chain that the eager tick walks
    (``tick.walk``: the keys from the carry's ``rng`` and ``step``, the
    Adam count, over a replay its cursor and size) into a (length,
    ``tick.layout.words``) table of rows and copies it to the device: the
    chunk's one host-to-device copy. Where ``tick.graphed`` (decided here,
    before any capture) each tick is then one device-to-device copy of its
    row into a static row and one replay of the CUDA graph of its
    signature, captured on first use (``utils.graphs.GraphSet``; a capture
    that fails raises), the gradient all-reduce of a grouped tick inside
    the graph. The graphs share one static carry, the first carry passed
    in (a later carry is copied into it, and the carry returned is it),
    and write each tick's outputs into preallocated (length, ...)
    tensors; nothing is read back to the host inside a chunk. At exit the
    carry's ``rng``, ``step``, Adam count and replay cursor and size are
    set from the chain. Elsewhere (the CPU, a gloo group) the same rows
    run the tick's body eagerly.

    The ranks of a group meet every signature at the same tick (the
    signatures follow the step, the replay's cursor and size and the
    schedules, which advance alike on every rank), so they capture in
    lockstep: a capture's warm-up runs the all-reduce eagerly. A grouped
    tick is captured in ``"thread_local"`` mode, so that another thread's
    CUDA call (the group's watchdog queries the events of earlier
    collectives) cannot invalidate the capture, as it may in the global
    mode.

    A chunk adds the launches each signature's capture recorded, times its
    replays, to the counters of :data:`COUNTERS` (the kernels' launches,
    the draws' and the ring sample's among them, and the all-reduces; and
    the work a tick does outside the port's kernels: a conv actor's module
    forward, the StreamReplay's push in ATen, the autograd learner's
    steps, the periodic reset in plain PyTorch) once before it returns; a
    capture's warm-up (on a copy of the carry) and the capture leave the
    counts as they were.

    The chunk times its own host work once a chunk by phase (a
    ``utils.profiling.PhaseClock``, read by :meth:`phase_ns`): ``keys``
    (the key table), ``walk`` (the rows and signatures), ``upload`` (the
    table's copy), ``adopt``, ``capture`` (each capture with its warm-up),
    ``replay`` (the row copies and graph replays) or ``eager`` (the rows
    run eagerly), and ``outputs`` (the outputs' clones and the carry's
    host values). While a profiler collects, ``keys`` and ``walk``, which
    launch nothing on the device, are also ranges ``phase:chunk.keys``
    and ``phase:chunk.walk``, so that the card's idle time can be put
    down to them.
    """

    COUNTERS = ((fused_tick, "full_tick_fused_ring", "launches"),
                (learner_kernel, "td_adam", "launches"),
                (fused_tick, "full_tick_fused", "launches"),
                (fused_tick, "full_tick_fused", "pushes"),
                (fused_tick, "tick_fused", "launches"),
                (step_kernel, "step_batch_fused", "launches"),
                (draws, "draw", "launches"),
                (draws, "ring_sample", "launches"),
                (draws, "stream_sample", "launches"),
                (draws, "buffer_sample", "launches"),
                (dqn_module, "all_reduce_mean", "calls"),
                (DQN, "act_t", "module_forwards"),
                (replay.StreamReplay, "push_many", "calls"),
                (DQN, "_td_step", "calls"),
                (env_core, "reset_batch", "calls"))
    COUNTS = ("chunks", "ticks", "captures")   # the clock's counts

    def __init__(self, tick):
        if not hasattr(tick.keys, "table"):
            raise ValueError(
                "a chunk walks its ticks' keys as a table: the tick's keys "
                "need a table (train.host_keys, parallel.distributed."
                "shard_keys)")
        self.tick = tick
        self.graphed = tick.graphed
        self.capture_mode = ("global" if tick.group is None
                             else "thread_local")
        self._static = None   # the static carry, its device tensors, row
        self._graphs = None   # GraphSet, outputs and launches a signature
        self._length = 0      # the ticks the output buffers hold
        self._clock = profiling.PhaseClock("chunk.", ranged=("keys", "walk"))

    @property
    def graphs(self) -> int:
        """The signatures captured."""
        return 0 if self._graphs is None else len(self._graphs[0])

    @property
    def capture_s(self) -> float:
        """Seconds of the captures (warm-ups included), all chunks."""
        return self._clock.ns.get("capture", 0) / 1e9

    def phase_ns(self) -> dict:
        """Host nanoseconds by phase over all chunks (the class's
        docstring names them; a phase not yet met is absent), with the
        counts ``chunks``, ``ticks`` and ``captures``: a copy."""
        return {**self._clock.ns, **dict.fromkeys(self.COUNTS, 0),
                **self._clock.counts}

    def table(self, carry, length: int):
        """The chunk's rows and signatures and the chain's end: ``(rows
        (length, words) int32, signatures, chain)``."""
        clock = self._clock
        clock.look()
        chain = _host_chain(carry)
        with clock.phase("keys"):
            rng, tick_keys = self.tick.keys.table(chain.rng, length,
                                                  chain.step)
        with clock.phase("walk"):
            rows = np.empty((length, self.tick.layout.words), dtype=np.int32)
            sigs = []
            for t in range(length):
                rows[t], sig, chain = self.tick.walk(chain, t, tick_keys[t])
                sigs.append(sig)
        return rows, sigs, chain._replace(rng=rng)

    def __call__(self, carry, length: int):
        clock = self._clock
        rows, sigs, chain = self.table(carry, length)
        device = self.tick.device
        with clock.phase("upload"):
            # The chunk's one host-to-device copy: every tick's words.
            table = upload(rows.reshape(-1), torch.int32, device).view(
                length, rows.shape[1])
        if not self.graphed:
            with clock.phase("eager"):
                outs = ([], [], [])
                for t in range(length):
                    carry, values = self.tick.body(carry, table[t], sigs[t])
                    for out, value in zip(outs, values):
                        out.append(value)
                outs = tuple(torch.stack(o) for o in outs)
        else:
            with clock.phase("adopt"):
                carry = self._adopt(carry, length)
            graphs, _, recorded = self._graphs
            row = self._static[2]
            with clock.phase("replay"):
                for t, sig in enumerate(sigs):
                    row.copy_(table[t])
                    if sig not in graphs:
                        self._capture(sig)
                    graphs.replay(sig)
            replays = collections.Counter(sigs)
            self._add_launches([sum(n * recorded[sig][i]
                                    for sig, n in replays.items())
                                for i in range(len(self.COUNTERS))])
        with clock.phase("outputs"):
            if self.graphed:
                outs = tuple(b[:length].clone() for b in self._graphs[1])
            carry = _settle(carry, chain)
        clock.count("chunks")
        clock.count("ticks", length)
        return carry, outs

    # --- the graphs ----------------------------------------------------------

    def _launches(self):
        return [getattr(getattr(owner, name), count)
                for owner, name, count in self.COUNTERS]

    def _add_launches(self, added):
        for (owner, name, count), n in zip(self.COUNTERS, added):
            fn = getattr(owner, name)
            setattr(fn, count, getattr(fn, count) + n)

    def _adopt(self, carry, length: int):
        """The static carry with ``carry``'s tensors copied into it (the
        first carry passed in becomes it); new graphs where the output
        buffers hold fewer than ``length`` ticks."""
        tensors = train_state_io.leaves(carry)[0]
        if self._static is None:
            self._static = (carry, {p: t for p, t in tensors.items()
                                    if t.is_cuda},
                            torch.zeros(self.tick.layout.words,
                                        dtype=torch.int32,
                                        device=self.tick.device))
        static, static_tensors, row = self._static
        for path, t in static_tensors.items():
            given = tensors[path]
            if given is not t:
                if given.shape != t.shape or given.dtype != t.dtype:
                    raise ValueError(
                        f"carry {path}: {given.dtype} {tuple(given.shape)}, "
                        f"the chunk's {t.dtype} {tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(given)
        if self._graphs is None or self._length < length:
            # The graphs write into the output buffers (made at the first
            # capture): new buffers, new graphs.
            self._graphs = (GraphSet(row.device), None, {})
            self._length = length
        return static

    def _capture(self, sig) -> None:
        """Capture the step of ``sig``: the tick's body on the static carry
        and row, its new tensors copied into the static carry and its
        outputs into row ``layout.tick`` of the output buffers."""
        static, static_tensors, row = self._static
        graphs, _, recorded = self._graphs
        at_word = self.tick.layout.tick

        def shell():
            # The learner state's objects copied, so that the step rebinds
            # ε and the count there; the tensors are the static carry's.
            ag = static[3]
            ag = dataclasses.replace(
                ag, opt_state=dataclasses.replace(ag.opt_state))
            return (*static[:3], ag, *static[4:])

        def step():
            new, values = self.tick.body(shell(), row, sig)
            new = train_state_io.leaves(new)[0]
            with torch.no_grad():
                for path, t in static_tensors.items():
                    if new[path] is not t:
                        t.copy_(new[path])
            at = row[at_word:at_word + 1].to(torch.int64)
            for buffer, value in zip(self._graphs[1], values):
                buffer.index_copy_(0, at, value.reshape(1,
                                                        *buffer.shape[1:]))

        marks = []

        def warm_up():
            _, values = self.tick.body(copy.deepcopy(static), row, sig)
            marks.append(self._launches())
            if self._graphs[1] is None:
                self._graphs = (graphs, tuple(
                    torch.empty((self._length, *v.shape), dtype=v.dtype,
                                device=row.device) for v in values),
                    recorded)

        before = self._launches()
        with self._clock.phase("capture"):
            graphs.capture(sig, step, warm_up, self.capture_mode)
        self._clock.count("captures")
        after = self._launches()
        recorded[sig] = [a - m for a, m in zip(after, marks[0])]
        self._add_launches([b - a for a, b in zip(after, before)])


def build_chunk_ring(agent: DQN, env_params: EnvParams, num_envs: int,
                     capacity: int, batch_size: int, reset_env_every: int,
                     collect_drones: int = 1,
                     in_kernel_td: Optional[bool] = None,
                     rng_rounds: int = 20,
                     actor_rng_rounds: Optional[int] = None) -> Chunk:
    """:class:`Chunk` over :func:`build_train_step_ring`'s tick with these
    arguments."""
    return Chunk(build_train_step_ring(
        agent, env_params, num_envs, capacity, batch_size, reset_env_every,
        collect_drones, in_kernel_td=in_kernel_td, rng_rounds=rng_rounds,
        actor_rng_rounds=actor_rng_rounds))


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

def _sample_and_learn(agent: DQN, buffer: replay.StreamReplay, bstate,
                      ag_state, words, trains: bool, learn):
    """After the tick's push: where the tick ``trains`` sample (the key,
    bound and base of ``words``, ``RowLayout.replay_words``) and take the
    TD step (``learn(ag_state, batch) -> (ag_state, loss)``, the tick's
    :func:`learner_step`), else loss ``NO_TRAIN_LOSS``. Returns
    ``(ag_state, loss)``."""
    _, sample_key, bound, base = words
    if not trains:
        return ag_state, torch.full((), NO_TRAIN_LOSS, dtype=torch.float32,
                                    device=agent.device)
    batch = buffer.sample_batch(sample_key, bstate, bound=bound, base=base)
    return learn(ag_state, batch)


def _push_and_learn(agent: DQN, buffer: replay.StreamReplay, bstate,
                    ag_state, words, trains: bool, obs_t, actions_t,
                    rewards_t, dones_t, k: int, learn):
    """The fused engine's push and TD step, whose observation comes from
    the env tick kernel (B4): push the tick's transitions of the first k
    drones (``replay.stream_push_batch``) at the start slot of ``words``,
    then :func:`_sample_and_learn`. (The full engine's push is B3's own.)
    Returns ``(bstate, ag_state, loss)``."""
    bstate = buffer.push_many(
        bstate, replay.stream_push_batch(obs_t, actions_t, rewards_t,
                                         dones_t, k), start=words[0])
    ag_state, loss = _sample_and_learn(agent, buffer, bstate, ag_state,
                                       words, trains, learn)
    return bstate, ag_state, loss


def build_train_step_full(agent: DQN, buffer: replay.StreamReplay,
                          env_params: EnvParams, num_envs: int,
                          reset_env_every: int, collect_drones: int = 1,
                          rng_rounds: int = 20,
                          actor_rng_rounds: Optional[int] = None,
                          keys=None, group=None):
    """The full-engine tick around the full tick kernel (B3): ``tick(carry)
    -> (carry, (rewards (E,), epsilon, loss))`` with the JAX trainer's
    carry ``(rng, tstate, obs_t, ag_state, bstate, step)``
    (:func:`init_stream_carry`). The replay's stride is E ·
    ``collect_drones``. B3 pushes the tick's transitions into the replay
    at the row's start slot (the caller moves the cursor and size, as
    :class:`Tick` says) and writes the next observation over the carry's
    ``obs_t``, in place (``fused_tick.full_tick_fused``'s ``replay``): a
    caller that keeps a carry passed in clones its ``obs_t`` and replay
    storage. ``loss`` is ``NO_TRAIN_LOSS`` on ticks where the replay
    holds fewer than a batch of transitions. ``keys`` and
    ``group`` as :func:`host_keys` (a step key and a sample key).

    The tick is a :class:`Tick` on rows of ``RowLayout(2, push=True)``
    (the keys, the Adam count and bias corrections, the push's start
    slot, the sample's bound and base) under ``Signature(trains, reset,
    sync, decay)``."""
    k = collect_drones
    _require_kernel_actor(agent, "full")
    layout = RowLayout(2, push=True)
    walk = _replay_walk(agent, buffer, layout, reset_env_every, num_envs * k)
    route = learner_route(agent, buffer.batch_size, group)

    def body(carry, row, sig: Signature, host=None):
        _, tstate, obs_t, ag_state, bstate, _ = carry
        step_key, sample_key = layout.keys(row)
        chain = fused_tick.flatten_net_params(ag_state.params,
                                              agent.net_spec)
        words = layout.replay_words(row, sample_key, host, 1)
        tstate, rewards_t, dones_t, actions_t, next_obs_t = (
            fused_tick.full_tick_fused(
                step_key, tstate, obs_t, chain, ag_state.epsilon,
                sig.reset, env_params, k, rng_rounds, actor_rng_rounds,
                replay=(bstate.storage, words[0])))
        ag_state, loss = _sample_and_learn(
            agent, buffer, bstate, ag_state, words, sig.trains,
            functools.partial(learner_step, agent, route, row=row,
                              layout=layout, group=group))
        ag_state = agent.apply_schedules(ag_state, None, dones_t[0, 0],
                                         flags=(sig.sync, sig.decay))
        carry = (carry[0], tstate, next_obs_t, ag_state, bstate, carry[-1])
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return Tick(body, walk, keys or host_keys(layout.num_keys), layout,
                agent.device, group, learner=route)


def build_train_step_fused(agent: DQN, buffer: replay.StreamReplay,
                           env_params: EnvParams, num_envs: int,
                           reset_env_every: int, collect_drones: int = 1,
                           rng_rounds: int = 20, keys=None, group=None):
    """The fused-engine tick around the env tick kernel (B4), for any net:
    the actions come from outside the kernel (random opponents and drone
    0's ``DQN.act_t``, drawn on the device at 20 rounds; a conv net's own
    forward) and the periodic reset runs after the step in plain PyTorch
    at 20 rounds, as in the JAX trainer; ``rng_rounds`` reaches the
    kernel. Carry and outputs as :func:`build_train_step_full`; ``keys``
    and ``group`` as :func:`host_keys` (the opponents', the actor's, the
    step's, the sample's and the reset's keys). A :class:`Tick` as the
    full tick, on rows of ``RowLayout(5, push=True)``."""
    k = collect_drones
    obs_dim = agent.obs_dim
    layout = RowLayout(5, push=True)
    walk = _replay_walk(agent, buffer, layout, reset_env_every, num_envs * k)
    route = learner_route(agent, buffer.batch_size, group)

    def body(carry, row, sig: Signature, host=None):
        _, tstate, obs_t, ag_state, bstate, _ = carry
        rand_key, act_key, step_key, sample_key, reset_key = layout.keys(row)
        # N x E and E counters: hashed on the device, not the host.
        actions_t = rng_mod.randint(rand_key,
                                    (env_params.n_drones, num_envs), 0,
                                    NUM_ACTIONS)
        if host is not None:  # the ε draw's split on the host
            act_key = layout.host_key(host, 1)
        actions_t[0] = agent.act_t(act_key, obs_t[:obs_dim], ag_state)
        tstate, rewards_t, dones_t, next_obs_t = fused_tick.tick_fused(
            step_key, tstate, actions_t, env_params, k, rng_rounds)
        bstate, ag_state, loss = _push_and_learn(
            agent, buffer, bstate, ag_state,
            layout.replay_words(row, sample_key, host, 3), sig.trains,
            obs_t, actions_t, rewards_t, dones_t, k,
            functools.partial(learner_step, agent, route, row=row,
                              layout=layout, group=group))
        ag_state = agent.apply_schedules(ag_state, None, dones_t[0, 0],
                                         flags=(sig.sync, sig.decay))
        if sig.reset:
            states = env_core.reset_batch(reset_key, env_params, num_envs)
            tstate = fused_tick.to_tstate(states)
            next_obs_t = _stacked_obs(states, env_params, k)
        carry = (carry[0], tstate, next_obs_t, ag_state, bstate, carry[-1])
        return carry, (rewards_t[0], ag_state.epsilon, loss)

    return Tick(body, walk, keys or host_keys(layout.num_keys), layout,
                agent.device, group, learner=route)


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
                     reset_env_every: int, collect_drones: int = 1,
                     keys=None, group=None):
    """The jnp-engine tick (``dronerl_tpu/train.py::build_train_step``):
    ``tick(carry) -> (carry, (rewards (E,), epsilon, loss))`` with the
    carry ``(rng, env_states, obs (E, k, obs_dim), ag_state, bstate,
    step)`` (:func:`init_jnp_carry`); ``k`` = ``collect_drones`` drones
    of every env feed the replay. ``loss`` is ``NO_TRAIN_LOSS`` until the
    buffer holds a batch. ``keys`` and ``group`` as :func:`host_keys`
    (the opponents', the actor's, the step's, the sample's and the
    reset's keys). A :class:`Tick` as the full tick, on rows of
    ``RowLayout(5, push=True)`` (the push's start slot clamped as
    ``replay.push_start``'s, the sample's bound the replay's size), its
    ``env_step`` :func:`step_route`'s."""
    obs_dim = agent.obs_dim
    k = collect_drones
    layout = RowLayout(5, push=True)
    walk = _replay_walk(agent, buffer, layout, reset_env_every, num_envs * k)
    route = learner_route(agent, buffer.batch_size, group)
    env_step = step_route(env_params, num_envs, k, agent.device)

    def learner_obs(states):
        return env_core.observe_batch(states, env_params, k).reshape(
            num_envs, k, obs_dim)

    def body(carry, row, sig: Signature, host=None):
        _, env_states, obs, ag_state, bstate, _ = carry
        rand_key, act_key, step_key, sample_key, reset_key = layout.keys(row)
        actions = rng_mod.randint(rand_key, (num_envs, env_params.n_drones),
                                  0, NUM_ACTIONS)
        if host is not None:  # the ε draw's split on the host
            act_key = layout.host_key(host, 1)
        actions[:, 0] = agent.act(act_key, obs[:, 0], ag_state)
        if env_step == KERNEL:  # the row's key words, read by pointer
            env_states, rewards, dones, next_obs = (
                step_kernel.step_batch_fused(
                    layout.key_words(row, 2), env_states, actions,
                    env_params, k))
        else:
            env_states, rewards, dones = env_core.step_batch(
                rng_mod.split(step_key, num_envs), env_states, actions,
                env_params)
            next_obs = learner_obs(env_states)
        start, sample_key, bound, _ = layout.replay_words(
            row, sample_key, host, 3)
        bstate = buffer.push_many(bstate, {
            "obs": obs.reshape(num_envs * k, obs_dim),
            "actions": actions[:, :k].reshape(-1),
            "rewards": rewards[:, :k].reshape(-1),
            "next_obs": next_obs.reshape(num_envs * k, obs_dim),
            "dones": dones[:, :k].reshape(-1),
        }, start=start)
        if sig.trains:  # feature-major for the learner kernel
            batch = buffer.sample_batch(sample_key, bstate, bound=bound,
                                        feature_major=route == KERNEL)
            ag_state, loss = learner_step(agent, route, ag_state, batch,
                                          row, layout, group,
                                          row_major=route != KERNEL)
        else:
            loss = torch.full((), NO_TRAIN_LOSS, dtype=torch.float32,
                              device=agent.device)
        ag_state = agent.apply_schedules(ag_state, None, dones[0, 0],
                                         flags=(sig.sync, sig.decay))
        if sig.reset:
            env_states = env_core.reset_batch(reset_key, env_params,
                                              num_envs)
            next_obs = learner_obs(env_states)
        carry = (carry[0], env_states, next_obs, ag_state, bstate, carry[-1])
        return carry, (rewards[:, 0], ag_state.epsilon, loss)

    return Tick(body, walk, keys or host_keys(layout.num_keys), layout,
                agent.device, group, learner=route, env_step=env_step)


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
REFUSED_FLAGS = {
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
    # sharding
    p.add_argument("--use_sharding", action="store_true",
                   help="shard the envs and replay over the ranks of a "
                   "process group, one process a device, the learner "
                   "replicated (one process alone: a mesh of one rank)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 for multi-process runs "
                   "(else torchrun's environment, else one process)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count for multi-process runs")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank for multi-process runs")
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
    if args.use_sharding and args.in_kernel_td:
        raise ValueError(
            "--in_kernel_td cannot run with --use_sharding: the learner "
            "kernel applies Adam inside the kernel, with no point for the "
            "gradient all-reduce")
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
    """The engine's chunk (:class:`Chunk`: CUDA graphs on the card, eager
    ticks on the CPU), as the JAX CLI runs ``run_chunk``, and its initial
    carry from ``--seed``."""
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
        return Chunk(tick), init_jnp_carry(agent, env_params, num_envs,
                                           buffer, rng, k)
    if engine == "ring":
        ring_columns = ring_capacity // k  # k transitions a column
        logger.info("env %s | agent %s | %d envs, ring %d columns (%s)%s on "
                    "%s", env_params, agent.config, num_envs, ring_columns,
                    args.ring_obs_dtype,
                    ", in-kernel TD" if args.in_kernel_td else "", device)
        tick = build_chunk_ring(
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
    return Chunk(tick), init_stream_carry(agent, env_params, num_envs,
                                          buffer, rng, k)


def sharded_engine(args, env_params: EnvParams, world_size: int,
                   agent_config: Optional[DQNConfig] = None) -> str:
    """The sharded engine (``"ring"``, ``"fused"`` or ``"jnp"``), by the JAX
    CLI's gate for ``--use_sharding``: the fused family where
    ``--engine fused``, or under ``auto`` where :func:`fused_engine_problems`
    finds no reason at the shard's env count; in it the ring engine when
    the actor runs in the kernel, the shard's batch divides by
    ``--collect_drones`` and its ring holds at most 4 env-batches. Logs the
    choice and why the ring engine was skipped."""
    envs_per_shard = args.num_envs // world_size
    problems = fused_engine_problems(env_params, envs_per_shard)
    if args.engine == "fused" and problems:
        raise ValueError("--engine fused is not available for this "
                         "config: " + "; ".join(problems))
    use_fused = args.engine == "fused" or (args.engine == "auto"
                                           and not problems)
    cfg = agent_config or args
    dense = cfg.network_type == "dense" or cfg.conv_matmul
    k = args.collect_drones
    batch = max(1, args.batch_size // world_size)
    ring_capacity = max(
        math.ceil(max(1, args.memory_size // world_size) / envs_per_shard)
        * envs_per_shard, 2 * envs_per_shard)
    skip = ring_skip_reasons(dense, ring_capacity, envs_per_shard * k,
                             batch, k)
    engine = ("jnp" if not use_fused else "fused" if skip else "ring")
    logger.info("Sharded engine: %s (%d ranks x %d envs)", engine,
                world_size, envs_per_shard)
    if problems and args.engine == "auto":
        logger.info("Fused engines skipped (%s)", "; ".join(problems))
    if engine == "fused":
        logger.info("Per-shard ring engine skipped (%s)", "; ".join(skip))
    return engine


def _join_mesh(args, device: torch.device):
    """The data-parallel mesh of ``--use_sharding`` (None without it),
    after joining the process group of ``--coordinator_address`` /
    ``--num_processes`` / ``--process_id`` or torchrun's environment."""
    from dronerl_tpu_torch.parallel import mesh as mesh_mod

    flags = args.coordinator_address or (args.num_processes or 0) > 1
    if (flags or args.use_sharding) and not torch.distributed.is_initialized():
        mesh_mod.initialize_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            device=device.type)
    if not args.use_sharding:
        return None
    mesh = mesh_mod.make_env_mesh(device=device.type)
    if args.num_envs % mesh.world_size:
        raise ValueError(
            f"num_envs ({args.num_envs}) must be divisible by the device "
            f"count ({mesh.world_size}) when sharding")
    return mesh


def _build_sharded(args, agent: DQN, env_params: EnvParams, mesh,
                   scan_steps: int):
    """This rank's sharded trainer (``parallel.DistributedTrainer``, the
    shard's replay and batch the CLI's divided by the world size), its
    chunk of ``scan_steps`` ticks (its :class:`Chunk`) and its initial
    carry from ``--seed``, and the tick kernels' round counts."""
    from dronerl_tpu_torch.parallel.distributed import (
        DistributedTrainer, local_engine)

    if agent.config.epsilon_decay_every is None:
        raise ValueError(
            "--use_sharding requires --epsilon_decay_every (episode-"
            "boundary ε decay is not defined across env shards)")
    world = mesh.world_size
    engine = sharded_engine(args, env_params, world, agent.config)
    rounds = engine_rng_rounds(args, local_engine(engine, agent))
    trainer = DistributedTrainer(
        agent, env_params, mesh, num_envs=args.num_envs,
        buffer_capacity_per_shard=max(1, args.memory_size // world),
        batch_size_per_shard=max(1, args.batch_size // world),
        collect_drones=args.collect_drones,
        reset_env_every=args.reset_env_every, engine=engine,
        rng_rounds=rounds[0], actor_rng_rounds=rounds[1])
    if args.log_histograms:
        logger.info("--log_histograms: per-chunk q/action histograms read "
                    "the single-card replay layouts and are unavailable "
                    "for sharded carries; scalar curves (reward/ε/td_loss) "
                    "still log per chunk")
    carry = trainer.init_carry(rng_mod.PRNGKey(args.seed),
                               obs_dtype=getattr(torch, args.ring_obs_dtype))
    return trainer, trainer.build_chunk(scan_steps).chunk, carry, rounds


def train_state_path(run_dir: str, mesh=None) -> str:
    """Where a run keeps its train state: ``train_state.safetensors``, or
    under ``--use_sharding`` each rank its own ``train_state.rank<r>.
    safetensors``."""
    if mesh is None:
        return os.path.join(run_dir, TRAIN_STATE_FILE)
    return os.path.join(run_dir, TRAIN_STATE_RANK_FILE.format(rank=mesh.rank))


def _resume_path(path: str, mesh) -> str:
    """``--resume_from`` for this rank: a train state file, or under
    ``--use_sharding`` the run dir that holds the ranks' files."""
    if mesh is not None and os.path.isdir(path):
        return train_state_path(path, mesh)
    return path


def _shared_run_dir(args, mesh) -> str:
    """``--run_dir``, else ``output/run_<time>`` on rank 0's clock (every
    rank keeps its train state there)."""
    run_dir = args.run_dir or os.path.join(
        "output", f"run_{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    if mesh is not None and mesh.world_size > 1:
        holder = [run_dir]
        torch.distributed.broadcast_object_list(holder, src=0,
                                                group=mesh.group)
        run_dir = holder[0]
    return run_dir


def train(args, metrics_logger=None) -> dict:
    """The JAX CLI's run: the engine of :func:`choose_engine` (with
    ``--use_sharding`` this rank's shard of :func:`sharded_engine`'s); the
    warm start (``--load_from_checkpoint``: the loaded net in the online
    and target nets, a fresh Adam and ε), then ``--resume_from`` (which
    overrides it), both before the kernels are built; ``ceil(num_steps /
    max_scan_steps)`` chunks of ``max_scan_steps`` ticks (with
    ``--profile`` one more, untimed, before the trace), an eval before
    every chunk but the first with ``--eval_while_training``, per-chunk
    scalars and histograms into ``metrics_logger``; then
    ``--inspect_memory``, ``--save_final_checkpoint``,
    ``--save_train_state``, the final eval unless ``--skip_final_eval``,
    ``--render_video`` and ``metrics.json`` in the run dir, which holds
    ``chunk_host_ms``: the chunk's host ms a chunk by phase over the run's
    chunks (:meth:`Chunk.phase_ns`), with its captures.

    Under ``--use_sharding`` rank 0 alone writes the metrics, the
    checkpoints, the video and ``metrics.json``, runs the evals (the
    learner is replicated) and inspects its replay; each rank saves and
    resumes its own train state (:func:`train_state_path`); obs/s counts
    every rank's envs."""
    device = resolve_device(args.device)
    owns_group = not torch.distributed.is_initialized()
    mesh = _join_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    rank0 = mesh is None or mesh.rank == 0
    env_params = env_params_from_args(args)
    env_params.validate()
    if args.eval_while_training or not args.skip_final_eval:
        env_params_from_args(args, eval_mode=True)
    agent_config, warm_params = _warm_start(args, agent_config_from_args(args))

    run = None
    if args.wandb and rank0:
        import wandb

        run = wandb.init(project=args.wandb_project, group=args.wandb_group,
                         entity=args.wandb_entity, config=vars(args))
    if not rank0:
        metrics_logger = NoLogger()
    elif metrics_logger is None:
        metrics_logger = build_logger(tensorboard_dir=args.tensorboard_dir,
                                      wandb_run=run)
    log_metrics = not isinstance(metrics_logger, NoLogger)
    run_dir = _shared_run_dir(args, mesh)
    os.makedirs(run_dir, exist_ok=True)
    logger.info("Run dir: %s", run_dir)

    agent = DQN(agent_config, env_params, device=device)
    scan_steps = min(args.num_steps, args.max_scan_steps)
    num_chunks = math.ceil(args.num_steps / scan_steps)
    if mesh is None:
        engine = choose_engine(args, env_params, agent_config)
        rng_rounds, actor_rng_rounds = engine_rng_rounds(args, engine)
        tick, carry = _build_engine(args, agent, env_params, engine,
                                    rng_rounds, actor_rng_rounds)
        engine_name = engine
    else:
        trainer, tick, carry, (rng_rounds, actor_rng_rounds) = (
            _build_sharded(args, agent, env_params, mesh, scan_steps))
        engine, engine_name = trainer.local_engine, f"sharded-{trainer.engine}"
    logger.info("Learner: %s", tick.tick.learner)
    if tick.tick.env_step is not None:
        logger.info("Env step: %s", tick.tick.env_step)
    if warm_params is not None:
        agent.state_with_params(carry[3], qnet_from_flax(
            warm_params, device, env_params.obs_shape,
            agent_config.conv_specs()))
    shard = None if mesh is None else (mesh.rank, mesh.world_size)
    if args.resume_from:
        resume_path = _resume_path(args.resume_from, mesh)
        carry = train_state_io.restore(resume_path, carry, shard=shard)
        logger.info("Resumed training state from %s (step %s)",
                    resume_path, carry[-1])
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
    if tick.tick.learner == KERNEL:
        t0 = time.perf_counter()
        _build.load(learner_kernel.kernel_config(carry[3].params))
        logger.info("learner kernel ready in %.1fs", time.perf_counter() - t0)
    if tick.tick.env_step == KERNEL:
        t0 = time.perf_counter()
        _build.load(_build.env_config(env_params, args.collect_drones))
        logger.info("step kernel ready in %.1fs", time.perf_counter() - t0)

    def run_chunk(carry):
        carry, (rewards, epsilon, losses) = tick(carry, scan_steps)
        return carry, (list(rewards) if log_metrics else [rewards[-1]],
                       epsilon[-1], list(losses))

    profile_dir = os.path.join(run_dir, "profile")
    profile = args.profile and rank0
    if profile:
        carry, _ = run_chunk(carry)  # warm-up outside the trace
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    all_losses = []
    with (profiling.trace(profile_dir) if profile
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        for chunk in range(num_chunks):
            if args.eval_while_training and chunk > 0 and rank0:
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
                           (chunk + 1) * scan_steps, mesh is None)
        mean_reward = float(rewards[-1].mean())  # host sync: the loop is done
        elapsed = time.perf_counter() - t0
    if profile:
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
                if device.type == "cuda" else "cpu", engine_name)
    clock = tick.phase_ns()
    host_ms = {name: ns / clock["chunks"] / 1e6 for name, ns in clock.items()
               if name not in Chunk.COUNTS}
    metrics["chunk_host_ms"] = {**host_ms, "captures": clock["captures"]}
    logger.info("Chunk host ms a chunk over %d chunks (%d captures): %s",
                clock["chunks"], clock["captures"],
                ", ".join(f"{name} {ms:.3f}" for name, ms in host_ms.items()))

    ag_state = carry[3]
    if args.inspect_memory and rank0:
        if engine == "ring":
            logger.warning("--inspect_memory: the ring engine keeps no "
                           "ReplayState (observations live in the kernel's "
                           "ring); use --engine jnp or a larger "
                           "--memory_size")
        else:
            if mesh is not None:
                logger.info("--inspect_memory: rank 0's replay shard")
            replay.inspect_memory(carry[4], printer=logger.info,
                                  slot_axis=0 if engine == "jnp" else -1)
    if args.save_final_checkpoint and rank0:
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
        state_path = train_state_path(run_dir, mesh)
        train_state_io.save(state_path, carry, shard=shard)
        logger.info("Saved full training state to %s", state_path)
    if not args.skip_final_eval and rank0:
        (emean, estd), (rmean, rstd) = evaluate(args, agent, ag_state)
        metrics["eval_reward_mean"] = emean
        metrics["eval_reward_std"] = estd
        logger.info("Final eval: agent %.3f ± %.3f | random %.3f ± %.3f",
                    emean, estd, rmean, rstd)
        metrics_logger.log_scalars(
            {"eval_reward": emean, "random_reward": rmean},
            step=args.num_steps)
    if args.render_video and rank0:
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

    if rank0:
        with open(os.path.join(run_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
    metrics_logger.close()
    if run:
        run.finish()
    out = {**metrics, "engine": engine_name, "learner": tick.tick.learner,
           "env_step": tick.tick.env_step,
           "last_reward_mean": mean_reward, "epsilon": float(epsilon),
           "td_loss_mean": float(trained.mean()) if len(trained) else None,
           "trained_ticks": len(trained),
           "graphs": tick.graphs, "capture_s": tick.capture_s,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    if mesh is not None:
        out.update(rank=mesh.rank, world_size=mesh.world_size)
    if owns_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return out


def _log_chunk(metrics_logger, args, agent: DQN, carry, engine: str,
               rewards, epsilon, losses, chunk: int, step: int,
               histograms: bool = True) -> None:
    """A chunk's scalars (the mean reward of drone 0, the last ε, the mean
    TD loss over the trained ticks: warm-up ticks carry NO_TRAIN_LOSS,
    which is negative, and a NaN loss is kept and warned about) and,
    with ``--log_histograms`` and ``histograms``, its histograms."""
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
    if args.log_histograms and histograms:
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
