"""Sharded training over the ranks of a process group (counterpart of
``dronerl_tpu/parallel/distributed.py``'s ``DistributedTrainer``).

Layout, as the JAX trainer places it over its ``dp`` axis:

* **envs, observations, per-tick rewards**: each rank owns ``num_envs /
  world_size`` worlds on its device and steps them with no communication;
* **replay**: each rank keeps its own, fed by its envs and sampled for its
  batch; cursor and size advance alike on every rank;
* **learner**: replicated. Every rank draws the same initial nets (from
  the unfolded key), computes gradients on its own sample and averages
  them with one all-reduce a trained tick (``DQN.train_step_t(...,
  group)``), so every rank applies the same update.

Each rank's tick is the single-card engine's (``train.build_train_step*``)
with the JAX trainer's per-shard key chain (:func:`shard_keys`), and its
chunk a ``train.Chunk`` of that tick, as JAX's is a ``lax.scan`` of it
under ``shard_map``: the ring
engine over B1 (``full_tick_fused_ring``), the fused engine over B3
(``full_tick_fused``) for dense nets and conv nets with ``conv_matmul``,
else over B4 (``tick_fused``) with the conv actor outside the kernel, and
the jnp engine (plain PyTorch over a ``ReplayBuffer``). The kernels launch
per rank at the shard's env count through the same wrappers.

The in-kernel TD learner (B2) applies Adam inside the kernel, with no
point for the all-reduce: it is refused, as the JAX trainer has none.
"""

import math
from typing import Optional

import numpy as np
import torch

from dronerl_tpu_torch import replay, rng as rng_mod, train
from dronerl_tpu_torch.agents.dqn import DQN
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.parallel.mesh import EnvMesh

# The JAX trainer's per-tick split: its width and the order in which a
# single-card tick builder takes the keys (``train.host_keys``).
_SPLITS = {
    "jnp": (5, (0, 1, 2, 3, 4)),   # rand, act, step, sample, reset
    "ring": (2, (0, 1)),           # step, sample
    "full": (5, (0, 1)),           # step, sample of (step, sample, ...)
    "fused": (5, (2, 3, 0, 1, 4)),  # rand, act, step, sample, reset
}


def local_engine(engine: str, agent: DQN) -> str:
    """The single-card engine a rank of the sharded ``engine`` runs: the
    fused engine is the full engine (B3) where the actor runs in the
    kernel (a dense net, or a conv net's im2col chain), else the fused
    engine (B4, the actor outside)."""
    if engine != "fused":
        return engine
    dense = (agent.config.network_type == "dense"
             or agent.net_spec is not None)
    return "full" if dense else "fused"


def shard_keys(rank: int, width: int, order):
    """The JAX sharded trainers' key chain, as a tick builder's ``keys``:
    ``local = fold_in(fold_in(rng, rank), step)``, the keys
    ``split(local, width)[order]``, then ``rng' = fold_in(rng, 1)``. Its
    ``table`` walks a chunk's ticks at once, as ``train.host_keys``'
    does."""
    order = list(order)

    def keys(rng, step):
        local = rng_mod.fold_in(rng_mod.fold_in(rng, rank), step)
        return rng_mod.fold_in(rng, 1), rng_mod.split(local, width)[order]

    def table(rng, length: int, step: int = 0):
        """``length`` ticks' keys from the tick of step ``step``: ``(rng',
        (length, len(order), 2) uint32)``, the chain's key (``fold_in(rng,
        1)`` a tick) hashed tick by tick on Python ints, each tick's fold
        of the rank and its step and its split for every tick at once on
        numpy words."""
        end, chain = rng_mod.chain_words(rng, length, 1)
        steps = (step + np.arange(length, dtype=np.uint64)) & rng_mod.MASK32
        local = rng_mod.threefry_words(chain[:, 0], chain[:, 1], 0, rank)
        local = rng_mod.threefry_words(*local, 0, steps)
        out = np.empty((length, width, 2), dtype=np.uint32)
        for i in range(width):
            out[:, i, 0], out[:, i, 1] = rng_mod.threefry_words(*local, 0, i)
        return end, out[:, order]

    keys.table = table
    return keys


class DistributedTrainer:
    """This rank's shard of a sharded run: its initial carry and its tick.

    ``engine`` is the JAX trainer's: ``"jnp"``, ``"fused"`` or ``"ring"``;
    ``local_engine`` names the single-card engine each rank runs
    (``"full"`` for the fused engine with the actor in the kernel,
    ``"fused"`` with it outside). The agent lives on ``mesh.device``.
    ε decays every ``epsilon_decay_every`` ticks, which the agent must
    set: decay at episode boundaries is not defined across shards.
    """

    def __init__(self, agent: DQN, env_params: EnvParams, mesh: EnvMesh,
                 num_envs: int, buffer_capacity_per_shard: int = 10_000,
                 batch_size_per_shard: int = 8, collect_drones: int = 1,
                 reset_env_every: int = 100, engine: str = "jnp",
                 rng_rounds: int = 20,
                 actor_rng_rounds: Optional[int] = None):
        self.agent = agent
        self.env_params = env_params
        self.mesh = mesh
        self.num_devices = mesh.world_size
        if num_envs % self.num_devices:
            raise ValueError(f"num_envs ({num_envs}) must divide over "
                             f"{self.num_devices} devices")
        if engine not in ("jnp", "fused", "ring"):
            raise ValueError(f"unknown engine {engine!r}")
        if agent.config.epsilon_decay_every is None:
            raise ValueError("sharded training needs epsilon_decay_every "
                             "(episode-boundary ε decay is not defined "
                             "across env shards)")
        if agent.device != mesh.device:
            raise ValueError(f"the agent is on {agent.device}, this rank "
                             f"drives {mesh.device}")
        self.engine = engine
        self.rng_rounds = rng_rounds
        self.actor_rng_rounds = actor_rng_rounds
        self.envs_per_shard = eps = num_envs // self.num_devices
        self.collect_drones = k = collect_drones
        self.reset_env_every = reset_env_every
        self.batch_size = batch_size_per_shard
        # The shard's replay rounded up to whole pushes of eps · k.
        push = eps * k
        capacity = math.ceil(buffer_capacity_per_shard / push) * push
        self.local_engine = local_engine(engine, agent)
        if engine == "ring":
            if batch_size_per_shard % k:
                raise ValueError(
                    "ring engine needs batch_size_per_shard divisible by "
                    "collect_drones (per-drone row-group sampling)")
            if local_engine("fused", agent) != "full":
                raise ValueError(
                    "ring engine runs the actor in-kernel: dense nets, or "
                    "conv nets with conv_matmul=True (--conv_matmul)")
            # Ring columns, each holding k transitions.
            self.ring_capacity = max(
                math.ceil(buffer_capacity_per_shard / push) * eps, 2 * eps)
        elif engine == "fused":
            self.buffer = replay.StreamReplay(
                max(capacity, 2 * push), batch_size_per_shard, stride=push)
        else:
            self.buffer = replay.ReplayBuffer(
                capacity, batch_size_per_shard, uniform_pushes=True)

    def init_carry(self, rng: torch.Tensor, obs_dtype=torch.bfloat16):
        """This rank's initial carry (the single-card engine's layout):
        its envs reset from ``fold_in(rng, rank)``, the learner drawn from
        ``rng`` itself, so every rank holds the same nets. ``obs_dtype``
        is the ring engine's ring only."""
        agent, params = self.agent, self.env_params
        eps, k = self.envs_per_shard, self.collect_drones
        shard_rng = rng_mod.fold_in(rng, self.mesh.rank)
        if self.engine == "ring":
            carry = train.init_ring_carry(
                agent, params, eps, self.ring_capacity, shard_rng,
                obs_dtype=obs_dtype, collect_drones=k)
        elif self.engine == "fused":
            carry = train.init_stream_carry(agent, params, eps, self.buffer,
                                            shard_rng, k)
        else:
            carry = train.init_jnp_carry(agent, params, eps, self.buffer,
                                         shard_rng, k)
        return (rng.cpu(), *carry[1:3], agent.init_state(rng), *carry[4:])

    def build_tick(self):
        """The rank's tick: ``tick(carry) -> (carry, (rewards (eps,),
        epsilon, loss))``, ``loss`` averaged over the ranks (the same on
        each), ``NO_TRAIN_LOSS`` on ticks that do not train."""
        agent, params = self.agent, self.env_params
        eps, k = self.envs_per_shard, self.collect_drones
        width, order = _SPLITS[self.local_engine]
        kw = dict(keys=shard_keys(self.mesh.rank, width, order),
                  group=self.mesh.group)
        if self.local_engine == "ring":
            return train.build_train_step_ring(
                agent, params, eps, self.ring_capacity, self.batch_size,
                self.reset_env_every, k, rng_rounds=self.rng_rounds,
                actor_rng_rounds=self.actor_rng_rounds, **kw)
        if self.local_engine == "full":
            return train.build_train_step_full(
                agent, self.buffer, params, eps, self.reset_env_every, k,
                self.rng_rounds, self.actor_rng_rounds, **kw)
        if self.local_engine == "fused":
            return train.build_train_step_fused(
                agent, self.buffer, params, eps, self.reset_env_every, k,
                self.rng_rounds, **kw)
        return train.build_train_step(agent, self.buffer, params, eps,
                                      self.reset_env_every, k, **kw)

    def build_chunk(self, scan_steps: int):
        """``chunk(carry) -> (carry, (rewards (scan_steps, eps), losses
        (scan_steps,)))``: ``scan_steps`` ticks, the JAX trainer's chunk
        outputs for this rank's shard, run by ``chunk.chunk``, a
        ``train.Chunk`` over :meth:`build_tick` (on a card over NCCL one
        CUDA graph replay a tick, the all-reduce inside; over gloo or on
        the CPU eager rows)."""
        runner = train.Chunk(self.build_tick())

        def chunk(carry):
            carry, (rewards, _, losses) = runner(carry, scan_steps)
            return carry, (rewards, losses)

        chunk.chunk = runner
        return chunk
