"""DQN training on the ring engine (counterpart of ``dronerl_tpu/train.py``).

One tick: split the host key three ways; one launch of the fused tick
kernel (the whole env side: actor, physics, respawns, observation, the
periodic reset, the write of the next observation into the replay ring);
the scalar-ring writes; a uniform replay sample off the ring; the TD(0)
Adam step; the target and ε schedules. The replay ring IS the kernel's
observation buffer, written in place.

With ``in_kernel_td`` the TD(0) + Adam step is one launch of the learner
kernel right after the tick kernel's, on the batch gathered after the
tick before (carried in the carry's ``aux`` slot), as the JAX trainer's
in-kernel TD path pipelines it; the default is the PyTorch learner
(``DQN.train_step_t``), as in the JAX trainer.

The step counter, the ring slot arithmetic, the reset flag, the count of
valid columns and the rng chain stay on the host: they are a few scalar
hashes a tick, and reading them back from the device every tick would
serialise the loop. The key words reach the kernel as launch arguments.

Run:  python -m dronerl_tpu_torch.train --num_envs 65536 --num_steps 300
"""

import argparse
import functools
import logging
import math
import sys
import time
from typing import Optional

import torch

from dronerl_tpu_torch import resolve_device, rng as rng_mod
from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DQN, DQNConfig)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import fused_tick

logger = logging.getLogger("dronerl_tpu_torch.train")


def build_train_step_ring(agent: DQN, env_params: EnvParams, num_envs: int,
                          capacity: int, batch_size: int,
                          reset_env_every: int, collect_drones: int = 1,
                          in_kernel_td: Optional[bool] = None):
    """The ring-engine tick: ``tick(carry) -> (carry, (rewards (E,),
    epsilon, loss))``, with the JAX trainer's carry layout ``(rng,
    (tstate, ring), (a_ring, r_ring, d_ring), ag_state, aux, step)``.

    ``loss`` is ``NO_TRAIN_LOSS`` on ticks where the ring holds fewer
    than ``batch_size`` complete transitions. With ``in_kernel_td`` (pass
    the same to :func:`init_ring_carry`) the learner kernel trains inside
    tick t+1 on the batch gathered after tick t, carried in ``aux``;
    tick 0 never trains.
    """
    if collect_drones != 1:
        raise NotImplementedError("collect_drones > 1 is not ported yet")
    if capacity % num_envs != 0 or capacity < 2 * num_envs:
        raise ValueError("capacity must be a multiple of num_envs, >= 2x")
    nb = capacity // num_envs  # ring length in ticks
    device = agent.device
    td_hparams = None
    if in_kernel_td:  # the port's nets are dense, as the TD path needs
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
        args = (step_key, tstate, ring, read_slot, write_slot,
                ag_state.params, ag_state.epsilon,
                step % reset_env_every == 0, env_params)
        if td_hparams is not None:
            # The carried batch was gathered after the tick before with
            # valid = min(step, nb-1) columns (zero-seeded at step 0,
            # which never trains).
            can_train = min(step, nb - 1) * num_envs >= batch_size
            adam = ag_state.opt_state
            tstate, rewards_t, dones_t, actions_t, ring, _, _, _, loss = (
                fused_tick.full_tick_fused_ring(
                    *args, td_hparams=td_hparams, td_batch=aux,
                    td_aux=(ag_state.target_params, adam.mu, adam.nu,
                            can_train, adam.count)))
            if can_train:
                adam.count += 1
        else:
            tstate, rewards_t, dones_t, actions_t, ring = (
                fused_tick.full_tick_fused_ring(*args))

        # Scalars live at the same slot as this tick's input observation.
        a_ring, r_ring, d_ring = fused_tick.ring_scalar_writes(
            a_ring, r_ring, d_ring, actions_t, rewards_t, dones_t, read_slot)

        # Complete tuples after tick t: steps [max(0, t+2-nb), t].
        valid = min(step + 1, nb - 1) * num_envs
        if td_hparams is not None or valid >= batch_size:
            batch = fused_tick.ring_gather_batch(
                sample_key, ring, a_ring, r_ring, d_ring, valid,
                max(0, step + 2 - nb), num_envs=num_envs, capacity=capacity,
                batch_size=batch_size)
        if td_hparams is not None:
            aux = batch  # trained on inside the next tick
        elif valid >= batch_size:
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
                    generator: Optional[torch.Generator] = None,
                    batch_size: Optional[int] = None,
                    in_kernel_td: Optional[bool] = None):
    """Initial carry for :func:`build_train_step_ring`: envs reset with
    ``rng``, the ring seeded with their observation at slot 0, a fresh
    agent from ``generator`` (default: seeded from the key's words).

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
    if generator is None:
        k0, k1 = (int(v) for v in rng.tolist())
        generator = torch.Generator().manual_seed((k0 << 32) | k1)
    env_states = env_core.reset_batch(rng.to(device), env_params, num_envs)
    tstate = fused_tick.to_tstate(env_states)
    obs0 = env_core.observe_batch(env_states, env_params, 1).reshape(
        num_envs, agent.obs_dim).t()
    ring = torch.zeros((agent.obs_dim, capacity), dtype=obs_dtype,
                       device=device)
    ring[:, :num_envs] = obs0.to(obs_dtype)
    return (
        rng.cpu(), (tstate, ring),
        (torch.zeros(capacity, dtype=torch.int32, device=device),
         torch.zeros(capacity, dtype=torch.float32, device=device),
         torch.zeros(capacity, dtype=torch.int8, device=device)),
        agent.init_state(generator), aux, 0,
    )


# --- CLI ---------------------------------------------------------------------

def env_params_from_args(args) -> EnvParams:
    return EnvParams(
        n_drones=args.n_drones,
        grid_size=args.grid_size,
        window_radius=args.window_radius,
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
        hidden_layers=tuple(args.hidden_layers),
        target_update_interval=args.target_update_interval,
        epsilon_start=args.epsilon_start,
        epsilon_decay=eps_decay,
        epsilon_end=args.epsilon_end,
        epsilon_decay_every=args.epsilon_decay_every,
        gamma=args.gamma,
        learning_rate=args.learning_rate,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Ring-engine DQN training (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # env
    p.add_argument("--n_drones", type=int, default=4)
    p.add_argument("--grid_size", type=int, default=9)
    p.add_argument("--window_radius", type=int, default=3)
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
    p.add_argument("--hidden_layers", nargs="+", type=int, default=(16, 16))
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
    p.add_argument("--ring_obs_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel) or cpu (the plain PyTorch path)")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        raise SystemExit(
            "not supported by the PyTorch port yet (only the ring engine "
            "with dense nets and collect_drones=1 is ported): "
            + " ".join(unknown))
    if args.num_envs <= 0:
        raise ValueError("num_envs must be >= 1")
    if args.num_steps <= 0:
        raise ValueError("num_steps must be >= 1")
    return args


def train(args) -> dict:
    device = resolve_device(args.device)
    env_params = env_params_from_args(args)
    env_params.validate()
    agent = DQN(agent_config_from_args(args), env_params, device=device)
    num_envs = args.num_envs
    capacity = math.ceil(args.memory_size / num_envs) * num_envs
    ring_capacity = max(capacity, 2 * num_envs)
    obs_dtype = getattr(torch, args.ring_obs_dtype)
    logger.info("env %s | agent %s | %d envs, ring %d columns (%s) on %s",
                env_params, agent.config, num_envs, ring_capacity,
                args.ring_obs_dtype, device)

    tick = build_train_step_ring(
        agent, env_params, num_envs, ring_capacity, args.batch_size,
        args.reset_env_every)
    carry = init_ring_carry(agent, env_params, num_envs, ring_capacity,
                            rng_mod.PRNGKey(args.seed), obs_dtype=obs_dtype)
    if device.type == "cuda":
        t0 = time.perf_counter()
        fused_tick.prepare_kernel(env_params, carry[3].params)
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
        "obs_per_sec": num_envs * args.num_steps / elapsed,
        "time_taken": elapsed,
        "last_reward_mean": mean_reward,
        "epsilon": float(epsilon),
        "td_loss_mean": float(trained.mean()) if len(trained) else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    logger.info("Trained %s steps × %s envs in %.2fs → %s obs/s on %s",
                f"{args.num_steps:,}", f"{num_envs:,}", elapsed,
                f"{metrics['obs_per_sec']:,.0f}", metrics["device"])
    return metrics


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)-5.5s] [%(name)-12.12s]: %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
