"""Multi-configuration benchmark with a per-phase split (counterpart of
``dronerl_tpu/benchmark.py``).

Sweeps env configurations × drone counts at 256 envs and reports steps/s
for four phases: the env (physics only), the actor (observe and the
ε-greedy forward), the learner (a replay sample and the TD step) and the
full training loop.

The env and actor phases run the plain env core, a few thousand small
operations a tick; on the card each tick is one CUDA graph
(``utils.graphs.Graphed``, the counterpart of the JAX package's jitted
scan), captured before the timed ticks, so the time is the work's and not
the launches'. The learner and the full loop run as the trainers run
them: eagerly, with their host state (the Adam count, the replay's cursor,
the step) between ticks, which a graph would freeze. The full loop is the
fused engine (B4, ``train.build_train_step_fused``) where the fused
kernels take the board, else the jnp engine. Each phase runs warm-up
ticks first and ends its timed ticks with a synchronise.

Run: python -m dronerl_tpu_torch.benchmark [--steps 300] [--device cuda]
"""

import argparse
import math
import subprocess
import time
from typing import Dict

import torch

from dronerl_tpu_torch import replay, resolve_device, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.constants import NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams, EnvState, env_fields
from dronerl_tpu_torch.ops import fused_tick
from dronerl_tpu_torch.utils.graphs import Graphed

CONFIGS: Dict[str, dict] = {
    "DronesOnly": dict(packets_factor=0, dropzones_factor=0,
                       stations_factor=0, skyscrapers_factor=0),
    "Default": dict(),
    "HighDensity": dict(packets_factor=4, dropzones_factor=3,
                        stations_factor=3, skyscrapers_factor=4),
}
DRONE_COUNTS = (4, 16, 64)
NUM_ENVS = 256
WARMUP = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_graphed(tick, carry, steps: int) -> float:
    """Seconds for ``steps`` ticks of a tick on a tuple of tensors: one
    CUDA graph replayed on the card, the eager loop on the CPU."""
    device = carry[0].device
    graphed = Graphed(tick, carry) if device.type == "cuda" else None

    def run():
        nonlocal carry
        if graphed is None:
            carry, _ = tick(carry)
        else:
            graphed.replay()
            graphed.advance()

    return _time_loop(run, steps, device)


def _time_loop(run, steps: int, device: torch.device) -> float:
    for _ in range(WARMUP):
        run()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    _sync(device)
    return time.perf_counter() - t0


def bench_config(name: str, overrides: dict, n_drones: int, steps: int,
                 num_envs: int = NUM_ENVS, device="cuda") -> dict:
    device = resolve_device(device)
    grid = int(math.ceil(math.sqrt(n_drones / 0.05)))
    params = EnvParams(grid_size=grid, n_drones=n_drones, **overrides)
    agent = DQN(DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=5),
                params, device=device)
    key = rng.PRNGKey(0)
    states = env_core.reset_batch(key.to(device), params, num_envs)
    ag_state = agent.init_state(key)

    def tick_env(carry):  # physics only
        r, st = carry[0], EnvState(*carry[1:])
        r, k = rng.split(r, 2)
        a = rng.randint(k, (num_envs, n_drones), 0, NUM_ACTIONS)
        st, rew, _ = env_core.step_batch(rng.split(k, num_envs), st, a,
                                         params)
        return (r, *env_fields(st)), (rew[:, 0],)

    env_t = _time_graphed(tick_env, (key.to(device), *env_fields(states)),
                          steps)

    def observe(st):
        return env_core.observe_batch(st, params, 1).reshape(num_envs,
                                                             agent.obs_dim)

    def tick_act(carry):  # observe + forward
        r, st, obs = carry[0], EnvState(*carry[1:-1]), carry[-1]
        r, k = rng.split(r, 2)
        acts = agent.act(k, obs, ag_state)
        return (r, *env_fields(st), observe(st)), (acts[0],)

    act_t = _time_graphed(
        tick_act, (key.to(device), *env_fields(states), observe(states)),
        steps)

    # learner: sample + TD step on a warm buffer
    buffer = replay.ReplayBuffer(capacity=4096, batch_size=64)
    zeros = torch.zeros((agent.obs_dim,))
    bstate = buffer.init({
        "obs": zeros, "actions": torch.zeros((), dtype=torch.int32),
        "rewards": torch.zeros(()), "next_obs": zeros,
        "dones": torch.zeros((), dtype=torch.bool)}, device=device)
    ones = torch.ones((4096, agent.obs_dim), device=device)
    bstate = buffer.push_many(bstate, {
        "obs": ones, "actions": torch.zeros(4096, dtype=torch.int32),
        "rewards": torch.zeros(4096), "next_obs": ones,
        "dones": torch.zeros(4096, dtype=torch.bool)})
    learn_key = key

    def learn():
        nonlocal learn_key
        learn_key, k = rng.split(learn_key, 2)
        batch = buffer.sample(k, bstate)
        batch["dones"] = batch["dones"].to(torch.float32)
        agent.train_step(ag_state, batch)

    learn_t = _time_loop(learn, steps, device)

    # the full training loop: the fused engine where its kernels take the
    # board, else the jnp engine
    capacity = -(-10_000 // num_envs) * num_envs
    if not train.fused_engine_problems(params, num_envs):
        sbuf = replay.StreamReplay(max(capacity, 2 * num_envs), 64,
                                   stride=num_envs)
        full_tick = train.build_train_step_fused(agent, sbuf, params,
                                                 num_envs, 100)
        carry = train.init_stream_carry(agent, params, num_envs, sbuf, key)
        if device.type == "cuda":
            fused_tick.prepare_kernel(params, env_tick=True)
    else:
        full_buffer = replay.ReplayBuffer(capacity, 64, uniform_pushes=True)
        full_tick = train.build_train_step(agent, full_buffer, params,
                                           num_envs, 100)
        carry = train.init_jnp_carry(agent, params, num_envs, full_buffer,
                                     key)

    def full():
        nonlocal carry
        carry, _ = full_tick(carry)

    full_t = _time_loop(full, steps, device)

    total_obs = num_envs * steps
    return {
        "config": name,
        "n_drones": n_drones,
        "grid": grid,
        "env_steps_per_s": total_obs / env_t,
        "act_steps_per_s": total_obs / act_t,
        "learn_steps_per_s": steps / learn_t,
        "fused_obs_per_s": total_obs / full_t,
    }


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CPU: "cpu")."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--num_envs", type=int, default=NUM_ENVS)
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS))
    parser.add_argument("--drone_counts", nargs="+", type=int,
                        default=list(DRONE_COUNTS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    print(f"device: {device_line(device)}")
    header = (f"{'config':<12} {'drones':>6} {'grid':>5} {'env/s':>14} "
              f"{'act/s':>14} {'learn it/s':>11} {'fused obs/s':>14}")
    print(header)
    print("-" * len(header))
    rows = []
    for name in args.configs:
        for n in args.drone_counts:
            row = bench_config(name, CONFIGS[name], n, args.steps,
                               args.num_envs, device)
            rows.append(row)
            print(f"{row['config']:<12} {row['n_drones']:>6} "
                  f"{row['grid']:>5} {row['env_steps_per_s']:>14,.0f} "
                  f"{row['act_steps_per_s']:>14,.0f} "
                  f"{row['learn_steps_per_s']:>11,.0f} "
                  f"{row['fused_obs_per_s']:>14,.0f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
