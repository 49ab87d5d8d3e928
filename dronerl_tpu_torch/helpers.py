"""Workshop / notebook helpers: imperative multi-agent training and plots
(counterpart of ``dronerl_tpu/helpers.py``).

Seed control, host-side agents, a multi-agent train/eval loop over the
gym-style env (:class:`env.gymapi.DeliveryDronesEnv`) and reward plots.
They exist for interactive exploration; production training is the
trainer in :mod:`dronerl_tpu_torch.train`. The plots import matplotlib
where they are called, and say so where it is not installed.
"""

import random
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from dronerl_tpu_torch.constants import NUM_ACTIONS
from dronerl_tpu_torch.env.gymapi import DeliveryDronesEnv


def set_seed(seed: int = 0) -> None:
    """Seed the host's RNGs (the env itself is keyed per reset)."""
    np.random.seed(seed)
    random.seed(seed)


class HostAgent:
    """Interface for imperative per-drone agents."""

    def act(self, obs: np.ndarray) -> int:
        raise NotImplementedError

    def learn(self, obs, action, reward, next_obs, done) -> None:
        pass

    def reset(self) -> None:
        pass


class RandomHostAgent(HostAgent):
    def act(self, obs) -> int:
        return int(np.random.randint(0, NUM_ACTIONS))


class CheckpointAgent(HostAgent):
    """Greedy policy from a safetensors checkpoint (either format), on the
    env's device unless ``device`` is given."""

    def __init__(self, path: str, env: DeliveryDronesEnv, device=None):
        from dronerl_tpu_torch.agents.dqn import DQN

        self.agent, self.params = DQN.restore(path, env.params,
                                              device or env.device)

    def act(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                              device=self.agent.device)
        with torch.no_grad():
            q = self.agent.q_values(self.params, obs[None])
        return int(q.argmax())


class MultiAgentTrainer:
    """Step all agents in a shared env, letting each learn independently."""

    def __init__(self, env: DeliveryDronesEnv, agents: Dict[int, HostAgent],
                 reset_agents: bool = True, seed: Optional[int] = None):
        self.env = env
        self.agents = agents
        self.rewards_log = defaultdict(list)
        if seed is not None:
            set_seed(seed)
        self.obs, _ = env.reset(seed=seed or 0)
        if reset_agents:
            for agent in agents.values():
                agent.reset()

    def train(self, n_steps: int) -> None:
        for _ in range(n_steps):
            actions = {i: agent.act(self.obs[i])
                       for i, agent in self.agents.items()}
            next_obs, rewards, dones, _, _ = self.env.step(actions)
            for i, agent in self.agents.items():
                agent.learn(self.obs[i], actions[i], rewards[i],
                            next_obs[i], dones[i])
                self.rewards_log[i].append(rewards[i])
            self.obs = next_obs


def test_agents(env: DeliveryDronesEnv, agents: Dict[int, HostAgent],
                n_steps: int = 1000, seed: int = 0) -> Dict[int, list]:
    """Greedy evaluation run; returns per-agent reward lists."""
    rewards_log = defaultdict(list)
    obs, _ = env.reset(seed=seed)
    for _ in range(n_steps):
        actions = {i: agent.act(obs[i]) for i, agent in agents.items()}
        obs, rewards, _, _, _ = env.step(actions)
        for i, reward in rewards.items():
            rewards_log[i].append(reward)
    return dict(rewards_log)



def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as err:
        raise ImportError("the reward plots need matplotlib, which is not "
                          "installed here") from err
    return plt


def plot_cumulative_rewards(rewards_log: Dict[int, list],
                            drone_ids=None, ax=None):
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    for i, rewards in sorted(rewards_log.items()):
        if drone_ids is not None and i not in drone_ids:
            continue
        ax.plot(np.cumsum(rewards), label=f"drone {i}")
    ax.set_xlabel("step")
    ax.set_ylabel("cumulative reward")
    ax.legend()
    return ax


def plot_rolling_rewards(rewards_log: Dict[int, list], window: int = 250,
                         drone_ids=None, ax=None):
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    kernel = np.ones(window) / window
    for i, rewards in sorted(rewards_log.items()):
        if drone_ids is not None and i not in drone_ids:
            continue
        smoothed = np.convolve(np.asarray(rewards), kernel, mode="valid")
        ax.plot(smoothed, label=f"drone {i}")
    ax.set_xlabel("step")
    ax.set_ylabel(f"rolling mean reward (w={window})")
    ax.legend()
    return ax
