"""Imperative gym-style façade over the env core (counterpart of
``dronerl_tpu/env/gymapi.py``).

The reference's gym ``Env`` surface, with dict observations: reset and
step one world, whose state lives on an explicit device (the card by
default, the CPU when asked for) and steps through the port's env core.
No gym dependency. ``drone_density`` sizes the grid as ``ceil(sqrt(n /
density))`` unless ``grid_size`` is given. Two observation wrappers:
``windowed_view`` (``"window"``, egocentric crops) and ``grid_view``
(``"global"`` or ``"grid"``, the whole board).

The key chain is the JAX façade's, on host keys: ``reset(seed)`` splits
``PRNGKey(seed)`` once, each step splits it again, so a seed gives the JAX
façade's observations and rewards.
"""

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dronerl_tpu_torch import resolve_device, rng
from dronerl_tpu_torch.constants import Action, NUM_ACTIONS
from dronerl_tpu_torch.env import core as env_core
from dronerl_tpu_torch.env.types import EnvParams

DEFAULT_CONFIG = {
    "drone_density": 0.05,
    "n_drones": 3,
    "pickup_reward": 0.0,
    "delivery_reward": 1.0,
    "crash_reward": -1.0,
    "charge_reward": -0.1,
    "discharge": 10,
    "charge": 20,
    "packets_factor": 3,
    "dropzones_factor": 2,
    "stations_factor": 2,
    "skyscrapers_factor": 3,
}


class DeliveryDronesEnv:
    """One world with dict-based multi-agent IO on ``device``."""

    NUM_ACTIONS = NUM_ACTIONS

    def __init__(self, env_params: Optional[dict] = None,
                 wrapper: str = "window", radius: int = 3, device="cuda"):
        config = dict(DEFAULT_CONFIG)
        config.update(env_params or {})
        n = config["n_drones"]
        grid_size = config.get("grid_size")
        if grid_size is None:
            grid_size = int(math.ceil(math.sqrt(n / config["drone_density"])))
        self.params = EnvParams(
            grid_size=grid_size,
            n_drones=n,
            pickup_reward=config["pickup_reward"],
            delivery_reward=config["delivery_reward"],
            crash_reward=config["crash_reward"],
            charge_reward=config["charge_reward"],
            discharge=config["discharge"],
            charge=config["charge"],
            packets_factor=config["packets_factor"],
            dropzones_factor=config["dropzones_factor"],
            stations_factor=config["stations_factor"],
            skyscrapers_factor=config["skyscrapers_factor"],
            wrapper="global" if wrapper in ("global", "grid") else "window",
            window_radius=radius,
        )
        self.n_drones = n
        self.side_size = grid_size
        self.device = resolve_device(device)
        self._state = None
        self._rng = None

    @property
    def observation_shape(self) -> Tuple[int, int, int]:
        return self.params.obs_shape

    def _next_key(self) -> torch.Tensor:
        self._rng, key = rng.split(self._rng, 2)
        return key.to(self.device)

    def reset(self, seed: int = 0) -> Tuple[Dict[int, np.ndarray], None]:
        self._rng = rng.PRNGKey(seed)
        self._state = env_core.reset(self._next_key(), self.params)
        return self._observations(), None

    def step(self, actions: Dict[int, int]):
        """gym 0.26-style step: (obs, rewards, dones, truncated, info);
        drones without an action stay."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        acts = torch.full((self.n_drones,), int(Action.STAY),
                          dtype=torch.int32)
        for idx, a in actions.items():
            acts[int(idx)] = int(a)
        self._state, rewards, dones = env_core.step(
            self._next_key(), self._state, acts.to(self.device), self.params)
        rewards, dones = rewards.cpu().numpy(), dones.cpu().numpy()
        return (
            self._observations(),
            {i: float(rewards[i]) for i in range(self.n_drones)},
            {i: bool(dones[i]) for i in range(self.n_drones)},
            False,
            {},
        )

    def _observations(self) -> Dict[int, np.ndarray]:
        obs = env_core.observe(self._state, self.params).cpu().numpy()
        return {i: obs[i] for i in range(self.n_drones)}

    @property
    def state(self):
        """The underlying ``EnvState`` (tensors on the env's device)."""
        return self._state

    def render(self, mode: str = "ansi") -> str:
        from dronerl_tpu_torch.env.debug import board_string

        return board_string(self._state)

    def format_actions(self, actions: Dict[int, int]) -> Dict[int, str]:
        from dronerl_tpu_torch.env.debug import ACTION_GLYPHS

        return {d: ACTION_GLYPHS[i] for d, i in actions.items()}
