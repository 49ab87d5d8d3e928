"""Uniform-random policy (baseline opponent and exploration source;
counterpart of ``dronerl_tpu/agents/random_agent.py``)."""

import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.constants import NUM_ACTIONS


def random_actions(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Uniform random actions of the given shape (``jax.random.randint(key,
    shape, 0, NUM_ACTIONS)``), int32, where ``key`` lies."""
    return rng.randint(key, shape, 0, NUM_ACTIONS)
