"""Shared action / ground-object vocabulary (copy of dronerl_tpu.constants).

The integer values are a public contract shared with the JAX package:
they appear in observations, checkpoints and on-disk grids.
"""

from enum import IntEnum


class Action(IntEnum):
    """Discrete drone actions (grid moves plus hover)."""

    LEFT = 0
    DOWN = 1
    RIGHT = 2
    UP = 3
    STAY = 4

    @classmethod
    def num_actions(cls) -> int:
        return len(cls)


class Object(IntEnum):
    """Ground-layer object codes. 0 encodes an empty cell."""

    SKYSCRAPER = 2
    STATION = 3
    DROPZONE = 4
    PACKET = 5


NUM_ACTIONS: int = Action.num_actions()

# Observation channels: 0 drone, 1 packet (or carried packet at centre),
# 2 dropzone, 3 charging station, 4 charge level in [0, 1], 5 skyscraper
# or out-of-board wall.
NUM_OBS_CHANNELS: int = 6

# Loss reported by ticks that do not train (the TD loss is an MSE, never
# negative, so readers mask with ``loss >= 0``).
NO_TRAIN_LOSS: float = -1.0
