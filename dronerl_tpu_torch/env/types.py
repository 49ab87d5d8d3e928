"""Environment parameter and state containers.

``EnvParams`` has the same fields, properties and ``validate()`` as
``dronerl_tpu.env.types.EnvParams``; it is a frozen, hashable dataclass.
``EnvState`` holds the batched state tensors with the JAX package's
dtypes and a leading env axis: ground int8 (E, G, G) indexed
``[env, y, x]``, air_x / air_y int32 (E, N), carrying_package bool
(E, N), charge float32 (E, N).
"""

from dataclasses import dataclass
from typing import Literal

import torch

from dronerl_tpu_torch.constants import NUM_OBS_CHANNELS


@dataclass(frozen=True)
class EnvParams:
    """Static environment configuration.

    Object counts are per-drone factors: the grid holds
    ``packets_factor * n_drones`` packets at all times.
    """

    grid_size: int = 8
    n_drones: int = 3
    pickup_reward: float = 0.0
    delivery_reward: float = 1.0
    crash_reward: float = -1.0
    charge_reward: float = -0.1
    discharge: int = 10
    charge: int = 20
    packets_factor: int = 3
    dropzones_factor: int = 2
    stations_factor: int = 2
    skyscrapers_factor: int = 3
    wrapper: Literal["window", "global", "compass"] = "window"
    window_radius: int = 3

    @property
    def num_packets(self) -> int:
        return self.packets_factor * self.n_drones

    @property
    def num_dropzones(self) -> int:
        return self.dropzones_factor * self.n_drones

    @property
    def num_stations(self) -> int:
        return self.stations_factor * self.n_drones

    @property
    def num_skyscrapers(self) -> int:
        return self.skyscrapers_factor * self.n_drones

    @property
    def num_cells(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def window_size(self) -> int:
        return 2 * self.window_radius + 1

    @property
    def obs_shape(self):
        if self.wrapper == "global":
            return (self.grid_size, self.grid_size, NUM_OBS_CHANNELS)
        return (self.window_size, self.window_size, NUM_OBS_CHANNELS)

    def validate(self) -> None:
        """Raise if the configured objects cannot fit on the grid."""
        total = (
            self.num_packets
            + self.num_dropzones
            + self.num_stations
            + self.num_skyscrapers
        )
        if total > self.num_cells:
            raise ValueError(
                f"Grid has {self.num_cells:,} cells but {total:,} ground objects "
                f"({self.num_packets:,} packets, {self.num_dropzones:,} dropzones, "
                f"{self.num_stations:,} stations, {self.num_skyscrapers:,} skyscrapers) "
                "were requested."
            )
        if self.n_drones > self.num_cells:
            raise ValueError(
                f"Grid has {self.num_cells:,} cells but {self.n_drones:,} drones "
                "were requested."
            )


@dataclass(frozen=True)
class EnvState:
    """Batched structure-of-arrays environment state (leading env axis)."""

    ground: torch.Tensor            # int8 (E, G, G), [env, y, x]
    air_x: torch.Tensor             # int32 (E, N) column coordinates
    air_y: torch.Tensor             # int32 (E, N) row coordinates
    carrying_package: torch.Tensor  # bool (E, N)
    charge: torch.Tensor            # float32 (E, N) battery in [0, 100]
