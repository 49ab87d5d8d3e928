"""Fixed-shape random placement (batched): top-k of masked uniform scores.

Each env draws one uniform score per cell, occupied cells score -inf,
and the k best cells in ``jax.lax.top_k`` order take the k fill values.
``top_k``'s order is descending score with ties to the LOWEST index; the
-inf tail therefore follows in ascending index order. A stable
descending ``torch.sort`` gives exactly that order (``torch.topk``
promises no tie order). A slot whose fill is 0 still claims its cell,
which erases an occupied cell when fewer than k cells are vacant.

Quirks kept for bit parity with ``dronerl_tpu/env/spawn.py``:

* ``place_in_air`` marks occupancy at ``[x, y]`` (transposed against the
  grid's ``[y, x]``), decodes candidate cell c as ``x = c // G,
  y = c % G``, and dead-drone sentinels of -1 wrap to the last row and
  column.
* the dropzone respawn reuses the packet respawn's key
  (:func:`respawn_ground_pair`).
"""

from typing import Tuple

import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops.pointops import place_values, wrap_clamp


def top_k_cells(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(E, C) scores → (E, k) cell indices in ``lax.top_k`` order."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def _masked(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, u, torch.full_like(u, float("-inf")))


def place_on_ground(
    key: torch.Tensor,
    ground: torch.Tensor,
    fill_values: torch.Tensor,
    params: EnvParams,
    rounds: int = 20,
) -> torch.Tensor:
    """Write ``fill_values`` (E, k) onto the top-k vacant cells of
    ``ground`` (E, G, G), one key (E, 2) per env; the scores from
    Threefry-2x32-``rounds``."""
    e = ground.shape[0]
    vacant = ground == 0
    u = rng.uniform(key, (params.num_cells,), rounds)
    cells = top_k_cells(_masked(u, vacant.reshape(e, -1)), fill_values.shape[1])
    g = params.grid_size
    return place_values(ground, cells // g, cells % g, fill_values)


def respawn_ground_pair(
    key: torch.Tensor,
    ground: torch.Tensor,
    fill_packets: torch.Tensor,
    fill_dropzones: torch.Tensor,
    consumed: torch.Tensor,
    params: EnvParams,
    rounds: int = 20,
) -> torch.Tensor:
    """Packet spawn, clear of delivered dropzones, dropzone spawn — both
    spawns from the SAME key (the reference env's quirk)."""
    ground = place_on_ground(key, ground, fill_packets, params, rounds)
    ground = torch.where(consumed, torch.zeros_like(ground), ground)
    return place_on_ground(key, ground, fill_dropzones, params, rounds)


def place_in_air(
    key: torch.Tensor,
    air_x: torch.Tensor,
    air_y: torch.Tensor,
    params: EnvParams,
    exclude: torch.Tensor,
    rounds: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Give drones at the -1 sentinel fresh cells; live drones stay.

    Candidates avoid the cells claimed by the transposed, -1-wrapped
    occupancy write and the ``exclude`` mask (E, G, G) (skyscrapers).
    """
    g, c = params.grid_size, params.num_cells
    e = air_x.shape[0]
    occ = wrap_clamp(air_x, g).long() * g + wrap_clamp(air_y, g).long()
    cells_iota = torch.arange(c, device=air_x.device)
    occupied = (occ[:, :, None] == cells_iota).any(dim=1)
    open_cells = ~occupied & ~exclude.reshape(e, -1)
    u = rng.uniform(key, (c,), rounds)
    cells = top_k_cells(_masked(u, open_cells), params.n_drones).to(torch.int32)
    new_x = torch.where(air_x == -1, cells // g, air_x)
    new_y = torch.where(air_y == -1, cells % g, air_y)
    return new_x, new_y
