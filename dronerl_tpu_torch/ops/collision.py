"""Same-destination-cell conflict detection (batched).

The predicate "does any other drone target my exact cell" on raw,
possibly off-board coordinates, as in ``dronerl_tpu/ops/collision.py``.
"""

import torch


def same_cell_conflicts(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(E, N) bool: True where ≥2 drones of an env target the same cell."""
    same = (xs[:, :, None] == xs[:, None, :]) & (ys[:, :, None] == ys[:, None, :])
    return same.sum(dim=2) > 1
