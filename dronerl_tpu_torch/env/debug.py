"""Human-readable board and action printers for debugging sessions
(counterpart of ``dronerl_tpu/env/debug.py``). Host-side only: the state's
tensors are copied to the CPU first."""

import numpy as np
import torch

from dronerl_tpu_torch.constants import Object
from dronerl_tpu_torch.env.types import EnvState

ACTION_GLYPHS = ["←", "↓", "→", "↑", "X"]

_TILE_GLYPHS = {
    0: "⬜",
    Object.SKYSCRAPER.value: "🏢",
    Object.STATION.value: "🔌",
    Object.DROPZONE.value: "📍",
    Object.PACKET.value: "📦",
}


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def format_actions(actions) -> list:
    """Map integer actions to arrow glyphs."""
    return [ACTION_GLYPHS[int(a)] for a in _host(actions)]


def board_string(state: EnvState) -> str:
    """One env's ground grid plus drones as an emoji board."""
    board = _host(state.ground)
    air_x, air_y = _host(state.air_x), _host(state.air_y)
    carrying = _host(state.carrying_package)
    drone_at = {(int(y), int(x)): i for i, (x, y) in enumerate(zip(air_x,
                                                                   air_y))}
    lines = []
    for y in range(board.shape[0]):
        row = []
        for x in range(board.shape[1]):
            if (y, x) in drone_at:
                i = drone_at[(y, x)]
                row.append(f"📦{i}" if carrying[i] else f"P{i}")
            else:
                row.append(_TILE_GLYPHS.get(int(board[y, x]), "❓"))
        lines.append(" ".join(row))
    return "\n".join(lines)


def print_board(state: EnvState) -> None:
    print(board_string(state))
