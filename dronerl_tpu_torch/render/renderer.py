"""PIL frame renderer for episode visualization (counterpart of
``dronerl_tpu/render/renderer.py``; the same frames, byte for byte).

PIL is imported where a frame is drawn, not with the module: the port
runs without it, and rendering without it raises.

Consumes plain host numpy SoA state (the same arrays that live on device:
ground grid, drone coordinates, cargo flags, charge, rewards, actions), so
it is agnostic to where the rollout ran — mirror of the reference renderer
capability (reference: common/render.py:18-306) with procedurally drawn
tiles instead of a sprite sheet, PIL's built-in font, and drone motion
traces.

Layout per frame: board grid | side panel (players + cumulative rewards +
step counter) with a legend strip at the bottom.
"""

from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from dronerl_tpu_torch.constants import Action, Object

TILE = 16
PAD = 4

DRONE_COLORS = [
    (66, 135, 245),   # blue
    (80, 200, 120),   # green
    (235, 64, 52),    # red
    (255, 200, 40),   # yellow
    (170, 90, 240),   # purple
    (255, 140, 0),    # orange
]

_BG = (12, 12, 20)
_PANEL_BG = (173, 216, 230)


def _base_tile(color=_BG):
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (TILE, TILE), color)
    d = ImageDraw.Draw(img)
    d.rectangle((0, 0, TILE - 1, TILE - 1), outline=(40, 40, 55))
    return img


def _skyscraper_tile():
    from PIL import ImageDraw

    img = _base_tile()
    d = ImageDraw.Draw(img)
    d.rectangle((3, 2, 12, 14), fill=(90, 90, 105))
    for y in (4, 7, 10):
        for x in (5, 8, 11):
            d.rectangle((x, y, x, y), fill=(230, 230, 160))
    return img


def _station_tile():
    from PIL import ImageDraw

    img = _base_tile()
    d = ImageDraw.Draw(img)
    d.polygon([(8, 2), (5, 9), (8, 9), (6, 14), (11, 6), (8, 6), (10, 2)],
              fill=(255, 210, 40))
    return img


def _dropzone_tile():
    from PIL import ImageDraw

    img = _base_tile()
    d = ImageDraw.Draw(img)
    d.ellipse((2, 2, 13, 13), outline=(240, 80, 80), width=2)
    d.ellipse((6, 6, 9, 9), fill=(240, 80, 80))
    return img


def _packet_tile():
    from PIL import ImageDraw

    img = _base_tile()
    d = ImageDraw.Draw(img)
    d.rectangle((4, 5, 11, 12), fill=(160, 110, 60), outline=(100, 65, 30))
    d.line((4, 8, 11, 8), fill=(220, 190, 140))
    d.line((7, 5, 7, 12), fill=(220, 190, 140))
    return img


def _drone_tile(color, orientation: int):
    """Triangle pointing along the last move direction."""
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (TILE, TILE), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    shapes = {
        int(Action.RIGHT): [(3, 3), (3, 12), (13, 8)],
        int(Action.LEFT): [(13, 3), (13, 12), (3, 8)],
        int(Action.UP): [(3, 13), (12, 13), (8, 3)],
        int(Action.DOWN): [(3, 3), (12, 3), (8, 13)],
        int(Action.STAY): [(3, 3), (3, 12), (13, 8)],
    }
    d.polygon(shapes[orientation], fill=color, outline=(240, 240, 240))
    return img


class Renderer:
    """Stateful frame renderer (tracks orientation, traces, reward sums)."""

    def __init__(
        self,
        n_drones: int,
        grid_size: int,
        player_name_mappings: Optional[Dict[int, str]] = None,
        resolution_scale_factor: float = 1.0,
        trace_length: int = 0,
        trace_drone_ids_only: Tuple[int, ...] = (0,),
        image_format: str = "png",
    ):
        self.n_drones = n_drones
        self.grid_size = grid_size
        self.player_names = player_name_mappings or {}
        self.scale = resolution_scale_factor
        self.image_format = image_format
        self.trace_length = trace_length
        self.trace_drone_ids_only = trace_drone_ids_only
        self.is_initialized = False

    def init(self) -> None:
        from PIL import ImageFont

        self.font = ImageFont.load_default()
        self.orientation = [int(Action.RIGHT)] * self.n_drones
        self.cum_rewards = np.zeros(self.n_drones, dtype=np.float32)
        self.step = 0
        self.traces = [deque(maxlen=max(1, self.trace_length))
                       for _ in range(self.n_drones)]
        self.tiles = {
            Object.SKYSCRAPER.value: _skyscraper_tile(),
            Object.STATION.value: _station_tile(),
            Object.DROPZONE.value: _dropzone_tile(),
            Object.PACKET.value: _packet_tile(),
            0: _base_tile(),
        }
        board_px = self.grid_size * TILE + (self.grid_size + 1) * PAD
        self.board_px = board_px
        self.panel_w = 130
        self.legend_h = 20
        self.is_initialized = True

    # ------------------------------------------------------------------

    def _cell_origin(self, row: int, col: int) -> Tuple[int, int]:
        return (col * TILE + (col + 1) * PAD, row * TILE + (row + 1) * PAD)

    def render_frame(
        self,
        ground: np.ndarray,
        air_x: np.ndarray,
        air_y: np.ndarray,
        carrying_package: np.ndarray,
        charge: np.ndarray,
        rewards: np.ndarray,
        actions: np.ndarray,
    ):
        """Draw one frame (a PIL image). All inputs are host numpy arrays.

        ``ground``: (G, G) int object codes; ``air_x/air_y``: (N,) drone
        coordinates; ``rewards``/``actions``: (N,).
        """
        if not self.is_initialized:
            raise RuntimeError("call Renderer.init() before render_frame()")
        from PIL import Image, ImageDraw

        frame = Image.new(
            "RGB", (self.board_px + self.panel_w,
                    self.board_px + self.legend_h), _BG)
        draw = ImageDraw.Draw(frame)

        # ground layer
        for row in range(self.grid_size):
            for col in range(self.grid_size):
                tile = self.tiles.get(int(ground[row, col]), self.tiles[0])
                frame.paste(tile, self._cell_origin(row, col))

        # traces
        if self.trace_length > 0:
            for i in self.trace_drone_ids_only:
                for (ty, tx) in self.traces[i]:
                    x0, y0 = self._cell_origin(ty, tx)
                    draw.rectangle((x0, y0, x0 + TILE - 1, y0 + TILE - 1),
                                   outline=(127, 127, 255))

        # drones
        for i in range(self.n_drones):
            col, row = int(air_x[i]), int(air_y[i])
            if not (0 <= col < self.grid_size and 0 <= row < self.grid_size):
                continue
            if int(actions[i]) != int(Action.STAY):
                self.orientation[i] = int(actions[i])
            color = DRONE_COLORS[i % len(DRONE_COLORS)]
            sprite = _drone_tile(color, self.orientation[i])
            x0, y0 = self._cell_origin(row, col)
            frame.paste(sprite, (x0, y0), sprite)
            if carrying_package[i]:
                draw.rectangle((x0 + 10, y0 + 10, x0 + 14, y0 + 14),
                               fill=(160, 110, 60), outline=(100, 65, 30))
            if int(ground[row, col]) == Object.STATION.value:
                draw.rectangle((x0, y0, x0 + TILE - 1, y0 + TILE - 1),
                               outline=(255, 210, 40))
            # charge bar
            level = max(0, min(10, int(charge[i]) // 10))
            draw.rectangle((x0 + 2, y0 + TILE + 1, x0 + 12, y0 + TILE + 2),
                           fill=(0, 0, 0))
            if level:
                draw.rectangle((x0 + 2, y0 + TILE + 1, x0 + 2 + level,
                                y0 + TILE + 2), fill=(60, 220, 60))
            if self.trace_length > 0:
                self.traces[i].append((row, col))

        # side panel
        px = self.board_px
        draw.rectangle((px, 0, px + self.panel_w, self.board_px), fill=_PANEL_BG)
        draw.text((px + 8, 6), f"Step {self.step:>7,}", fill="black",
                  font=self.font)
        draw.text((px + 8, 22), "Reward sum", fill="black", font=self.font)
        self.cum_rewards[: len(rewards)] += np.asarray(
            rewards, dtype=np.float32)[: self.n_drones]
        for i in range(min(self.n_drones, 12)):
            color = DRONE_COLORS[i % len(DRONE_COLORS)]
            y = 38 + i * 16
            draw.rectangle((px + 8, y + 2, px + 16, y + 10), fill=color)
            name = self.player_names.get(i, f"P{i}")
            draw.text((px + 22, y),
                      f"{name[:8]:<8} {self.cum_rewards[i]:>7.1f}",
                      fill="black", font=self.font)

        # legend
        ly = self.board_px + 2
        draw.rectangle((0, self.board_px, frame.width, frame.height),
                       fill=_PANEL_BG)
        lx = 4
        for code, label in ((Object.SKYSCRAPER.value, "Bldg"),
                            (Object.STATION.value, "Charge"),
                            (Object.DROPZONE.value, "Drop"),
                            (Object.PACKET.value, "Pack")):
            frame.paste(self.tiles[code], (lx, ly))
            draw.text((lx + TILE + 2, ly + 4), label, fill="black",
                      font=self.font)
            lx += TILE + 6 * len(label) + 14

        self.step += 1
        if self.scale != 1.0:
            frame = frame.resize(
                (int(frame.width * self.scale), int(frame.height * self.scale)),
                resample=Image.NEAREST)
        return frame

    def render_state(self, state, rewards=None, actions=None):
        """Render one env's ``EnvState`` (unbatched tensors, any device)."""
        state = {f: np.asarray(getattr(state, f).detach().cpu().numpy())
                 for f in ("ground", "air_x", "air_y", "carrying_package",
                           "charge")}
        n = self.n_drones
        rewards = np.zeros(n) if rewards is None else np.asarray(rewards)
        actions = (np.full(n, int(Action.STAY)) if actions is None
                   else np.asarray(actions))
        return self.render_frame(
            state["ground"], state["air_x"], state["air_y"],
            state["carrying_package"], state["charge"], rewards, actions)

    def save_frame(self, img, output_dir: str) -> str:
        import os

        path = os.path.join(
            output_dir, f"{self.step:04d}.{self.image_format}")
        img.save(path)
        return path
