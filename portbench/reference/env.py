"""The delivery-drone environment of nyx-ai/droneRL in plain PyTorch,
batched over a leading env axis: reset, step and the window observation,
with the transitions the program's kernels promise (the reference env's
quirks included: the transposed occupancy of the air spawn, the shared
key of the packet and dropzone respawns, jnp's wrap-and-clamp gathers).

State: ground int8 (E, G, G) indexed [env, y, x]; air_x, air_y int32 (E,
N); carrying bool (E, N); charge float32 (E, N). Every draw comes from
``threefry``; nothing here imports the program under test.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from portbench.reference import threefry

LEFT, DOWN, RIGHT, UP, STAY = range(5)
NUM_ACTIONS = 5
SKYSCRAPER, STATION, DROPZONE, PACKET = 2, 3, 4, 5
CHANNELS = 6


@dataclasses.dataclass(frozen=True)
class Params:
    grid_size: int = 9
    n_drones: int = 4
    window_radius: int = 3
    wrapper: str = "window"
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

    @classmethod
    def from_flags(cls, flags: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in flags.items() if k in names})

    @property
    def cells(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def obs_dim(self) -> int:
        if self.wrapper != "window":
            raise NotImplementedError(
                f"the reference has no {self.wrapper!r} observation yet")
        return (2 * self.window_radius + 1) ** 2 * CHANNELS


class State(NamedTuple):
    ground: torch.Tensor
    air_x: torch.Tensor
    air_y: torch.Tensor
    carrying: torch.Tensor
    charge: torch.Tensor


def _split2(keys):
    ks = threefry.split(keys, 2)
    return ks[..., 0, :], ks[..., 1, :]


def _wrap_clamp(idx, size):
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _lookup(grid, rows, cols):
    e, _, w = grid.shape
    return grid.reshape(e, -1).gather(1, rows.long() * w + cols.long())


def _flag_mask(rows, cols, flags, g):
    """True at every on-board (rows[i], cols[i]) where flags[i]."""
    inside = (rows >= 0) & (rows < g) & (cols >= 0) & (cols < g)
    flat = rows.long() * g + cols.long()
    cells = torch.arange(g * g, device=rows.device)
    hit = (flat[:, :, None] == cells) & (flags & inside)[:, :, None]
    return hit.any(dim=1).reshape(-1, g, g)


def _scatter_flags(rows, cols, flags, g):
    """``zeros.at[rows, cols].set(flags)``: negatives wrap once, writers
    off the board drop, the last writer to a cell wins."""
    rows = torch.where(rows < 0, rows + g, rows)
    cols = torch.where(cols < 0, cols + g, cols)
    valid = (rows >= 0) & (rows < g) & (cols >= 0) & (cols < g)
    flat = rows.long() * g + cols.long()
    cells = torch.arange(g * g, device=rows.device)
    mask = torch.zeros((rows.shape[0], g * g), dtype=torch.bool,
                       device=rows.device)
    for i in range(rows.shape[1]):
        mask = torch.where((flat[:, i:i + 1] == cells) & valid[:, i:i + 1],
                           flags[:, i:i + 1], mask)
    return mask.reshape(-1, g, g)


def _place(grid, rows, cols, values):
    e, _, w = grid.shape
    out = grid.reshape(e, -1).clone()
    flat = rows.long() * w + cols.long()
    out.scatter_(1, flat, values.to(grid.dtype).expand_as(flat))
    return out.reshape(grid.shape)


def _top_cells(u, valid, k):
    """The k best cells of (E, C) scores over the valid ones, in
    ``lax.top_k`` order (descending, ties to the lowest index)."""
    scores = torch.where(valid, u, torch.full_like(u, float("-inf")))
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :k]


def _place_on_ground(key, ground, fill, p: Params):
    u = threefry.uniform(key, (p.cells,))
    cells = _top_cells(u, (ground == 0).reshape(ground.shape[0], -1),
                       fill.shape[1])
    return _place(ground, cells // p.grid_size, cells % p.grid_size, fill)


def _place_in_air(key, air_x, air_y, p: Params, exclude):
    """Drones at the -1 sentinel take fresh cells, clear of the occupancy
    written at [x, y] and of ``exclude``; cell c decodes as (x, y) = (c //
    G, c % G)."""
    g = p.grid_size
    occ = _wrap_clamp(air_x, g).long() * g + _wrap_clamp(air_y, g).long()
    cells = torch.arange(p.cells, device=air_x.device)
    open_cells = (~(occ[:, :, None] == cells).any(dim=1)
                  & ~exclude.reshape(air_x.shape[0], -1))
    picked = _top_cells(threefry.uniform(key, (p.cells,)), open_cells,
                        p.n_drones).to(torch.int32)
    return (torch.where(air_x == -1, picked // g, air_x),
            torch.where(air_y == -1, picked % g, air_y))


def reset(keys: torch.Tensor, p: Params) -> State:
    """A fresh world for every env key (E, 2)."""
    e, g, n = keys.shape[0], p.grid_size, p.n_drones
    dev = keys.device
    grid = torch.zeros((e, g, g), dtype=torch.int8, device=dev)
    key = keys
    for count, code in ((p.packets_factor * n, PACKET),
                        (p.dropzones_factor * n, DROPZONE),
                        (p.stations_factor * n, STATION),
                        (p.skyscrapers_factor * n, SKYSCRAPER)):
        key, sub = _split2(key)
        grid = _place_on_ground(
            sub, grid, torch.full((e, count), code, dtype=torch.int8,
                                  device=dev), p)
    key, sub = _split2(key)
    minus = torch.full((e, n), -1, dtype=torch.int32, device=dev)
    air_x, air_y = _place_in_air(sub, minus, minus, p, grid == SKYSCRAPER)
    carrying = _lookup(grid, air_y, air_x) == PACKET
    grid = torch.where(_flag_mask(air_y, air_x, carrying, g),
                       torch.zeros_like(grid), grid)
    return State(grid, air_x, air_y, carrying,
                 torch.full((e, n), 100.0, device=dev))


def reset_all(key: torch.Tensor, p: Params, num_envs: int) -> State:
    return reset(threefry.split(key, num_envs), p)


def step(keys: torch.Tensor, s: State, actions: torch.Tensor, p: Params):
    """Every env one tick with its key (E, 2) and actions (E, N):
    ``(state, rewards (E, N) f32, dones (E, N) bool)``."""
    g = p.grid_size
    a = actions.to(torch.int32)
    zero = torch.zeros_like(a)
    dy = torch.where(a == UP, -1, torch.where(a == DOWN, 1, zero))
    dx = torch.where(a == LEFT, -1, torch.where(a == RIGHT, 1, zero))
    ny = (s.air_y + dy).to(torch.int32)
    nx = (s.air_x + dx).to(torch.int32)

    off = (ny < 0) | (ny >= g) | (nx < 0) | (nx >= g)
    sky = (_lookup(s.ground, ny.clamp(0, g - 1), nx.clamp(0, g - 1))
           == SKYSCRAPER) & ~off
    same = ((nx[:, :, None] == nx[:, None, :])
            & (ny[:, :, None] == ny[:, None, :])).sum(dim=2) > 1
    crashed = off | sky | same
    target = _lookup(s.ground, _wrap_clamp(ny, g), _wrap_clamp(nx, g))

    charging = (target == STATION) & ~crashed
    discharging = ~charging & ~crashed
    charge = (s.charge + charging * p.charge).clamp(0, 100)
    charge = (charge - discharging * p.discharge).clamp(0, 100)
    dones = crashed | (charge == 0)
    alive = ~dones
    charge = torch.where(dones, torch.full_like(charge, 100.0), charge)

    picked = (target == PACKET) & alive & ~s.carrying
    ground = torch.where(_scatter_flags(ny, nx, picked, g),
                         torch.zeros_like(s.ground), s.ground)
    carrying = (s.carrying & alive) | picked
    delivered = (target == DROPZONE) & alive & s.carrying
    carrying = carrying & ~delivered

    key, respawn_key = _split2(keys)
    packets = p.packets_factor * p.n_drones
    fill_p = torch.zeros((a.shape[0], packets), dtype=torch.int8,
                         device=a.device)
    fill_d = torch.zeros_like(fill_p)
    if packets:
        n = p.n_drones
        fill_p[:, :n] = (delivered | (dones & s.carrying)).to(
            torch.int8) * PACKET
        fill_d[:, :n] = delivered.to(torch.int8) * DROPZONE
    consumed = _scatter_flags(ny, nx, delivered, g)
    # Packets, then the consumed dropzones cleared, then dropzones: both
    # spawns from the same key.
    ground = _place_on_ground(respawn_key, ground, fill_p, p)
    ground = torch.where(consumed, torch.zeros_like(ground), ground)
    ground = _place_on_ground(respawn_key, ground, fill_d, p)

    rewards = (p.crash_reward * dones + p.pickup_reward * picked
               + p.delivery_reward * delivered
               + p.charge_reward * charging).to(torch.float32)

    minus = torch.full_like(nx, -1)
    nx = torch.where(dones, minus, nx)
    ny = torch.where(dones, minus, ny)
    _, respawn_key = _split2(key)
    nx, ny = _place_in_air(respawn_key, nx, ny, p, s.ground == SKYSCRAPER)
    # A respawned drone picks up a packet under it, read at [x, y].
    under = _lookup(ground == PACKET, _wrap_clamp(nx, g),
                    _wrap_clamp(ny, g)) & dones
    carrying = carrying | under
    ground = torch.where(_flag_mask(nx, ny, under, g),
                         torch.zeros_like(ground), ground)
    return State(ground, nx, ny, carrying, charge), rewards, dones


def observe(s: State, p: Params, drones: Optional[int] = 1) -> torch.Tensor:
    """The first ``drones`` drones' window observations, feature-major and
    drone-major: (drones · obs_dim, E) f32; an observation is the (2r+1,
    2r+1, 6) crop flattened, channels last: drone (charge > 0), packet
    (a carried one at the centre), dropzone, station, charge / 100 (the
    divide rounded once, as IEEE division), skyscraper or wall."""
    r, g = p.window_radius, p.grid_size
    e = s.ground.shape[0]
    if p.wrapper != "window":
        raise NotImplementedError(
            f"the reference has no {p.wrapper!r} observation yet")
    padded = torch.nn.functional.pad(s.ground, (r, r, r, r), value=SKYSCRAPER)
    side = g + 2 * r
    cx, cy = s.air_x + r, s.air_y + r
    charge_grid = _place(torch.zeros_like(padded), cy, cx,
                         s.charge.to(torch.int8) + 1)
    cx, cy, carrying = cx[:, :drones], cy[:, :drones], s.carrying[:, :drones]
    span = torch.arange(-r, r + 1, device=padded.device)
    rows = cy.long()[:, :, None] + span
    cols = cx.long()[:, :, None] + span
    flat = (rows[:, :, :, None] * side + cols[:, :, None, :]).reshape(e, -1)
    w = 2 * r + 1
    win = padded.reshape(e, -1).gather(1, flat).reshape(e, drones, w, w)
    win_charge = charge_grid.reshape(e, -1).gather(1, flat).reshape(
        e, drones, w, w)
    packet = win == PACKET
    packet[:, :, r, r] |= carrying
    frac = ((win_charge - 1).clamp(0, 100).double() / 100.0).float()
    obs = torch.stack([(win_charge > 0).float(), packet.float(),
                       (win == DROPZONE).float(), (win == STATION).float(),
                       frac, (win == SKYSCRAPER).float()], dim=-1)
    return obs.reshape(e, -1).t().contiguous()
