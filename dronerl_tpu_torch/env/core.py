"""The environment in plain PyTorch: reset / step / observe, batched.

Counterpart of ``dronerl_tpu/env/core.py``. The env axis is written out
in place of ``vmap``: every ``*_batch`` function takes tensors with a
leading env axis E and one PRNG key (2,) per env. The single-env
``reset`` / ``step`` / ``observe`` are the batch functions at E = 1.

At a fixed key the transitions are bit-identical to the JAX package,
quirks included (see ``dronerl_tpu/env/core.py`` and
:mod:`dronerl_tpu_torch.env.spawn`). This module is the port's CPU engine
and the body of the fused tick kernel's plain version.
"""

from typing import Callable, Optional, Tuple

import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.constants import Action, NUM_OBS_CHANNELS, Object
from dronerl_tpu_torch.env.spawn import (
    place_in_air, place_on_ground, respawn_ground_pair)
from dronerl_tpu_torch.env.types import EnvParams, EnvState, env_fields
from dronerl_tpu_torch.ops.collision import same_cell_conflicts
from dronerl_tpu_torch.ops.pointops import (
    flag_mask, flag_mask_scatter_order, place_values, point_lookup,
    wrap_clamp)
from dronerl_tpu_torch.ops.window import crop_windows


def _split2(keys: torch.Tensor, rounds: int = 20):
    ks = rng.split(keys, 2, rounds)
    return ks[..., 0, :], ks[..., 1, :]


def reset_keys(keys: torch.Tensor, params: EnvParams,
               rounds: int = 20) -> EnvState:
    """A fresh world per env key (E, 2): ground objects, drones, pickup.
    ``rounds`` < 20 hashes every draw with Threefry-2x32-``rounds``, as the
    tick kernels' fast-RNG mode does (the JAX package's env core has no
    such mode)."""
    params.validate()
    e = keys.shape[0]
    g, n = params.grid_size, params.n_drones
    device = keys.device
    grid = torch.zeros((e, g, g), dtype=torch.int8, device=device)
    key = keys
    for count, code in (
        (params.num_packets, Object.PACKET),
        (params.num_dropzones, Object.DROPZONE),
        (params.num_stations, Object.STATION),
        (params.num_skyscrapers, Object.SKYSCRAPER),
    ):
        key, placement_key = _split2(key, rounds)
        fill = torch.full((e, count), int(code), dtype=torch.int8, device=device)
        grid = place_on_ground(placement_key, grid, fill, params, rounds)

    sentinel = torch.full((e, n), -1, dtype=torch.int32, device=device)
    key, placement_key = _split2(key, rounds)
    air_x, air_y = place_in_air(
        placement_key, sentinel, sentinel, params,
        exclude=grid == Object.SKYSCRAPER, rounds=rounds)

    carrying = point_lookup(grid, air_y, air_x) == Object.PACKET
    lifted = flag_mask(air_y, air_x, carrying, g, g)
    grid = torch.where(lifted, torch.zeros_like(grid), grid)
    return EnvState(
        ground=grid,
        air_x=air_x,
        air_y=air_y,
        carrying_package=carrying,
        charge=torch.full((e, n), 100.0, dtype=torch.float32, device=device),
    )


def reset_batch(key: torch.Tensor, params: EnvParams,
                num_envs: int, rounds: int = 20) -> EnvState:
    """``core.reset_batch``: env e resets with row e of ``split(key, E)``
    (``rounds`` as :func:`reset_keys`). Counted in ``reset_batch.calls``
    (a captured call once a replay by the graph's owner)."""
    reset_batch.calls += 1
    return reset_keys(rng.split(key, num_envs, rounds), params, rounds)


reset_batch.calls = 0


def step_batch(
    keys: torch.Tensor,
    state: EnvState,
    actions: torch.Tensor,
    params: EnvParams,
    rounds: int = 20,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """Advance every env one tick with its key (E, 2) and actions (E, N);
    ``rounds`` as :func:`reset_keys`.

    Returns ``(state, rewards (E, N) float32, dones (E, N) bool)``.
    """
    g = params.grid_size
    n = params.n_drones
    actions = actions.to(torch.int32)
    zero = torch.zeros_like(actions)

    # --- move ---------------------------------------------------------
    dy = torch.where(actions == Action.UP, -1,
                     torch.where(actions == Action.DOWN, 1, zero))
    dx = torch.where(actions == Action.LEFT, -1,
                     torch.where(actions == Action.RIGHT, 1, zero))
    new_y = (state.air_y + dy).to(torch.int32)
    new_x = (state.air_x + dx).to(torch.int32)

    # --- crashes ------------------------------------------------------
    off_board = (new_y < 0) | (new_y >= g) | (new_x < 0) | (new_x >= g)
    sky_read = point_lookup(
        state.ground, new_y.clamp(0, g - 1), new_x.clamp(0, g - 1))
    hit_skyscraper = (sky_read == Object.SKYSCRAPER) & ~off_board
    collided = off_board | hit_skyscraper | same_cell_conflicts(new_x, new_y)
    # The reference reads the landing cell unclipped; jnp gathers wrap
    # -1 and clamp, and every such drone is collided anyway.
    target_cell = point_lookup(
        state.ground, wrap_clamp(new_y, g), wrap_clamp(new_x, g))

    # --- battery ------------------------------------------------------
    is_charging = (target_cell == Object.STATION) & ~collided
    is_discharging = ~is_charging & ~collided
    charge = (state.charge + is_charging * params.charge).clamp(0, 100)
    charge = (charge - is_discharging * params.discharge).clamp(0, 100)
    dones = collided | (charge == 0)
    survivors = ~dones
    charge = torch.where(dones, torch.full_like(charge, 100.0), charge)

    # --- pickup -------------------------------------------------------
    carrying0 = state.carrying_package
    picked_up = (target_cell == Object.PACKET) & survivors & ~carrying0
    lifted = flag_mask_scatter_order(new_y, new_x, picked_up, g, g)
    ground = torch.where(lifted, torch.zeros_like(state.ground), state.ground)
    carrying = (carrying0 & survivors) | picked_up

    # --- delivery -----------------------------------------------------
    delivered = (target_cell == Object.DROPZONE) & survivors & carrying0
    carrying = carrying & ~delivered

    # --- respawn packets + dropzones (shared key, dropzone slots use
    # the packet count: the reference env's quirks) --------------------
    key, respawn_key = _split2(keys, rounds)
    needs_packet = delivered | (dones & carrying0)
    e = actions.shape[0]
    packet_fill = torch.zeros((e, params.num_packets), dtype=torch.int8,
                              device=actions.device)
    dropzone_fill = torch.zeros_like(packet_fill)
    if params.num_packets:  # no slots, no fills (as jnp's empty .at[:n])
        packet_fill[:, :n] = needs_packet.to(torch.int8) * int(Object.PACKET)
        dropzone_fill[:, :n] = delivered.to(torch.int8) * int(Object.DROPZONE)
    consumed = flag_mask_scatter_order(new_y, new_x, delivered, g, g)
    ground = respawn_ground_pair(
        respawn_key, ground, packet_fill, dropzone_fill, consumed, params,
        rounds)

    # --- rewards ------------------------------------------------------
    rewards = (
        params.crash_reward * dones
        + params.pickup_reward * picked_up
        + params.delivery_reward * delivered
        + params.charge_reward * is_charging
    ).to(torch.float32)

    # --- respawn dead drones ------------------------------------------
    minus_one = torch.full_like(new_x, -1)
    new_x = torch.where(dones, minus_one, new_x)
    new_y = torch.where(dones, minus_one, new_y)
    _, respawn_key = _split2(key, rounds)
    new_x, new_y = place_in_air(
        respawn_key, new_x, new_y, params,
        exclude=state.ground == Object.SKYSCRAPER, rounds=rounds)

    # Respawned drones pick up a packet under them (no reward), indexed
    # transposed ([x, y]) as in the reference.
    packet_here = ground == Object.PACKET
    respawn_pickup = point_lookup(
        packet_here, wrap_clamp(new_x, g), wrap_clamp(new_y, g)) & dones
    carrying = carrying | respawn_pickup
    lifted = flag_mask(new_x, new_y, respawn_pickup, g, g)
    ground = torch.where(lifted, torch.zeros_like(ground), ground)

    next_state = EnvState(
        ground=ground,
        air_x=new_x,
        air_y=new_y,
        carrying_package=carrying,
        charge=charge,
    )
    return next_state, rewards, dones


def observe_batch(state: EnvState, params: EnvParams,
                  limit: Optional[int] = None) -> torch.Tensor:
    """Per-drone observations, float32: ``wrapper='window'`` gives (E, M,
    2r+1, 2r+1, 6) egocentric crops of the board padded with walls,
    ``wrapper='global'`` (E, M, G, G, 6), the whole board, the same for
    every drone.

    ``limit`` keeps the first ``limit`` drones' views (all drones still
    appear inside them).
    """
    if params.wrapper == "global":
        obs = _observe_global(state, params)
        return obs if limit is None else obs[:, :limit]
    if params.wrapper != "window":
        raise NotImplementedError(
            f"wrapper={params.wrapper!r} is not implemented")
    r = params.window_radius
    padded = torch.nn.functional.pad(
        state.ground, (r, r, r, r), value=int(Object.SKYSCRAPER))
    cx = state.air_x + r
    cy = state.air_y + r
    # +1 so that a present drone with zero charge still shows.
    charge_grid = place_values(
        torch.zeros_like(padded), cy, cx, state.charge.to(torch.int8) + 1)

    carrying = state.carrying_package
    if limit is not None:
        cx, cy, carrying = cx[:, :limit], cy[:, :limit], carrying[:, :limit]

    win_ground = crop_windows(padded, cx, cy, r)
    win_charge = crop_windows(charge_grid, cx, cy, r)

    is_packet = win_ground == Object.PACKET
    is_packet[:, :, r, r] |= carrying
    charge_frac = (win_charge - 1).clamp(0, 100).to(torch.float32) / 100.0
    channels = [
        (win_charge > 0).to(torch.float32),
        is_packet.to(torch.float32),
        (win_ground == Object.DROPZONE).to(torch.float32),
        (win_ground == Object.STATION).to(torch.float32),
        charge_frac,
        (win_ground == Object.SKYSCRAPER).to(torch.float32),
    ]
    return torch.stack(channels, dim=-1)


def _observe_global(state: EnvState, params: EnvParams) -> torch.Tensor:
    """``core._observe_global``: the board's object channels, then the
    drones written one at a time as jnp's scatters do (a -1 wraps, an
    off-board writer drops, the last writer to a cell wins): channel 0
    set to 1, the carried packet added to channel 1, which is then
    clamped to 1, and channel 4 set to charge / 100 last. Returns (E, N,
    G, G, 6), one grid broadcast over the drones."""
    e, g, _ = state.ground.shape
    ground = state.ground.reshape(e, -1)
    zero = torch.zeros_like(ground, dtype=torch.float32)
    drone, packet = zero, (ground == Object.PACKET).to(torch.float32)
    charge = zero
    cells = torch.arange(g * g, device=ground.device)

    def writes(i):
        y, x = state.air_y[:, i:i + 1], state.air_x[:, i:i + 1]
        y, x = torch.where(y < 0, y + g, y), torch.where(x < 0, x + g, x)
        inside = (y >= 0) & (y < g) & (x >= 0) & (x < g)
        return (cells == y * g + x) & inside

    n = state.air_x.shape[1]
    for i in range(n):
        drone = torch.where(writes(i), 1.0, drone)
    for i in range(n):
        carried = state.carrying_package[:, i:i + 1].to(torch.float32)
        packet = packet + torch.where(writes(i), carried, 0.0)
    packet = torch.minimum(packet, torch.ones_like(packet))
    for i in range(n):
        charge = torch.where(writes(i), state.charge[:, i:i + 1] / 100.0,
                             charge)
    grid = torch.stack([
        drone, packet, (ground == Object.DROPZONE).to(torch.float32),
        (ground == Object.STATION).to(torch.float32), charge,
        (ground == Object.SKYSCRAPER).to(torch.float32)], dim=-1)
    return grid.reshape(e, 1, g, g, NUM_OBS_CHANNELS).expand(
        e, n, g, g, NUM_OBS_CHANNELS)


def _unbatch(state: EnvState) -> EnvState:
    return EnvState(*(t[0] for t in env_fields(state)))


def _batch(state: EnvState) -> EnvState:
    return EnvState(*(t[None] for t in env_fields(state)))


def reset(key: torch.Tensor, params: EnvParams) -> EnvState:
    """One env: ``core.reset(key, params)`` with unbatched shapes."""
    return _unbatch(reset_keys(key[None], params))


def step(key: torch.Tensor, state: EnvState, actions: torch.Tensor,
         params: EnvParams):
    """One env: ``core.step`` → (state, rewards (N,), dones (N,))."""
    st, rew, done = step_batch(key[None], _batch(state), actions[None], params)
    return _unbatch(st), rew[0], done[0]


def observe(state: EnvState, params: EnvParams,
            limit: Optional[int] = None) -> torch.Tensor:
    """One env: (M, 2r+1, 2r+1, 6) window or (M, G, G, 6) global
    observations."""
    return observe_batch(_batch(state), params, limit)[0]


def rollout(key: torch.Tensor, state: EnvState, params: EnvParams,
            num_steps: int, policy: Callable[[torch.Tensor, EnvState],
                                             torch.Tensor]
            ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """``core.rollout``: ``num_steps`` ticks of one env under ``policy(key,
    state) -> (N,) actions``, each tick splitting its key three ways
    (carry, policy, step; the step key moved to the state's device).
    Returns the final state and the stacked
    rewards and dones, (num_steps, N) each."""
    rewards, dones = [], []
    for _ in range(num_steps):
        key, policy_key, step_key = rng.split(key, 3)
        state, rew, done = step(step_key.to(state.ground.device), state,
                                policy(policy_key, state), params)
        rewards.append(rew)
        dones.append(done)
    return state, torch.stack(rewards), torch.stack(dones)
