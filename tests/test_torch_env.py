"""The port's env (``dronerl_tpu_torch.env.core``) against the JAX env.

Same keys, same states, same actions: reset, step and observe must agree
bitwise, the reference env's quirks included, except the observation's
charge channel, which may differ by 1 ULP (charge / 100 rounds through a
reciprocal multiply in some XLA fusions): atol 1.3e-7 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.constants import Action, Object
from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams, EnvState as JState
from dronerl_tpu.ops import fused_tick as jfused
from dronerl_tpu_torch.constants import (
    Action as TAction, NUM_ACTIONS, NUM_OBS_CHANNELS, Object as TObject)
from dronerl_tpu_torch.env import core as tcore
from dronerl_tpu_torch.env.types import EnvParams as TParams, EnvState
from dronerl_tpu_torch.ops import fused_tick as tfused
from dronerl_tpu_torch import rng

CHARGE_ATOL = 1.3e-7
FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
CONFIGS = [
    dict(grid_size=9, n_drones=4),
    dict(grid_size=5, n_drones=3, packets_factor=1, dropzones_factor=1,
         stations_factor=1, skyscrapers_factor=1),
    dict(grid_size=4, n_drones=2, packets_factor=1, dropzones_factor=1,
         stations_factor=1, skyscrapers_factor=1),
]

# The JAX side runs jitted (static env params): eager vmap is slow.
_jstep = jax.jit(jcore.step_batch, static_argnums=(3,))
_jreset = jax.jit(jcore.reset_batch, static_argnums=(1, 2))
_jobserve = jax.jit(jcore.observe_batch, static_argnums=(1, 2))
_jstep1 = jax.jit(jcore.step, static_argnums=(3,))
_jobserve1 = jax.jit(jcore.observe, static_argnums=(1,))


def _torch_state(js: JState) -> EnvState:
    return EnvState(*(torch.from_numpy(np.array(getattr(js, f)))
                      for f in FIELDS))


def _key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def assert_state_equal(js: JState, ts: EnvState, tag=""):
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (tag, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (tag, f)
        assert (a == b).all(), (tag, f)


def assert_obs_equal(jo, to, tag=""):
    jo = np.asarray(jo)
    to = to.numpy()
    assert jo.shape == to.shape and to.dtype == np.float32, tag
    ch = np.arange(NUM_OBS_CHANNELS) != 4
    assert (jo[..., ch] == to[..., ch]).all(), tag
    np.testing.assert_allclose(to[..., 4], jo[..., 4], rtol=0,
                               atol=CHARGE_ATOL, err_msg=str(tag))


def test_constants_match():
    assert NUM_ACTIONS == len(Action) and NUM_OBS_CHANNELS == 6
    assert {a.name: a.value for a in TAction} == {
        a.name: a.value for a in Action}
    assert {o.name: o.value for o in TObject} == {
        o.name: o.value for o in Object}


@pytest.mark.parametrize("kw", CONFIGS + [dict(wrapper="global")])
def test_params_properties_match(kw):
    jp, tp = JParams(**kw), TParams(**kw)
    for name in ("num_packets", "num_dropzones", "num_stations",
                 "num_skyscrapers", "num_cells", "window_size", "obs_shape"):
        assert getattr(jp, name) == getattr(tp, name), name
    assert hash(tp) == hash(TParams(**kw))


def test_params_validate_matches():
    kw = dict(grid_size=3, n_drones=2)
    with pytest.raises(ValueError):
        JParams(**kw).validate()
    with pytest.raises(ValueError):
        TParams(**kw).validate()


@pytest.mark.parametrize("kw", CONFIGS)
def test_reset_batch(kw):
    jp, tp = JParams(**kw), TParams(**kw)
    for seed in (0, 7):
        js = _jreset(jax.random.PRNGKey(seed), jp, 64)
        ts = tcore.reset_batch(rng.PRNGKey(seed), tp, 64)
        assert_state_equal(js, ts, seed)
        assert_obs_equal(_jobserve(js, jp, None),
                         tcore.observe_batch(ts, tp, None), seed)


@pytest.mark.parametrize("kw", CONFIGS)
def test_step_observe_rollout(kw):
    """Random actions over many ticks: dead drones respawn, packets are
    picked up and delivered, and every transition stays bitwise."""
    jp, tp = JParams(**kw), TParams(**kw)
    num_envs, ticks = 96, 12
    key = jax.random.PRNGKey(3)
    js = _jreset(key, jp, num_envs)
    ts = tcore.reset_batch(_key(key), tp, num_envs)
    acts_rng = np.random.default_rng(0)
    dones_seen = rewards_seen = 0
    for t in range(ticks):
        key, sk = jax.random.split(key)
        keys = jax.random.split(sk, num_envs)
        acts = acts_rng.integers(
            0, NUM_ACTIONS, (num_envs, jp.n_drones)).astype(np.int32)
        js, jr, jd = _jstep(keys, js, jnp.asarray(acts), jp)
        ts, tr, td = tcore.step_batch(_key(keys), ts, torch.from_numpy(acts),
                                      tp)
        assert_state_equal(js, ts, t)
        assert (np.asarray(jr) == tr.numpy()).all(), t
        assert (np.asarray(jd) == td.numpy()).all(), t
        assert_obs_equal(_jobserve(js, jp, 1),
                         tcore.observe_batch(ts, tp, 1), t)
        dones_seen += int(td.sum())
        rewards_seen += int((tr > 0).sum())
    assert dones_seen > 0 and rewards_seen > 0


def _scenario_state(g, drones, ground_objects=(), carrying=None,
                    charge=None):
    """drones: (x, y) pairs; ground_objects: (y, x, Object)."""
    ground = np.zeros((g, g), np.int8)
    for y, x, obj in ground_objects:
        ground[y, x] = obj.value
    n = len(drones)
    return JState(
        ground=jnp.asarray(ground),
        air_x=jnp.asarray([d[0] for d in drones], jnp.int32),
        air_y=jnp.asarray([d[1] for d in drones], jnp.int32),
        carrying_package=jnp.asarray(carrying or [False] * n, jnp.bool_),
        charge=jnp.asarray(charge or [100.0] * n, jnp.float32))


EMPTY = dict(skyscrapers_factor=0, packets_factor=0, dropzones_factor=0,
             stations_factor=0)
SCENARIOS = {
    "moves": (dict(grid_size=9, n_drones=5, **EMPTY),
              [(4, 4), (1, 1), (7, 7), (1, 7), (7, 1)], [], None, None,
              [a.value for a in Action]),
    "off_board_crash": (dict(grid_size=5, n_drones=1, **EMPTY),
                        [(0, 0)], [], None, None, [Action.LEFT.value]),
    "skyscraper_crash": (
        dict(grid_size=5, n_drones=1, skyscrapers_factor=1,
             packets_factor=0, dropzones_factor=0, stations_factor=0),
        [(1, 1)], [(1, 2, Object.SKYSCRAPER)], None, None,
        [Action.RIGHT.value]),
    "head_on": (dict(grid_size=5, n_drones=2, **EMPTY),
                [(1, 2), (3, 2)], [], None, None,
                [Action.RIGHT.value, Action.LEFT.value]),
    "pass_through": (dict(grid_size=5, n_drones=2, **EMPTY),
                     [(1, 2), (2, 2)], [], None, None,
                     [Action.RIGHT.value, Action.LEFT.value]),
    "discharge_death": (dict(grid_size=5, n_drones=1, **EMPTY),
                        [(2, 2)], [], None, [10.0], [Action.STAY.value]),
    "charging": (dict(grid_size=5, n_drones=1, skyscrapers_factor=0,
                      packets_factor=0, dropzones_factor=0,
                      stations_factor=1),
                 [(1, 2)], [(2, 2, Object.STATION)], None, [50.0],
                 [Action.RIGHT.value]),
    "pickup": (dict(grid_size=5, n_drones=1, packets_factor=1,
                    dropzones_factor=1, stations_factor=0,
                    skyscrapers_factor=0),
               [(1, 2)], [(2, 2, Object.PACKET), (4, 4, Object.DROPZONE)],
               None, None, [Action.RIGHT.value]),
    # Delivery respawns a packet and a dropzone from ONE key, the dropzone
    # spawn drawing num_packets slots: the reference env's quirk.
    "delivery": (dict(grid_size=5, n_drones=2, packets_factor=2,
                      dropzones_factor=1, stations_factor=0,
                      skyscrapers_factor=0),
                 [(1, 2), (4, 4)],
                 [(2, 2, Object.DROPZONE), (0, 0, Object.PACKET),
                  (0, 4, Object.PACKET), (4, 0, Object.PACKET)],
                 [True, False], None, [Action.RIGHT.value, Action.STAY.value]),
    "crash_drops_package": (
        dict(grid_size=5, n_drones=1, packets_factor=1, dropzones_factor=1,
             stations_factor=0, skyscrapers_factor=0),
        [(0, 0)], [(4, 4, Object.DROPZONE)], [True], None,
        [Action.UP.value]),
    # An off-board drone's -1 wraps onto a survivor's landing cell, and
    # the later (False) writer of the lift scatter wins: the packet stays.
    "scatter_order": (dict(grid_size=5, n_drones=2, packets_factor=1,
                           dropzones_factor=1, stations_factor=0,
                           skyscrapers_factor=0),
                      [(3, 2), (0, 2)], [(2, 4, Object.PACKET),
                                         (0, 0, Object.DROPZONE)],
                      None, None, [Action.RIGHT.value, Action.LEFT.value]),
    "zero_charge_visible": (dict(grid_size=5, n_drones=2, **EMPTY),
                            [(2, 2), (3, 2)], [], None, [10.0, 20.0],
                            [Action.STAY.value, Action.STAY.value]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_scenarios(name):
    """Hand-built states of tests/test_env.py's cases, one step each, on
    the single-env entry points."""
    kw, drones, objects, carrying, charge, actions = SCENARIOS[name]
    jp, tp = JParams(**kw), TParams(**kw)
    js = _scenario_state(jp.grid_size, drones, objects, carrying, charge)
    ts = EnvState(*(torch.from_numpy(np.array(getattr(js, f)))
                    for f in FIELDS))
    acts = np.asarray(actions, np.int32)
    for seed in (42, 5):
        key = jax.random.PRNGKey(seed)
        js2, jr, jd = _jstep1(key, js, jnp.asarray(acts), jp)
        ts2, tr, td = tcore.step(_key(key), ts, torch.from_numpy(acts), tp)
        assert_state_equal(js2, ts2, (name, seed))
        assert (np.asarray(jr) == tr.numpy()).all(), (name, seed)
        assert (np.asarray(jd) == td.numpy()).all(), (name, seed)
        assert_obs_equal(_jobserve1(js2, jp), tcore.observe(ts2, tp),
                         (name, seed))
    if name == "scatter_order":
        assert int(np.asarray(js2.ground)[2, 4]) == Object.PACKET.value


def test_single_env_reset():
    jp, tp = JParams(grid_size=7, n_drones=3), TParams(grid_size=7,
                                                      n_drones=3)
    key = jax.random.PRNGKey(11)
    assert_state_equal(jcore.reset(key, jp), tcore.reset(_key(key), tp))


def test_global_observe_batch_matches_jax():
    """``wrapper="global"``: the whole board, one grid for every drone
    (and for the first ``limit``), bitwise but the charge channel, after
    a reset and after steps of random actions."""
    kw = dict(grid_size=9, n_drones=4, wrapper="global")
    jp, tp = JParams(**kw), TParams(**kw)
    key = jax.random.PRNGKey(4)
    js = _jreset(key, jp, 32)
    ts = tcore.reset_batch(_key(key), tp, 32)
    acts_rng = np.random.default_rng(1)
    for t in range(4):
        obs = tcore.observe_batch(ts, tp)
        assert tuple(obs.shape) == (32, 4, 9, 9, 6)
        assert_obs_equal(_jobserve(js, jp, None), obs, t)
        assert_obs_equal(_jobserve(js, jp, 1), tcore.observe_batch(ts, tp, 1),
                         t)
        key, sk = jax.random.split(key)
        keys = jax.random.split(sk, 32)
        acts = acts_rng.integers(0, NUM_ACTIONS, (32, 4)).astype(np.int32)
        js, _, _ = _jstep(keys, js, jnp.asarray(acts), jp)
        ts, _, _ = tcore.step_batch(_key(keys), ts, torch.from_numpy(acts), tp)


def test_tstate_roundtrip_matches_jax():
    jp, tp = JParams(grid_size=9, n_drones=4), TParams(grid_size=9,
                                                      n_drones=4)
    js = _jreset(jax.random.PRNGKey(2), jp, 32)
    jt = jfused.to_tstate(js)
    tt = tfused.to_tstate(_torch_state(js))
    for f in tfused.TState._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and (a == b).all(), f
        assert getattr(tt, f).is_contiguous()
    assert_state_equal(js, tfused.from_tstate(tt, tp))
