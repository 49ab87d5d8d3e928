"""The global observation (``wrapper="global"``) against the JAX package.

* ``env.core.observe_batch`` (``_observe_global``): the whole board, the
  same grid for every drone, bitwise but the charge channel (within
  1.3e-7, one ULP of charge / 100), after a reset and along random steps,
  on grid 9 with 4 drones, grid 8 with 3 and a tight board;
* two ticks of the ring engine with a dense net on the global board
  against the JAX ring trainer;
* the CLI's ``--wrapper global`` on the jnp and ring engines.

The tick kernels' plain versions with the global encoder are held to the
JAX kernels in ``tests/test_torch_global_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu_torch import train
from dronerl_tpu_torch.env import core as tcore
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.ops import fused_tick
from tests.test_torch_conv_engines import run_engines

CHARGE_ATOL = 1.3e-7
FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
BOARDS = {
    "grid9": dict(grid_size=9, n_drones=4),
    "grid8": dict(grid_size=8, n_drones=3),
    # 16 objects and 3 drones on 25 cells: respawns crowd the board.
    "tight": dict(grid_size=5, n_drones=3, packets_factor=2,
                  dropzones_factor=1, stations_factor=1,
                  skyscrapers_factor=1),
}
_jreset = jax.jit(jcore.reset_batch, static_argnums=(1, 2))
_jstep = jax.jit(jcore.step_batch, static_argnums=(3,))
_jobserve = jax.jit(jcore.observe_batch, static_argnums=(1, 2))


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _torch_state(js) -> EnvState:
    return EnvState(*(torch.from_numpy(np.array(getattr(js, f)))
                      for f in FIELDS))


def _assert_obs(jo, to, tag):
    jo, to = np.asarray(jo), to.numpy()
    assert jo.shape == to.shape and to.dtype == np.float32, tag
    ch = np.arange(6) != 4
    assert (jo[..., ch] == to[..., ch]).all(), tag
    np.testing.assert_allclose(to[..., 4], jo[..., 4], rtol=0,
                               atol=CHARGE_ATOL, err_msg=str(tag))


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_observe_global_matches_jax(board):
    """10 ticks of random actions from a reset: every drone's global view
    (and the first drone's, ``limit`` = 1) after each."""
    kw = dict(BOARDS[board], wrapper="global")
    jp, tp = JParams(**kw), EnvParams(**kw)
    key = jax.random.PRNGKey(8)
    js = _jreset(key, jp, 64)
    ts = _torch_state(js)
    acts_rng = np.random.default_rng(2)
    for t in range(10):
        _assert_obs(_jobserve(js, jp, None), tcore.observe_batch(ts, tp),
                    (board, t))
        _assert_obs(_jobserve(js, jp, 1), tcore.observe_batch(ts, tp, 1),
                    (board, t))
        key, sk = jax.random.split(key)
        keys = jax.random.split(sk, 64)
        acts = acts_rng.integers(0, 5, (64, jp.n_drones)).astype(np.int32)
        js, _, _ = _jstep(keys, js, jnp.asarray(acts), jp)
        ts, _, _ = tcore.step_batch(_host_key(keys), ts,
                                    torch.from_numpy(acts), tp)
    obs = tcore.observe_batch(ts, tp)
    assert tuple(obs.shape) == (64, jp.n_drones, jp.grid_size,
                                jp.grid_size, 6)
    assert torch.equal(obs[:, 0], obs[:, -1])  # one grid for every drone


def test_ring_engine_global_matches_jax():
    run_engines("ring", dict(hidden_layers=(16, 16)), wrapper="global")


def test_cli_global_flags():
    """``--wrapper global`` reaches the env and the obs size: 9 x 9 x 6 on
    the default board; the jnp engine below 128 envs and the ring engine
    at 128 run on the CPU."""
    args = train.parse_args(["--device", "cpu", "--wrapper", "global"])
    env = train.env_params_from_args(args)
    assert env.wrapper == "global" and env.obs_shape == (9, 9, 6)
    assert fused_tick.kernel_problems(env, 128) == []
    for num_envs, engine in ((64, "jnp"), (128, "ring")):
        metrics = train.main([
            "--device", "cpu", "--wrapper", "global", "--num_envs",
            str(num_envs), "--num_steps", "3", "--memory_size", "256"])
        assert metrics["engine"] == engine
        assert np.isfinite(metrics["td_loss_mean"])
