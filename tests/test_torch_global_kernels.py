"""The tick kernels' plain versions with the global observation against
the JAX kernels in Pallas interpret mode, from the same state, actions,
weights and keys: B4's (``tick_plain``) against ``tick_fused``, and B3's
(``full_tick_plain``) with the actor chain of a dense net and of a conv
net's im2col lowering against ``full_tick_fused`` with ``net_spec``, on
the global 9 x 9 board (486 observation rows): env state, rewards, dones
and actions bitwise, observations bitwise but the charge channel (within
1.3e-7, one ULP of charge / 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.ops import fused_tick as jfused
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick
from tests.test_torch_conv_engines import assert_obs_close

E = 128
KW = dict(grid_size=9, n_drones=4, wrapper="global")
_jreset = jax.jit(jcore.reset_batch, static_argnums=(1, 2))


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _tstate_equal(jt, tt, tag):
    for f, t in zip(fused_tick.TState._fields, tt):
        assert (np.asarray(getattr(jt, f)) == t.numpy()).all(), (tag, f)


def test_tick_plain_global_matches_jax_kernel():
    """B4's plain version against the JAX tick kernel with the global
    encoder (``_encode_obs_global``), 2 ticks of random actions."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    jts = jfused.to_tstate(_jreset(jax.random.PRNGKey(2), jp, E))
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    key = jax.random.PRNGKey(7)
    for t in range(2):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (jp.n_drones, E), 0, 5)
        jout = jfused.tick_fused(step_key, jts, actions, jp, 1, True)
        tout = fused_tick.tick_fused(_host_key(step_key), tts,
                                     from_jax.tensor(actions), tp)
        _tstate_equal(jout[0], tout[0], t)
        for i in (1, 2):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (t, i)
        assert tout[3].shape == (486, E)
        assert_obs_close(jout[3], tout[3], t)
        jts, tts = jout[0], tout[0]


@pytest.mark.parametrize("net", ["dense", "conv"])
def test_full_tick_plain_global_matches_jax_kernel(net):
    """B3's plain version with the actor chain on the global board against
    the JAX full kernel (the conv net through its ``net_spec``), 2 ticks
    with a reset at tick 1, ε = 0.5."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    cfg = (dict(hidden_layers=(16, 16)) if net == "dense" else dict(
        network_type="conv", conv_matmul=True, conv_dense_layers=(16,)))
    ja = JDQN(JConfig(**cfg), jp)
    ta = DQN(DQNConfig(**cfg), tp, device="cpu")
    ag = ja.init_state(jax.random.PRNGKey(0))
    st = from_jax.dqn_state_from_jax(jax.device_get(ag), obs_shape=(9, 9, 6),
                                     conv_specs=ta.config.conv_specs())
    chain = fused_tick.flatten_net_params(st.params, ta.net_spec)
    states = _jreset(jax.random.PRNGKey(1), jp, E)
    jts = jfused.to_tstate(states)
    jobs = jcore.observe_batch(states, jp, 1).reshape(E, -1).T
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    tobs = from_jax.tensor(jax.device_get(jobs)).contiguous()
    key = jax.random.PRNGKey(5)
    for t in range(2):
        key, step_key = jax.random.split(key)
        jout = jfused.full_tick_fused(
            step_key, jts, jobs, ag.params, jnp.float32(0.5),
            jnp.asarray(t == 1), jp, 1, True, net_spec=ja.net_spec)
        tout = fused_tick.full_tick_fused(
            _host_key(step_key), tts, tobs, chain, torch.tensor(0.5),
            t == 1, tp)
        _tstate_equal(jout[0], tout[0], t)
        for i in (1, 2, 3):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (t, i)
        assert_obs_close(jout[4], tout[4], t)
        jts, jobs, tts, tobs = jout[0], jout[4], tout[0], tout[4]
