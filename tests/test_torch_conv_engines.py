"""The trainers with a conv Q-net against the JAX trainers.

Two ticks of each engine with dqn-agent-5's architecture (a 3x3 conv of 8
channels with padding 1, then Dense 16) at 128 envs, from one carry
carried across by ``interop.from_jax``: the ring and full engines with
``conv_matmul`` (the im2col chain in the tick kernels' plain versions),
the fused engine with the conv module (the actor outside the kernel).
The JAX trainers run their Pallas kernels in interpret mode. The rng
chain, env state, observations, rings and replay bitwise (the charge
channel within 1.3e-7), rewards and ε bitwise, loss within rtol 1e-5,
params within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dronerl_tpu import replay as jreplay
from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.ops import fused_tick as jfused
from dronerl_tpu.train import (
    build_train_step_full as jbuild_full,
    build_train_step_fused as jbuild_fused,
    build_train_step_ring as jbuild_ring, init_ring_carry as jinit_ring)
from dronerl_tpu_torch import replay, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick

E, BATCH, TICKS = 128, 8, 2
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)
AGENT_KW = dict(epsilon_decay_every=2, target_update_interval=2, gamma=0.9)
CONV5 = dict(network_type="conv", conv_dense_layers=(16,))


def jax_stream_carry(ja, jp):
    """The JAX StreamReplay engines' initial carry from PRNGKey(0) and the
    replay's template."""
    rng_key = jax.random.PRNGKey(0)
    states = jcore.reset_batch(rng_key, jp, E)
    obs_t = jcore.observe_batch(states, jp, 1).reshape(E, -1).T
    template = {
        "obs": jnp.zeros((ja.obs_dim,), jnp.float32),
        "actions": jnp.array(0, jnp.int32),
        "rewards": jnp.array(0.0, jnp.float32),
        "dones": jnp.array(False, jnp.bool_),
    }
    return rng_key, jfused.to_tstate(states), obs_t, ja.init_state(rng_key), \
        template


def assert_obs_close(jobs, tobs, tag):
    j = np.asarray(jobs).astype(np.float32).reshape(-1, 6, jobs.shape[-1])
    t = tobs.float().numpy().reshape(-1, 6, tobs.shape[-1])
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def run_engines(engine, net, wrapper="window", ticks=TICKS):
    """``ticks`` ticks of the JAX and the port's ``engine`` from one carry,
    compared after each."""
    jp, tp = JParams(wrapper=wrapper, **KW), EnvParams(wrapper=wrapper, **KW)
    ja, ta = JDQN(JConfig(**net, **AGENT_KW), jp), DQN(
        DQNConfig(**net, **AGENT_KW), tp, device="cpu")
    carried = dict(obs_shape=tp.obs_shape,
                   conv_specs=ta.config.conv_specs())
    if engine == "ring":
        jtick = jbuild_ring(ja, jp, E, 4 * E, BATCH, reset_env_every=3,
                            interpret=True)
        jc = jinit_ring(ja, jp, E, 4 * E, jax.random.PRNGKey(0),
                        obs_dtype=jnp.bfloat16, batch_size=BATCH)
        tc = from_jax.ring_carry_from_jax(jax.device_get(jc), **carried)
        ttick = train.build_train_step_ring(ta, tp, E, 4 * E, BATCH, 3)
    else:
        jbuf = jreplay.StreamReplay(capacity=3 * E, batch_size=BATCH,
                                    stride=E)
        rng_key, tstate, obs_t, ag, template = jax_stream_carry(ja, jp)
        jc = (rng_key, tstate, obs_t, ag, jbuf.init(template), jnp.array(0))
        jtick = (jbuild_full if engine == "full" else jbuild_fused)(
            ja, jbuf, jp, E, 1, 3, interpret=True)
        tc = from_jax.stream_carry_from_jax(jax.device_get(jc), **carried)
        build = (train.build_train_step_full if engine == "full"
                 else train.build_train_step_fused)
        ttick = build(ta, replay.StreamReplay(3 * E, BATCH, stride=E), tp, E,
                      3)
    for t in range(ticks):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jn = jax.device_get(jc)
        assert (np.asarray(jn[0]).astype(np.int64) == tc[0].numpy()).all()
        assert int(jn[-1]) == tc[-1] == t + 1
        jstate, tstate = (jn[1][0], tc[1][0]) if engine == "ring" else (
            jn[1], tc[1])
        for f, x in zip(fused_tick.TState._fields, tstate):
            assert (np.asarray(getattr(jstate, f)) == x.numpy()).all(), (t, f)
        if engine == "ring":
            assert_obs_close(jn[1][1], tc[1][1], t)
            for a, b in zip(jn[2], tc[2]):
                assert (np.asarray(a) == b.numpy()).all(), t
        else:
            assert_obs_close(jn[2], tc[2], t)
            assert_obs_close(jn[4].storage["obs"], tc[4].storage["obs"], t)
        assert (np.asarray(jrew) == trew.numpy()).all(), t
        assert np.float32(teps.item()) == np.asarray(jeps), t
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        ref = from_jax.qnet_from_flax(jn[3].params, **carried)
        for a, b in zip(tc[3].params.flat(), ref.flat()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0,
                                       atol=1e-5, err_msg=str((engine, t)))


@pytest.mark.parametrize("engine", ["ring", "full", "fused"])
def test_conv_engine_matches_jax(engine):
    run_engines(engine, dict(CONV5, conv_matmul=engine != "fused"))
