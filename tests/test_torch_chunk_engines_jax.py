"""The jnp, full and fused engines' chunks (``train.Chunk``) against the JAX
trainer's ``run_chunk``, ``jax.jit(lax.scan(tick))``.

Both trainers start from one carry (the JAX package's, carried across by
``interop.from_jax``) and run a chunk: the jnp engine 8 ticks at 4 envs,
memory 64, batch 8 and a reset every 5, with one and two drones
collected (the sizes of tests/test_torch_jnp.py); the full engine 4 ticks
and the fused one 3 at 128 envs over a StreamReplay of 3 env-batches
(full, then wrapped, by tick 3) with a reset every 3, the JAX kernels in
Pallas interpret mode (the sizes of tests/test_torch_engines.py). The
rng chain, the step, the env state, the replay's storage, cursor and
size, the rewards and ε bitwise, except the observation's charge channel
(within 1.3e-7, one ULP of charge / 100, as those tests hold it); the
loss within 1e-5 relative and the params within 1e-5 absolute (the
learner's tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import replay as jreplay
from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.ops import fused_tick as jfused
from dronerl_tpu.train import (
    build_train_step as jbuild, build_train_step_full as jbuild_full,
    build_train_step_fused as jbuild_fused)
from dronerl_tpu_torch import replay, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.interop import from_jax

KW = dict(grid_size=9, n_drones=4)
AGENT_KW = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
                target_update_interval=2, gamma=0.9)
ENV_FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
CHARGE_ATOL = 1.3e-7
BATCH = 8


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _assert_obs_equal(jobs, tobs, axis, tag):
    """Observations bitwise but the charge channel (channel 4 of 6 on
    ``axis``, the feature axis), within CHARGE_ATOL."""
    j = np.moveaxis(np.asarray(jobs), axis, -1).reshape(-1, 6)
    t = np.moveaxis(tobs.numpy(), axis, -1).reshape(-1, 6)
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def _run_both(jtick, jc, tick, tc, ticks):
    run_chunk = jax.jit(lambda c: jax.lax.scan(jtick, c, None,
                                               length=ticks))
    jc, jouts = jax.device_get(run_chunk(jc))
    tc, touts = train.Chunk(tick)(tc, ticks)
    return jc, jouts, tc, touts


def _assert_common(jc, jouts, tc, touts, ticks, obs_axis):
    """rng, step, the replay, the outputs and the params; returns the
    losses."""
    assert (np.asarray(jc[0]).astype(np.int64) == tc[0].numpy()).all()
    assert int(jc[-1]) == tc[-1] == ticks
    jb, tb = jc[4], tc[4]
    assert (int(jb.cursor), int(jb.size)) == (tb.cursor, tb.size)
    for name, buf in tb.storage.items():
        if name in ("obs", "next_obs"):
            _assert_obs_equal(jb.storage[name], buf, obs_axis, name)
        else:
            assert (np.asarray(jb.storage[name]) == buf.numpy()).all(), name
    jrew, jeps, jloss = jouts
    trew, teps, tloss = touts
    assert (np.asarray(jrew) == trew.numpy()).all()
    assert (np.asarray(jeps) == teps.numpy()).all()
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-7)
    assert tc[3].opt_state.count == int(jc[3].opt_state[0].count)
    for r, o in zip(_flax_leaves(jc[3].params), tc[3].params.flat()):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0, atol=1e-5)
    return tloss.numpy()


@pytest.mark.parametrize("collect_drones", [1, 2])
def test_jnp_chunk_matches_jax_scan(collect_drones):
    k, E, memory, reset, ticks = collect_drones, 4, 64, 5, 8
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(epsilon_decay=0.9, **AGENT_KW), jp)
    ta = DQN(DQNConfig(epsilon_decay=0.9, **AGENT_KW), tp, device="cpu")
    jbuf = jreplay.ReplayBuffer(memory, BATCH, uniform_pushes=True)
    tbuf = replay.ReplayBuffer(memory, BATCH, uniform_pushes=True)
    key = jax.random.PRNGKey(0)
    states = jcore.reset_batch(key, jp, E)
    obs = jcore.observe_batch(states, jp, k).reshape(E, k, ja.obs_dim)
    leaf = jnp.zeros((ja.obs_dim,), jnp.float32)
    jc = (key, states, obs, ja.init_state(key), jbuf.init({
        "obs": leaf, "actions": jnp.array(0, jnp.int32),
        "rewards": jnp.array(0.0, jnp.float32), "next_obs": leaf,
        "dones": jnp.array(False, jnp.bool_)}), jnp.array(0))
    host = jax.device_get(jc)
    tc = (_host_key(host[0]),
          EnvState(*(from_jax.tensor(getattr(host[1], f))
                     for f in ENV_FIELDS)),
          from_jax.tensor(host[2]), from_jax.dqn_state_from_jax(host[3]),
          from_jax.replay_state_from_jax(host[4]), 0)

    jc, jouts, tc, touts = _run_both(
        jbuild(ja, jbuf, jp, E, k, reset),
        jc, train.build_train_step(ta, tbuf, tp, E, reset, k), tc, ticks)
    for f in ENV_FIELDS:
        assert (np.asarray(getattr(jc[1], f))
                == getattr(tc[1], f).numpy()).all(), f
    _assert_obs_equal(jc[2], tc[2], -1, "obs")
    loss = _assert_common(jc, jouts, tc, touts, ticks, -1)
    first = -(-BATCH // (E * k)) - 1  # the first tick that holds a batch
    assert (loss[:first] == -1.0).all() and (loss[first:] >= 0).all()


@pytest.mark.parametrize("engine", ["full", "fused"])
def test_stream_chunk_matches_jax_scan(engine):
    E, reset = 128, 3
    ticks = {"full": 4, "fused": 3}[engine]
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(**AGENT_KW), jp)
    ta = DQN(DQNConfig(**AGENT_KW), tp, device="cpu")
    jbuf = jreplay.StreamReplay(capacity=3 * E, batch_size=BATCH, stride=E)
    tbuf = replay.StreamReplay(3 * E, BATCH, stride=E)
    key = jax.random.PRNGKey(0)
    states = jcore.reset_batch(key, jp, E)
    obs_t = jcore.observe_batch(states, jp, 1).reshape(E, -1).T
    jc = (key, jfused.to_tstate(states), obs_t, ja.init_state(key),
          jbuf.init({"obs": jnp.zeros((ja.obs_dim,), jnp.float32),
                     "actions": jnp.array(0, jnp.int32),
                     "rewards": jnp.array(0.0, jnp.float32),
                     "dones": jnp.array(False, jnp.bool_)}), jnp.array(0))
    tc = from_jax.stream_carry_from_jax(jax.device_get(jc))
    jb, tb = {"full": (jbuild_full, train.build_train_step_full),
              "fused": (jbuild_fused, train.build_train_step_fused)}[engine]

    jc, jouts, tc, touts = _run_both(
        jb(ja, jbuf, jp, E, 1, reset, interpret=True), jc,
        tb(ta, tbuf, tp, E, reset), tc, ticks)
    for f, x in zip(type(tc[1])._fields, tc[1]):
        assert (np.asarray(getattr(jc[1], f)) == x.numpy()).all(), f
    _assert_obs_equal(jc[2], tc[2], 0, "obs_t")
    loss = _assert_common(jc, jouts, tc, touts, ticks, 0)
    # The replay holds a batch from the second push on; it wraps at tick 3.
    assert loss[0] == -1.0 and (loss[1:] >= 0).all()
    assert (tc[4].cursor, tc[4].size) == (ticks * E % (3 * E), 3 * E)
