"""The StreamReplay engines with ``collect_drones`` = 2 against the JAX
trainers.

The full engine (B3) for 4 ticks and the fused engine (B4) for 3, from
one carry carried across by ``interop.from_jax``, resets at ticks 0 and
3, a replay of 3 pushes of E · 2 transitions (the drones' observations
side by side, drone-major): rng chain, env state, the two row groups of
observations, the replay and ε bitwise (the charge channel within
1.3e-7), loss within 1e-5 relative and params within 1e-5 absolute. The
helpers also run these engines with ``--fast_rng``'s round counts
(tests/test_torch_fast_rng_engines.py). Last, B4's plain version on the
window at k = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import replay as jreplay
from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.train import (
    build_train_step_full as jbuild_full,
    build_train_step_fused as jbuild_fused)
from dronerl_tpu_torch import replay, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.interop import from_jax
from tests.test_torch_collect import (
    assert_obs_equal, assert_tstate_equal, env_params, jax_env, run_env_tick)
from tests.test_torch_collect_engines import AGENT, assert_close, flax_leaves

E, BATCH = 128, 8


def run_stream_engine(engine, k, rounds=(20, None)):
    """The full engine for 4 ticks or the fused one for 3 against the JAX
    trainer in interpret mode (the fused engine takes ``rng_rounds``
    only); returns the losses."""
    rng_rounds, actor_rng_rounds = rounds
    jp, tp = env_params()
    ja = JDQN(JConfig(**AGENT), jp)
    ta = DQN(DQNConfig(**AGENT), tp, device="cpu")
    push = E * k
    jbuf = jreplay.StreamReplay(capacity=3 * push, batch_size=BATCH,
                                stride=push)
    tbuf = replay.StreamReplay(3 * push, BATCH, stride=push)
    if engine == "full":
        jtick = jbuild_full(ja, jbuf, jp, E, k, 3, interpret=True,
                            rng_rounds=rng_rounds,
                            actor_rng_rounds=actor_rng_rounds)
        ttick = train.build_train_step_full(ta, tbuf, tp, E, 3, k,
                                            rng_rounds, actor_rng_rounds)
        ticks = 4
    else:
        jtick = jbuild_fused(ja, jbuf, jp, E, k, 3, interpret=True,
                             rng_rounds=rng_rounds)
        ttick = train.build_train_step_fused(ta, tbuf, tp, E, 3, k,
                                             rng_rounds)
        ticks = 3
    rng = jax.random.PRNGKey(0)
    jts, jobs = jax_env(jp, k, seed=0)
    template = {
        "obs": jnp.zeros((ja.obs_dim,), jnp.float32),
        "actions": jnp.array(0, jnp.int32),
        "rewards": jnp.array(0.0, jnp.float32),
        "dones": jnp.array(False, jnp.bool_),
    }
    jc = (rng, jts, jobs, ja.init_state(rng), jbuf.init(template),
          jnp.array(0))
    tc = from_jax.stream_carry_from_jax(jax.device_get(jc))
    fresh = train.init_stream_carry(ta, tp, E, tbuf, tc[0], k)
    assert torch.equal(fresh[2], tc[2])
    losses = []
    for t in range(ticks):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jc_np = jax.device_get(jc)
        tag = (engine, k, rounds, t)
        assert (np.asarray(jc_np[0]).astype(np.int64)
                == tc[0].numpy()).all(), tag
        assert int(jc_np[-1]) == tc[-1] == t + 1
        assert_tstate_equal(jc_np[1], tc[1], tag)
        assert_obs_equal(jc_np[2], tc[2], tag)
        jb, tb = jc_np[4], tc[4]
        assert (int(jb.cursor), int(jb.size)) == (tb.cursor, tb.size), tag
        assert_obs_equal(jb.storage["obs"], tb.storage["obs"], tag)
        for key in ("actions", "rewards", "dones"):
            assert (np.asarray(jb.storage[key])
                    == tb.storage[key].numpy()).all(), (tag, key)
        assert (np.asarray(jrew) == trew.numpy()).all(), tag
        assert np.float32(teps.item()) == np.asarray(jeps), tag
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert_close(tc[3].params.flat(), flax_leaves(jc_np[3].params), tag)
        losses.append(float(tloss))
    return losses


@pytest.mark.parametrize("engine", ["full", "fused"])
def test_stream_engine_collect_matches_jax(engine):
    losses = run_stream_engine(engine, 2)
    # The replay holds a batch from the second push on.
    assert losses[0] == -1.0 and min(losses[1:]) >= 0


def test_env_tick_plain_collect_matches_jax_window4():
    run_env_tick("window", 4)
