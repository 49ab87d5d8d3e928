"""The ring engine with ``collect_drones`` = 2 against the JAX trainer.

Both trainers start from one carry (the JAX package's, carried across by
``interop.from_jax``) and run 4 ticks with a reset among them, the
default path and the ``in_kernel_td`` path: the rng chain, the slots,
the (2, columns) scalar rings, env state, rewards and dones bitwise; the
ring's two row groups bitwise except the charge channel (1.3e-7); loss
within 1e-5 relative and params within 1e-5 absolute (the learner's
tolerances, as tests/test_torch_train.py). The helpers here also run the
ring engine with ``--fast_rng``'s round counts
(tests/test_torch_fast_rng_engines.py). Last, B1's plain version on the
global board at k = 2 (tests/test_torch_collect.py has the others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.train import (
    build_train_step_ring as jbuild, init_ring_carry as jinit)
from dronerl_tpu_torch import train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.interop import from_jax
from tests.test_torch_collect import (
    assert_obs_equal, assert_tstate_equal, env_params, run_ring_tick)

E, CAP, BATCH = 128, 512, 8
AGENT = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
             target_update_interval=2, gamma=0.9)


def flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def assert_close(ours, ref, tag):
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0, atol=1e-5,
                                   err_msg=str(tag))


def run_ring_engine(k, rounds=(20, None), in_kernel_td=False, ticks=4):
    """``ticks`` ticks of the ring engine, reset every 3, against the JAX
    trainer in interpret mode; returns the losses."""
    rng_rounds, actor_rng_rounds = rounds
    jp, tp = env_params()
    ja = JDQN(JConfig(**AGENT), jp)
    ta = DQN(DQNConfig(**AGENT), tp, device="cpu")
    jtick = jbuild(ja, jp, E, CAP, BATCH, reset_env_every=3, interpret=True,
                   collect_drones=k, in_kernel_td=in_kernel_td,
                   rng_rounds=rng_rounds, actor_rng_rounds=actor_rng_rounds)
    jc = jinit(ja, jp, E, CAP, jax.random.PRNGKey(0),
               obs_dtype=jnp.bfloat16, collect_drones=k, batch_size=BATCH,
               in_kernel_td=in_kernel_td)
    tc = from_jax.ring_carry_from_jax(jax.device_get(jc))
    ttick = train.build_train_step_ring(
        ta, tp, E, CAP, BATCH, 3, k, in_kernel_td=in_kernel_td,
        rng_rounds=rng_rounds, actor_rng_rounds=actor_rng_rounds)
    fresh = train.init_ring_carry(ta, tp, E, CAP, tc[0], torch.bfloat16,
                                  BATCH, in_kernel_td, k)
    assert all(a.shape == b.shape for a, b in zip(fresh[2], tc[2]))
    assert torch.equal(fresh[1][1], tc[1][1])
    losses = []
    for t in range(ticks):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jc_np = jax.device_get(jc)
        tag = (k, rounds, in_kernel_td, t)
        assert (np.asarray(jc_np[0]).astype(np.int64)
                == tc[0].numpy()).all(), tag
        assert int(jc_np[-1]) == tc[-1] == t + 1
        assert_tstate_equal(jc_np[1][0], tc[1][0], tag)
        assert_obs_equal(jc_np[1][1], tc[1][1], tag)
        for a, b in zip(jc_np[2], tc[2]):
            assert (np.asarray(a) == b.numpy()).all(), tag
        assert (np.asarray(jrew) == trew.numpy()).all(), tag
        assert np.float32(teps.item()) == np.asarray(jeps), tag
        if in_kernel_td:  # the carried batch: a gather, bitwise
            for key, v in tc[4].items():
                assert (np.asarray(jc_np[4][key]) == v.numpy()).all(), (
                    tag, key)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert_close(tc[3].params.flat(), flax_leaves(jc_np[3].params), tag)
        losses.append(float(tloss))
    return losses


@pytest.mark.parametrize("in_kernel_td", [False, True],
                         ids=["default", "in_kernel_td"])
def test_ring_engine_collect_matches_jax(in_kernel_td):
    losses = run_ring_engine(2, in_kernel_td=in_kernel_td)
    first = 1 if in_kernel_td else 0  # tick 0 never trains in-kernel
    assert losses[:first] == [-1.0] * first and min(losses[first:]) >= 0


def test_ring_tick_plain_collect_matches_jax_global2():
    run_ring_tick("global", 2)


def test_ring_engine_collect_checks():
    """The batch must be a multiple of k, as in the JAX trainer; k = 2
    builds and carries two row groups and (2, columns) scalar rings."""
    _, tp = env_params()
    ta = DQN(DQNConfig(hidden_layers=(16,)), tp, device="cpu")
    with pytest.raises(ValueError, match="multiple of collect_drones"):
        train.build_train_step_ring(ta, tp, E, CAP, 9, 100, 2)
    carry = train.init_ring_carry(ta, tp, E, CAP,
                                  torch.tensor([0, 3], dtype=torch.int64),
                                  collect_drones=2)
    assert tuple(carry[1][1].shape) == (2 * 294, CAP)
    assert [tuple(r.shape) for r in carry[2]] == [(2, CAP)] * 3
