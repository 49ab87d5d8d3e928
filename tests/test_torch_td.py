"""The in-kernel TD path: the port's plain versions against the JAX kernel.

One ring tick with ``td_hparams`` (``full_tick_fused_ring``: the tick's
plain version, then ``td_adam_plain``) against the JAX package's ring
kernel with its TD branch in Pallas interpret mode, once with
``can_train`` and once without; then the whole ``in_kernel_td`` slice
(``build_train_step_ring`` / ``init_ring_carry``) for 4 ticks against the
JAX trainer's, from one carry carried across with its ``aux`` batch.
Tolerances: env outputs bitwise, the charge channel within 1.3e-7 (one
ULP of charge / 100); the loss within rtol 1e-6, atol 1e-7 (as
tests/test_fused_tick.py holds the JAX kernel to its XLA learner);
params, mu and nu within rtol 1e-5, atol 1e-6; with ``can_train`` off the
loss exactly -1 and the learner state bitwise unchanged. Also the guards
of the TD path.
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
from dronerl_tpu.train import (
    build_train_step_ring as jbuild, init_ring_carry as jinit)
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick

E, CAP, BATCH = 128, 512, 8
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)
TD_HPARAMS = (0.9, 1e-3, 0.9, 0.999, 1e-8)


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def _tree(leaves):
    return {"params": {f"Dense_{i}": {"kernel": jnp.asarray(leaves[2 * i]),
                                      "bias": jnp.asarray(leaves[2 * i + 1])}
                       for i in range(len(leaves) // 2)}}


def _assert_close(ours, ref, tag):
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=1e-5,
                                   atol=1e-6, err_msg=f"{tag} leaf {i}")


def _assert_env_equal(jout, tout, tag):
    jt, jrew, jdone, jact, jring = jout[:5]
    tt, trew, tdone, tact, tring = tout[:5]
    for f, t in zip(fused_tick.TState._fields, tt):
        assert (np.asarray(getattr(jt, f)) == t.numpy()).all(), (tag, f)
    for j, t in ((jact, tact), (jrew, trew), (jdone, tdone)):
        assert (np.asarray(j) == t.numpy()).all(), tag
    jr = np.asarray(jring).astype(np.float32).reshape(-1, 6, jring.shape[1])
    tr = tring.float().numpy().reshape(-1, 6, tring.shape[1])
    ch = np.arange(6) != 4
    assert (jr[:, ch] == tr[:, ch]).all(), tag
    np.testing.assert_allclose(tr[:, 4], jr[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


@pytest.mark.parametrize("can_train", [True, False])
def test_td_tick_matches_jax(can_train):
    """One bf16-ring tick with the TD branch, ε = 0.5, nonzero moments."""
    jp = JParams(**KW)
    ja = JDQN(JConfig(hidden_layers=(16, 16)), jp)
    ag = ja.init_state(jax.random.PRNGKey(0))
    states = jcore.reset_batch(jax.random.PRNGKey(1), jp, E)
    jts = jfused.to_tstate(states)
    obs0 = jcore.observe_batch(states, jp, 1).reshape(E, ja.obs_dim).T
    jring = jnp.zeros((ja.obs_dim, 2 * E), jnp.bfloat16).at[:, :E].set(
        obs0.astype(jnp.bfloat16))
    r = np.random.default_rng(7)
    shapes = [x.shape for x in _flax_leaves(ag.params)]
    mu = [(1e-3 * r.standard_normal(s)).astype(np.float32) for s in shapes]
    nu = [(1e-6 * r.random(s)).astype(np.float32) for s in shapes]
    batch = {
        "obs": (r.random((ja.obs_dim, BATCH)) < 0.3).astype(np.float32),
        "next_obs": (r.random((ja.obs_dim, BATCH)) < 0.3).astype(np.float32),
        "actions": r.integers(0, 5, BATCH).astype(np.int32),
        "rewards": r.choice([-1.0, 0.0, 1.0], BATCH).astype(np.float32),
        "dones": (r.random(BATCH) < 0.3).astype(np.float32),
    }
    count = 5
    step_key = jax.random.PRNGKey(11)

    jout = jfused.full_tick_fused_ring(
        step_key, jts, jring, jnp.int32(0), jnp.int32(E), ag.params,
        jnp.float32(0.5), jnp.asarray(False), jp, 1, True,
        td_hparams=TD_HPARAMS,
        td_batch={k: jnp.asarray(v) for k, v in batch.items()},
        td_aux=(ag.target_params, _tree(mu), _tree(nu),
                jnp.asarray(can_train), jnp.int32(count)))

    tp = EnvParams(**KW)
    net = from_jax.qnet_from_flax(jax.device_get(ag.params))
    target = from_jax.qnet_from_flax(jax.device_get(ag.target_params))
    tmu = [torch.from_numpy(x.copy()) for x in mu]
    tnu = [torch.from_numpy(x.copy()) for x in nu]
    before = [t.detach().clone() for t in net.flat() + tmu + tnu]
    tout = fused_tick.full_tick_fused_ring(
        torch.from_numpy(np.asarray(step_key).astype(np.int64)),
        from_jax.tstate_from_jax(jax.device_get(jts)),
        from_jax.tensor(jax.device_get(jring)), 0, E, net.flat(),
        torch.tensor(0.5), False, tp, td_hparams=TD_HPARAMS,
        td_batch=from_jax.batch_from_jax(batch),
        td_aux=(net, target, tmu, tnu, can_train, count))
    _assert_env_equal(jout, tout, can_train)
    new_params, new_mu, new_nu, loss = tout[5:]
    assert new_params is net and new_mu is tmu and new_nu is tnu
    jparams, jmu, jnu, jloss = jout[5:]
    if can_train:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                                   atol=1e-7)
        assert float(loss) > 0
        _assert_close(net.flat(), _flax_leaves(jparams), "params")
        _assert_close(tmu, _flax_leaves(jmu), "mu")
        _assert_close(tnu, _flax_leaves(jnu), "nu")
        assert not torch.equal(net.kernels[0], before[0])
    else:
        assert float(loss) == -1.0 == float(jloss)
        after = net.flat() + tmu + tnu
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        for o, r_ in zip(after, _flax_leaves(jparams) + _flax_leaves(jmu)
                         + _flax_leaves(jnu)):
            assert (o.detach().numpy() == r_).all()


def test_in_kernel_td_slice_matches_jax():
    """4 ticks of the in_kernel_td trainer, bf16 ring, (16,16)."""
    kw = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
              target_update_interval=2, gamma=0.9)
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(**kw), jp)
    ta = DQN(DQNConfig(**kw), tp, device="cpu")
    jtick = jbuild(ja, jp, E, CAP, BATCH, reset_env_every=3, interpret=True,
                   in_kernel_td=True)
    jc = jinit(ja, jp, E, CAP, jax.random.PRNGKey(0),
               obs_dtype=jnp.bfloat16, batch_size=BATCH, in_kernel_td=True)
    tc = from_jax.ring_carry_from_jax(jax.device_get(jc))
    assert set(tc[4]) == set(jc[4]) and not tc[4]["obs"].any()
    ttick = train.build_train_step_ring(ta, tp, E, CAP, BATCH, 3,
                                        in_kernel_td=True)
    losses = []
    for t in range(4):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jc_np = jax.device_get(jc)
        assert (np.asarray(jc_np[0]).astype(np.int64)
                == tc[0].numpy()).all(), t
        assert int(jc_np[-1]) == tc[-1] == t + 1
        for f, x in zip(fused_tick.TState._fields, tc[1][0]):
            assert (np.asarray(getattr(jc_np[1][0], f)) == x.numpy()).all(), (
                t, f)
        jring = np.asarray(jc_np[1][1]).astype(np.float32).reshape(
            -1, 6, CAP)
        tring = tc[1][1].float().numpy().reshape(-1, 6, CAP)
        ch = np.arange(6) != 4
        assert (jring[:, ch] == tring[:, ch]).all(), t
        np.testing.assert_allclose(tring[:, 4], jring[:, 4], rtol=0,
                                   atol=CHARGE_ATOL)
        for a, b in zip(jc_np[2], tc[2]):
            assert (np.asarray(a) == b.numpy()).all(), t
        assert (np.asarray(jrew) == trew.numpy()).all(), t
        assert np.float32(teps.item()) == np.asarray(jeps), t
        for k, v in tc[4].items():  # the carried batch: a gather, bitwise
            assert (np.asarray(jc_np[4][k]) == v.numpy()).all(), (t, k)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                                   atol=1e-7)
        losses.append(float(tloss))
        adam = jc_np[3].opt_state[0]
        assert tc[3].opt_state.count == int(adam.count) == t, t
        _assert_close(tc[3].params.flat(), _flax_leaves(jc_np[3].params),
                      f"t={t} params")
        _assert_close(tc[3].opt_state.mu, _flax_leaves(adam.mu), f"t={t} mu")
        _assert_close(tc[3].opt_state.nu, _flax_leaves(adam.nu), f"t={t} nu")
    assert losses[0] == -1.0 and all(x >= 0 for x in losses[1:])


def test_in_kernel_td_guards():
    tp = EnvParams(**KW)
    ta = DQN(DQNConfig(hidden_layers=(16, 16)), tp, device="cpu")
    key = rng.PRNGKey(0)
    with pytest.raises(ValueError, match="batch_size"):
        train.init_ring_carry(ta, tp, E, CAP, key, in_kernel_td=True)
    assert train.init_ring_carry(ta, tp, E, CAP, key, batch_size=8)[4] == ()
    carry = train.init_ring_carry(ta, tp, E, CAP, key, batch_size=8,
                                  in_kernel_td=True)
    aux = carry[4]
    assert set(aux) == {"obs", "next_obs", "actions", "rewards", "dones"}
    assert tuple(aux["obs"].shape) == tuple(aux["next_obs"].shape) == (
        ta.obs_dim, 8)
    assert aux["obs"].dtype == torch.float32
    assert aux["actions"].dtype == torch.int32
    assert all(tuple(aux[k].shape) == (8,)
               for k in ("actions", "rewards", "dones"))
    # TD on a net that is not a dense Q-net raises, as the JAX kernel does
    # for conv nets.
    _, (tstate, ring), _, ag, _, _ = carry
    with pytest.raises(ValueError, match="dense"):
        fused_tick.full_tick_fused_ring(
            rng.PRNGKey(1), tstate, ring, 0, E, ag.params.flat(),
            ag.epsilon, False, tp, td_hparams=TD_HPARAMS, td_batch=aux,
            td_aux=(torch.nn.Linear(294, 5), ag.target_params,
                    ag.opt_state.mu, ag.opt_state.nu, True, 0))
    with pytest.raises(ValueError, match="td_batch"):
        fused_tick.full_tick_fused_ring(
            rng.PRNGKey(1), tstate, ring, 0, E, ag.params.flat(), ag.epsilon,
            False, tp, td_hparams=TD_HPARAMS)
