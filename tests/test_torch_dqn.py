"""The port's dense DQN learner against ``dronerl_tpu.agents.dqn``.

Weights and optimizer state are carried across with
``dronerl_tpu_torch.interop.from_jax``, so that each learner check starts
from the same state whatever the init (``DQN.init_state`` given a key
draws the JAX nets bitwise, tests/test_torch_jnp.py). Tolerances: the Q forward within 1e-6 relative (one f32 matmul
chain, summed in another order); the TD loss within 1e-5 relative; params
and Adam moments within 1e-5 absolute over 4 steps (Adam's first step
maps any gradient, however small, to about ±lr, so a 1-ULP gradient
difference moves a param by at most a few ULP of lr); ε bitwise, and
the target net bitwise equal to the branch the schedule selects (the
online net's own values differ from JAX's within the learner tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig, DenseQNet
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax

HIDDEN = [(16, 16), (32,), (24, 12, 8)]


def _agents(hidden, **kw):
    cfg = dict(hidden_layers=hidden, gamma=0.9, learning_rate=1e-3, **kw)
    jp, tp = JParams(grid_size=9, n_drones=4), EnvParams(grid_size=9,
                                                         n_drones=4)
    return JDQN(JConfig(**cfg), jp), DQN(DQNConfig(**cfg), tp, device="cpu")


def _batch(obs_dim, bsz, seed):
    r = np.random.default_rng(seed)
    return {
        "obs": (r.random((obs_dim, bsz)) < 0.3).astype(np.float32),
        "next_obs": (r.random((obs_dim, bsz)) < 0.3).astype(np.float32),
        "actions": r.integers(0, 5, bsz).astype(np.int32),
        "rewards": r.choice([-1.0, 0.0, 1.0, -0.1], bsz).astype(np.float32),
        "dones": (r.random(bsz) < 0.2).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flax_leaves(tree):
    layers = tree["params"]
    out = []
    for i in range(len(layers)):
        out += [np.asarray(layers[f"Dense_{i}"]["kernel"]),
                np.asarray(layers[f"Dense_{i}"]["bias"])]
    return out


@pytest.mark.parametrize("hidden", HIDDEN)
def test_q_values_t(hidden):
    ja, ta = _agents(hidden)
    js = ja.init_state(jax.random.PRNGKey(0))
    net = from_jax.qnet_from_flax(jax.device_get(js.params))
    obs = _batch(ja.obs_dim, 64, 1)["obs"]
    ref = np.asarray(ja.q_values_t(js.params, jnp.asarray(obs)))
    with torch.no_grad():
        ours = ta.q_values_t(net, torch.from_numpy(obs)).numpy()
        row = net(torch.from_numpy(obs.T.copy())).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(row, ours.T)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_train_step_t_four_steps(hidden):
    ja, ta = _agents(hidden)
    js = ja.init_state(jax.random.PRNGKey(1))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    for step in range(4):
        batch = _batch(ja.obs_dim, 8, 10 + step)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        js, jloss = ja.train_step_t(js, jbatch)
        ts, tloss = ta.train_step_t(ts, _torch_batch(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        adam = js.opt_state[0]
        assert ts.opt_state.count == int(adam.count) == step + 1
        for name, ref, ours in (
                ("params", _flax_leaves(js.params), ts.params.flat()),
                ("mu", _flax_leaves(adam.mu), ts.opt_state.mu),
                ("nu", _flax_leaves(adam.nu), ts.opt_state.nu)):
            for r, o in zip(ref, ours):
                np.testing.assert_allclose(
                    o.detach().numpy(), r, rtol=0, atol=1e-5,
                    err_msg=f"{name} step {step}")
    # the target net is untouched by the learner step
    for r, o in zip(_flax_leaves(js.target_params),
                    ts.target_params.flat()):
        np.testing.assert_array_equal(o.detach().numpy(), r)


@pytest.mark.parametrize("tau", [1.0, 0.25])
def test_apply_schedules(tau):
    ja, ta = _agents((16, 16), epsilon_decay_every=3, epsilon_decay=0.8,
                     epsilon_end=0.5, target_update_interval=2, tau=tau)
    js = ja.init_state(jax.random.PRNGKey(2))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    for step in range(10):
        # move the online net so that a sync is visible
        batch = _batch(ja.obs_dim, 8, step)
        js, _ = ja.train_step_t(js, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        ts, _ = ta.train_step_t(ts, _torch_batch(batch))
        before = [p.detach().clone() for p in ts.target_params.flat()]
        js = ja.apply_schedules(js, jnp.asarray(step), jnp.asarray(False))
        ts = ta.apply_schedules(ts, step, torch.tensor(False))
        assert ts.epsilon.dtype == torch.float32
        assert (np.float32(ts.epsilon.item())
                == np.asarray(js.epsilon)), step
        synced = step % 2 == 0
        for o, b, p, r in zip(ts.target_params.flat(), before,
                              ts.params.flat(),
                              _flax_leaves(js.target_params)):
            if not synced:
                assert torch.equal(o, b), step
            elif tau == 1.0:
                assert torch.equal(o, p), step
            else:
                assert torch.equal(o, tau * p + (1.0 - tau) * b), step
            np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                       atol=1e-5)
    assert float(ts.epsilon) == pytest.approx(0.5)  # clamped at the end


def test_epsilon_decays_on_done_without_period():
    ja, ta = _agents((16,), epsilon_decay=0.5)
    js = ja.init_state(jax.random.PRNGKey(3))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    for step, done in enumerate([False, True, True, False]):
        js = ja.apply_schedules(js, jnp.asarray(step), jnp.asarray(done))
        ts = ta.apply_schedules(ts, step, torch.tensor(done))
        assert np.float32(ts.epsilon.item()) == np.asarray(js.epsilon)
    assert float(ts.epsilon) == 0.25


def test_init_state():
    _, ta = _agents((128, 64))
    s1 = ta.init_state(torch.Generator().manual_seed(0))
    s2 = ta.init_state(torch.Generator().manual_seed(0))
    for a, b in zip(s1.params.flat(), s2.params.flat()):
        assert torch.equal(a, b)
    # the target net is initialised independently of the online net
    assert not torch.equal(s1.params.kernels[0], s1.target_params.kernels[0])
    assert [tuple(w.shape) for w in s1.params.kernels] == [
        (294, 128), (128, 64), (64, 5)]
    for b in s1.params.biases:
        assert not b.any()
    # he-normal (truncated) scale on the first kernel: std ≈ sqrt(2 / 294)
    std = float(s1.params.kernels[0].detach().std())
    assert abs(std - np.sqrt(2 / 294)) < 0.1 * np.sqrt(2 / 294)
    assert s1.opt_state.count == 0 and float(s1.epsilon) == 1.0


def test_flax_roundtrip():
    ja, _ = _agents((16, 8))
    params = jax.device_get(ja.init_state(jax.random.PRNGKey(4)).params)
    net = from_jax.qnet_from_flax(params)
    assert isinstance(net, DenseQNet) and net.n_layers == 3
    back = from_jax.qnet_to_flax(net)
    for a, b in zip(_flax_leaves(params), _flax_leaves(back)):
        np.testing.assert_array_equal(a, b)
