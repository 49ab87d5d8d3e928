"""The fused ring tick: the port's plain version against the JAX kernel.

``full_tick_ring_plain`` (the CUDA kernel's plain PyTorch version, which
the kernel is held to on the card) runs against the JAX package's
``full_tick_fused_ring`` in Pallas interpret mode, from the same state,
ring, weights and key: env outputs bitwise except the charge channel
(within 1.3e-7, one ULP of charge / 100), actions equal. The kernel
itself runs only on a CUDA card (tests/test_torch_kernel.py).
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
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick

E = 128
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _setup(obs_dtype, hidden=(16, 16)):
    jp = JParams(**KW)
    ja = JDQN(JConfig(hidden_layers=hidden), jp)
    ag = ja.init_state(jax.random.PRNGKey(0))
    states = jcore.reset_batch(jax.random.PRNGKey(1), jp, E)
    tstate = jfused.to_tstate(states)
    obs0 = jcore.observe_batch(states, jp, 1).reshape(E, ja.obs_dim).T
    ring = jnp.zeros((ja.obs_dim, 2 * E), obs_dtype).at[:, :E].set(
        obs0.astype(obs_dtype))
    return jp, ja, ag, tstate, ring


def _assert_tick_equal(jout, tout, tag):
    jt, jrew, jdone, jact, jring = jout
    tt, trew, tdone, tact, tring = tout
    for f, t in zip(fused_tick.TState._fields, tt):
        assert (np.asarray(getattr(jt, f)) == t.numpy()).all(), (tag, f)
    assert (np.asarray(jact) == tact.numpy()).all(), tag
    assert (np.asarray(jrew) == trew.numpy()).all(), tag
    assert (np.asarray(jdone) == tdone.numpy()).all(), tag
    jr = np.asarray(jring).astype(np.float32).reshape(-1, 6, 2 * E)
    tr = tring.float().numpy().reshape(-1, 6, 2 * E)
    ch = np.arange(6) != 4
    assert (jr[:, ch] == tr[:, ch]).all(), tag
    np.testing.assert_allclose(tr[:, 4], jr[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_tick_matches_jax_kernel(dtype):
    """4 ticks, one of them a reset, ε = 0.5 (greedy and exploring envs)."""
    jdtype = jnp.dtype(dtype)
    jp, ja, ag, jts, jring = _setup(jdtype)
    tp = EnvParams(**KW)
    net = from_jax.qnet_from_flax(jax.device_get(ag.params))
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    tring = from_jax.tensor(jax.device_get(jring))
    assert tring.dtype == getattr(torch, dtype)
    eps = 0.5
    key = jax.random.PRNGKey(5)
    for t in range(4):
        key, step_key = jax.random.split(key)
        read, write = (t % 2) * E, ((t + 1) % 2) * E
        do_reset = t == 2
        jout = jfused.full_tick_fused_ring(
            step_key, jts, jring, jnp.int32(read), jnp.int32(write),
            ag.params, jnp.float32(eps), jnp.asarray(do_reset), jp,
            interpret=True)
        before = tring.clone()
        tout = fused_tick.full_tick_fused_ring(
            _host_key(step_key), tts, tring, read, write, net.flat(),
            torch.tensor(eps), do_reset, tp)
        _assert_tick_equal(jout, tout, (dtype, t))
        assert torch.equal(tring[:, read:read + E], before[:, read:read + E])
        jts, jring, tts = jout[0], jout[4], tout[0]


def test_plain_actions_explore_and_greedy():
    """ε = 0: the greedy actor everywhere; ε = 1: random actions only."""
    _, ja, ag, _, jring = _setup(jnp.float32)
    tp = EnvParams(**KW)
    net = from_jax.qnet_from_flax(jax.device_get(ag.params))
    tring = from_jax.tensor(jax.device_get(jring))
    key = rng.split(rng.PRNGKey(3), E + 2)[E]
    greedy, q = fused_tick.plain_actions(key, tring, 0, net.flat(),
                                         torch.tensor(0.0), tp, E)
    ref_q = np.asarray(ja.q_values_t(ag.params, jring[:, :E]))
    np.testing.assert_allclose(q.numpy(), ref_q, rtol=1e-6, atol=1e-6)
    assert (greedy[0].numpy() == ref_q.argmax(axis=0)).all()
    random, _ = fused_tick.plain_actions(key, tring, 0, net.flat(),
                                         torch.tensor(1.0), tp, E)
    u, rand = fused_tick.actor_uniforms(key, tp.n_drones, E)
    assert torch.equal(random, rand) and torch.equal(greedy[1:], rand[1:])
    assert int(random.min()) >= 0 and int(random.max()) <= 4


def test_ring_scalar_writes_and_gather_match_jax():
    cap, bs = 4 * E, 8
    r = np.random.default_rng(0)
    ring = r.random((294, cap)).astype(np.float32)
    a_ring = r.integers(0, 5, cap).astype(np.int32)
    r_ring = r.random(cap).astype(np.float32)
    d_ring = r.integers(0, 2, cap).astype(np.int8)
    acts = r.integers(0, 5, (4, E)).astype(np.int32)
    rews = r.random((4, E)).astype(np.float32)
    dones = r.random((4, E)) < 0.5
    read = 2 * E
    ja, jr, jd = jfused.ring_scalar_writes(
        jnp.asarray(a_ring), jnp.asarray(r_ring), jnp.asarray(d_ring),
        jnp.asarray(acts), jnp.asarray(rews), jnp.asarray(dones), read, 1)
    ta, tr, td = (torch.from_numpy(x.copy()) for x in (a_ring, r_ring, d_ring))
    fused_tick.ring_scalar_writes(ta, tr, td, torch.from_numpy(acts),
                                  torch.from_numpy(rews),
                                  torch.from_numpy(dones), read)
    for j, t in ((ja, ta), (jr, tr), (jd, td)):
        assert (np.asarray(j) == t.numpy()).all()
    for seed, valid, base in ((0, 3 * E, 5), (1, E, 0), (2, 3 * E, 2)):
        key = jax.random.PRNGKey(seed)
        jb = jfused.ring_gather_batch(
            key, jnp.asarray(ring), ja, jr, jd, jnp.int32(valid),
            jnp.int32(base), num_envs=E, capacity=cap, batch_size=bs,
            collect=1, obs_dim=294)
        tb = fused_tick.ring_gather_batch(
            rng.PRNGKey(seed), torch.from_numpy(ring), ta, tr, td, valid,
            base, num_envs=E, capacity=cap, batch_size=bs)
        for k in ("obs", "next_obs", "actions", "rewards", "dones"):
            assert (np.asarray(jb[k]) == tb[k].numpy()).all(), (seed, k)
