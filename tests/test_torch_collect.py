"""``collect_drones > 1``: the tick kernels' plain versions, the ring's
companions, the engine gate and the CLI against the JAX package.

The plain versions of B1 (``full_tick_ring_plain``), B3
(``full_tick_plain``) and B4 (``tick_plain``) with ``collect`` = k run
against the JAX kernels in Pallas interpret mode from the same state,
ring, weights and keys, on the window at k = 2 and 4 and on the global
board at k = 2: env state, rewards, dones and actions bitwise, every one
of the k observation row groups bitwise but the charge channel (within
1.3e-7, one ULP of charge / 100). Then ``ring_scalar_writes`` and
``ring_gather_batch`` at k = 2 bitwise, the CLI's engine choice against
the JAX gate for k in {1, 2, 4} and odd batches, and the CLI's checks.
The engines with k = 2 are in tests/test_torch_collect_engines.py.
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
from dronerl_tpu.train import ring_skip_reasons as jring_skip_reasons
from dronerl_tpu_torch import rng, train
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick

E = 128
CHARGE_ATOL = 1.3e-7


def host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def env_params(wrapper="window"):
    kw = dict(grid_size=9, n_drones=4, wrapper=wrapper)
    return JParams(**kw), EnvParams(**kw)


def assert_tstate_equal(jt, tt, tag):
    for f, t in zip(fused_tick.TState._fields, tt):
        assert (np.asarray(getattr(jt, f)) == t.numpy()).all(), (tag, f)


def assert_obs_equal(jobs, tobs, tag):
    """Feature-major observations (any number of row groups) bitwise
    except the charge channel."""
    j = np.asarray(jobs).astype(np.float32).reshape(-1, 6, jobs.shape[-1])
    t = tobs.float().numpy().reshape(-1, 6, tobs.shape[-1])
    assert j.shape == t.shape, tag
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def jax_env(jp, k, seed=1, num_envs=E):
    """Reset envs and the first k drones' observations (k · obs_dim, E)."""
    states = jcore.reset_batch(jax.random.PRNGKey(seed), jp, num_envs)
    obs = jcore.observe_batch(states, jp, k).reshape(num_envs, -1).T
    return jfused.to_tstate(states), obs


def jax_net(jp, hidden=(16,)):
    ja = JDQN(JConfig(hidden_layers=hidden), jp)
    ag = ja.init_state(jax.random.PRNGKey(0))
    return ag, from_jax.qnet_from_flax(jax.device_get(ag.params)).flat()


def run_ring_tick(wrapper, k, rounds=(20, None), ticks=3, reset_tick=1):
    """B1's plain version against the JAX ring kernel: a bf16 ring of two
    env-batches, ε = 0.5, ``ticks`` ticks with a reset at ``reset_tick``."""
    rng_rounds, actor_rng_rounds = rounds
    jp, tp = env_params(wrapper)
    ag, chain = jax_net(jp)
    jts, obs0 = jax_env(jp, k)
    jring = jnp.zeros((obs0.shape[0], 2 * E), jnp.bfloat16).at[:, :E].set(
        obs0.astype(jnp.bfloat16))
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    tring = from_jax.tensor(jax.device_get(jring))
    key = jax.random.PRNGKey(5)
    for t in range(ticks):
        key, step_key = jax.random.split(key)
        read, write = (t % 2) * E, ((t + 1) % 2) * E
        jout = jfused.full_tick_fused_ring(
            step_key, jts, jring, jnp.int32(read), jnp.int32(write),
            ag.params, jnp.float32(0.5), jnp.asarray(t == reset_tick), jp,
            k, True, rng_rounds=rng_rounds, actor_rng_rounds=actor_rng_rounds)
        before = tring[:, read:read + E].clone()
        tout = fused_tick.full_tick_fused_ring(
            host_key(step_key), tts, tring, read, write, chain,
            torch.tensor(0.5), t == reset_tick, tp, k, rng_rounds=rng_rounds,
            actor_rng_rounds=actor_rng_rounds)
        tag = (wrapper, k, rounds, t)
        assert_tstate_equal(jout[0], tout[0], tag)
        for i in (1, 2, 3):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (tag, i)
        assert tuple(tout[4].shape) == (k * fused_tick.obs_rows(tp), 2 * E)
        assert_obs_equal(jout[4], tout[4], tag)
        assert torch.equal(tring[:, read:read + E], before), tag
        jts, jring, tts = jout[0], jout[4], tout[0]


def run_full_tick(wrapper, k, rounds=(20, None), ticks=3, reset_tick=1):
    """B3's plain version against the JAX full kernel, as
    :func:`run_ring_tick`, on (k · obs_dim, E) f32 observations."""
    rng_rounds, actor_rng_rounds = rounds
    jp, tp = env_params(wrapper)
    ag, chain = jax_net(jp)
    jts, jobs = jax_env(jp, k)
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    tobs = from_jax.tensor(jax.device_get(jobs)).contiguous()
    key = jax.random.PRNGKey(5)
    for t in range(ticks):
        key, step_key = jax.random.split(key)
        jout = jfused.full_tick_fused(
            step_key, jts, jobs, ag.params, jnp.float32(0.5),
            jnp.asarray(t == reset_tick), jp, k, True, rng_rounds=rng_rounds,
            actor_rng_rounds=actor_rng_rounds)
        tout = fused_tick.full_tick_fused(
            host_key(step_key), tts, tobs, chain, torch.tensor(0.5),
            t == reset_tick, tp, k, rng_rounds, actor_rng_rounds)
        tag = (wrapper, k, rounds, t)
        assert_tstate_equal(jout[0], tout[0], tag)
        for i in (1, 2, 3):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (tag, i)
        assert_obs_equal(jout[4], tout[4], tag)
        jts, jobs, tts, tobs = jout[0], jout[4], tout[0], tout[4]


def run_env_tick(wrapper, k, rng_rounds=20, ticks=3):
    """B4's plain version against the JAX tick kernel, random actions."""
    jp, tp = env_params(wrapper)
    jts, _ = jax_env(jp, k, seed=2)
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    key = jax.random.PRNGKey(7)
    for t in range(ticks):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (jp.n_drones, E), 0, 5)
        jout = jfused.tick_fused(step_key, jts, actions, jp, k, True,
                                 rng_rounds=rng_rounds)
        tout = fused_tick.tick_fused(host_key(step_key), tts,
                                     from_jax.tensor(actions), tp, k,
                                     rng_rounds)
        tag = (wrapper, k, rng_rounds, t)
        assert_tstate_equal(jout[0], tout[0], tag)
        for i in (1, 2):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (tag, i)
        assert tuple(tout[3].shape) == (k * fused_tick.obs_rows(tp), E)
        assert_obs_equal(jout[3], tout[3], tag)
        jts, tts = jout[0], tout[0]


# Each case compiles a JAX kernel in interpret mode (15-45 s on a CPU), so
# the cases (window k = 2 and 4, global k = 2, for each kernel) are spread
# over this file and others: B1 at window-2 in the ring engine's test and
# global-2 in tests/test_torch_collect_engines.py; B3 at window-2 in the
# full engine's test and window-4 in tests/test_torch_collect_full.py; B4
# at window-2 in the fused engine's test and window-4 in
# tests/test_torch_collect_stream.py.

def test_ring_tick_plain_collect_matches_jax_window4():
    run_ring_tick("window", 4)


def test_full_tick_plain_collect_matches_jax_global2():
    run_full_tick("global", 2)


def test_env_tick_plain_collect_matches_jax_global2():
    run_env_tick("global", 2)


def test_plain_collect_refuses_outside_the_drones():
    """The wrappers check k against the drones before a launch, as the
    JAX CLI does; on the CPU the checks run in the argument blocks that
    the card's launches fill, so they are held here through them."""
    _, tp = env_params()
    problems = fused_tick.tick_problems(tp, 5, 20)
    assert problems and "collect=5" in problems[0]
    assert fused_tick.tick_problems(tp, 4, 8, 8) == []
    assert "rng_rounds=10" in fused_tick.tick_problems(tp, 1, 10)[0]
    assert "actor_rng_rounds=24" in fused_tick.tick_problems(
        tp, 1, 20, 24)[0]


def test_ring_companions_collect_match_jax():
    """``ring_scalar_writes`` into (2, capacity) rings and
    ``ring_gather_batch``'s (2, batch // 2) draw, bitwise."""
    k, cap, bs, obs_dim = 2, 4 * E, 8, 294
    r = np.random.default_rng(0)
    ring = r.random((k * obs_dim, cap)).astype(np.float32)
    a_ring = r.integers(0, 5, (k, cap)).astype(np.int32)
    r_ring = r.random((k, cap)).astype(np.float32)
    d_ring = r.integers(0, 2, (k, cap)).astype(np.int8)
    acts = r.integers(0, 5, (4, E)).astype(np.int32)
    rews = r.random((4, E)).astype(np.float32)
    dones = r.random((4, E)) < 0.5
    read = 2 * E
    ja, jr, jd = jfused.ring_scalar_writes(
        jnp.asarray(a_ring), jnp.asarray(r_ring), jnp.asarray(d_ring),
        jnp.asarray(acts), jnp.asarray(rews), jnp.asarray(dones), read, k)
    ta, tr, td = (torch.from_numpy(x.copy()) for x in (a_ring, r_ring, d_ring))
    fused_tick.ring_scalar_writes(ta, tr, td, torch.from_numpy(acts),
                                  torch.from_numpy(rews),
                                  torch.from_numpy(dones), read, k)
    for j, t in ((ja, ta), (jr, tr), (jd, td)):
        assert (np.asarray(j) == t.numpy()).all()
    for seed, valid, base in ((0, 3 * E, 5), (1, E, 0), (2, 3 * E, 2)):
        jb = jfused.ring_gather_batch(
            jax.random.PRNGKey(seed), jnp.asarray(ring), ja, jr, jd,
            jnp.int32(valid), jnp.int32(base), num_envs=E, capacity=cap,
            batch_size=bs, collect=k, obs_dim=obs_dim)
        tb = fused_tick.ring_gather_batch(
            rng.PRNGKey(seed), torch.from_numpy(ring), ta, tr, td, valid,
            base, num_envs=E, capacity=cap, batch_size=bs, collect=k,
            obs_dim=obs_dim)
        for key in ("obs", "next_obs", "actions", "rewards", "dones"):
            assert tb[key].shape == jb[key].shape, (seed, key)
            assert (np.asarray(jb[key]) == tb[key].numpy()).all(), (seed, key)
        # The learner kernel reads the batch's columns with unit stride.
        assert tb["obs"].stride(1) == tb["next_obs"].stride(1) == 1


def _jax_engine(num_envs, memory_size, batch_size, k):
    """The JAX CLI's choice for a dense net on a TPU, from its own gate
    arithmetic (dronerl_tpu/train.py: push_size, capacity, ring_capacity,
    use_ring) with ``collect_drones`` = k."""
    push_size = num_envs * k
    capacity = -(-memory_size // push_size) * push_size
    ring_capacity = max(capacity, 2 * push_size)
    skip = jring_skip_reasons(True, ring_capacity, push_size, batch_size, k)
    return ("full" if skip else "ring"), skip


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("num_envs,memory_size,batch_size", [
    (16384, 100_000, 8), (65536, 100_000, 8), (65536, 1_000_000, 8),
    (128, 256, 8), (128, 1024, 8), (128, 1024, 6), (25600, 100_000, 7),
    (32768, 100_000, 64), (128, 513, 9)])
def test_choose_engine_collect_matches_jax_gate(num_envs, memory_size,
                                                batch_size, k):
    args = train.parse_args([
        "--device", "cpu", "--num_envs", str(num_envs), "--memory_size",
        str(memory_size), "--batch_size", str(batch_size),
        "--collect_drones", str(k)])
    expected, jskip = _jax_engine(num_envs, memory_size, batch_size, k)
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        expected)
    push = num_envs * k
    ring_capacity = max(-(-memory_size // push) * push, 2 * push)
    tskip = train.ring_skip_reasons(True, ring_capacity, push, batch_size, k)
    assert len(tskip) == len(jskip)


def test_cli_collect_drones_checks():
    """``--collect_drones`` defaults to 1 and must lie in [1, n_drones],
    as in the JAX CLI."""
    assert train.parse_args(["--device", "cpu"]).collect_drones == 1
    for bad in ("0", "5"):
        with pytest.raises(ValueError, match=r"collect_drones must be in"):
            train.parse_args(["--collect_drones", bad])
    args = train.parse_args(["--collect_drones", "4", "--tau", "0.5"])
    assert args.collect_drones == 4
    assert train.agent_config_from_args(args).tau == 0.5


@pytest.mark.parametrize("argv,engine", [
    (["--num_envs", "64"], "jnp"),
    (["--num_envs", "128", "--memory_size", "512"], "ring"),
    (["--num_envs", "128", "--memory_size", "2048"], "full")])
def test_cli_runs_collect_drones_on_cpu(argv, engine):
    """``--collect_drones 2`` on the three engines the CLI chooses for a
    dense net: the replay takes E · 2 transitions a tick, the ring 2 row
    groups a column."""
    metrics = train.main(["--device", "cpu", "--num_steps", "3",
                          "--collect_drones", "2"] + argv)
    assert metrics["engine"] == engine
    assert metrics["td_loss_mean"] is not None
    assert np.isfinite(metrics["td_loss_mean"])
