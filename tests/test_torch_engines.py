"""The StreamReplay engines and their kernels' plain versions against JAX.

The plain versions of the three env kernels of this slice run against the
JAX package's kernels in Pallas interpret mode, from the same state,
actions, weights and key:

* ``full_tick_plain`` (B3's) against ``full_tick_fused``, with a reset;
* ``tick_plain`` (B4's) against ``tick_fused`` (grid 9 with 4 drones,
  grid 16 with 25), and against the jnp ``step_batch`` +
  ``observe_batch`` for 10 ticks;
* ``step_kernel.step_batch_fused`` on CPU tensors (B5's plain version)
  against JAX's ``step_batch_fused`` on grid 9, a tight board (more
  respawn slots than vacant cells), boards above 256 cells (the
  evaluator's 20-participant arena among them) and 48 drones.

Env outputs bitwise, except the observation's charge channel (within
1.3e-7, one ULP of charge / 100). Then ``DQN.act_t`` bitwise, and the two
engines (``build_train_step_full`` for 4 ticks, ``build_train_step_fused``
for 3) against the JAX trainers from one carry carried across by
``interop.from_jax``: rng chain, env state, observations, replay and ε
bitwise (charge channel as above), loss within 1e-5 relative and params
within 1e-5 absolute (the learner's tolerances, as
tests/test_torch_train.py). Last, the CLI's engine choice against the JAX
CLI's gate arithmetic.
"""

import logging

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
from dronerl_tpu.ops import step_kernel as jstep
from dronerl_tpu.train import (
    build_train_step_full as jbuild_full,
    build_train_step_fused as jbuild_fused,
    ring_skip_reasons as jring_skip_reasons)
from dronerl_tpu_torch import replay, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import fused_tick, step_kernel

E, BATCH = 128, 8
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _assert_tstate_equal(jt, tt, tag):
    for f, t in zip(fused_tick.TState._fields, tt):
        assert (np.asarray(getattr(jt, f)) == t.numpy()).all(), (tag, f)


def _assert_obs_equal(jobs, tobs, tag):
    """Feature-major observations bitwise except the charge channel."""
    j = np.asarray(jobs).astype(np.float32).reshape(-1, 6, jobs.shape[-1])
    t = tobs.float().numpy().reshape(-1, 6, tobs.shape[-1])
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def _env(seed, jp, num_envs=E):
    states = jcore.reset_batch(jax.random.PRNGKey(seed), jp, num_envs)
    obs_t = jcore.observe_batch(states, jp, 1).reshape(num_envs, -1).T
    return states, jfused.to_tstate(states), obs_t


def test_full_tick_plain_matches_jax_kernel():
    """3 ticks of B3 with a reset at tick 1, ε = 0.5 (greedy and
    exploring envs): state, rewards, dones, actions and obs_t'."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(hidden_layers=(16, 16)), jp)
    ag = ja.init_state(jax.random.PRNGKey(0))
    _, jts, jobs = _env(1, jp)
    net = from_jax.qnet_from_flax(jax.device_get(ag.params))
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    tobs = from_jax.tensor(jax.device_get(jobs)).contiguous()
    eps = 0.5
    key = jax.random.PRNGKey(5)
    for t in range(3):
        key, step_key = jax.random.split(key)
        jout = jfused.full_tick_fused(
            step_key, jts, jobs, ag.params, jnp.float32(eps),
            jnp.asarray(t == 1), jp, 1, True)
        before = tobs.clone()
        tout = fused_tick.full_tick_fused(
            _host_key(step_key), tts, tobs, net.flat(), torch.tensor(eps),
            t == 1, tp)
        _assert_tstate_equal(jout[0], tout[0], t)
        for i in (1, 2, 3):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (t, i)
        assert tout[3].dtype == torch.int32 and tout[4].dtype == torch.float32
        _assert_obs_equal(jout[4], tout[4], t)
        assert torch.equal(tobs, before)  # obs_t is read, not written
        jts, jobs, tts, tobs = jout[0], jout[4], tout[0], tout[4]


def _tick_plain_vs_jax_kernel(kw):
    """2 ticks of B4's plain version against the JAX tick kernel
    (interpret mode) with the caller's actions, at E envs."""
    jp, tp = JParams(**kw), EnvParams(**kw)
    assert jfused.supports(jp, E)
    _, jts, _ = _env(2, jp)
    tts = from_jax.tstate_from_jax(jax.device_get(jts))
    key = jax.random.PRNGKey(7)
    for t in range(2):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (jp.n_drones, E), 0, 5)
        jout = jfused.tick_fused(step_key, jts, actions, jp, 1, True)
        tout = fused_tick.tick_fused(
            _host_key(step_key), tts, from_jax.tensor(actions), tp)
        _assert_tstate_equal(jout[0], tout[0], t)
        for i in (1, 2):
            assert (np.asarray(jout[i]) == tout[i].numpy()).all(), (t, i)
        _assert_obs_equal(jout[3], tout[3], t)
        jts, tts = jout[0], tout[0]


def test_tick_plain_matches_jax_kernel():
    """2 ticks of B4 with the caller's actions."""
    _tick_plain_vs_jax_kernel(KW)


def test_tick_plain_matches_jax_kernel_near_tick_limits():
    """B4 on grid 16 with 25 drones: 8 cells a lane, 250 objects on 256
    cells, drones on 25 of a warp's 32 lanes."""
    _tick_plain_vs_jax_kernel(dict(grid_size=16, n_drones=25))


def test_tick_plain_matches_jnp_step_and_observe():
    """10 ticks of B4's plain version against vmap(core.step) over
    split(step_key, E) and observe_batch, transposed."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    states, _, _ = _env(3, jp)
    tts = fused_tick.to_tstate(_row_state(states))
    step_batch = jax.jit(jcore.step_batch, static_argnums=3)
    key = jax.random.PRNGKey(11)
    for t in range(10):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (E, jp.n_drones), 0, 5)
        states, rew, done = step_batch(jax.random.split(step_key, E), states,
                                       actions, jp)
        obs = jcore.observe_batch(states, jp, 1).reshape(E, -1).T
        tts, trew, tdone, tobs = fused_tick.tick_plain(
            _host_key(step_key), tts, from_jax.tensor(actions).t(), tp)
        _assert_tstate_equal(jfused.to_tstate(states), tts, t)
        assert (np.asarray(rew).T == trew.numpy()).all(), t
        assert (np.asarray(done).T == tdone.numpy()).all(), t
        _assert_obs_equal(obs, tobs, t)


def _row_state(states) -> EnvState:
    return EnvState(*(from_jax.tensor(np.asarray(getattr(states, f)))
                      for f in ("ground", "air_x", "air_y",
                                "carrying_package", "charge")))


@pytest.mark.parametrize("board", ["grid9", "tight", "cells400", "arena20",
                                   "drones48"])
def test_step_batch_plain_matches_jax_step_kernel(board):
    """B5's plain version against the JAX step kernel (interpret mode),
    2 steps at 8 envs: state, rewards and dones bitwise. ``arena20`` is
    the evaluator's arena for 20 participants (grid 20, 20 drones);
    ``drones48`` has more drones than a warp has lanes on a nearly full
    board (480 objects on 484 cells)."""
    kw = {"grid9": dict(grid_size=9, n_drones=4),
          "tight": dict(grid_size=5, n_drones=2),
          "cells400": dict(grid_size=20, n_drones=4),
          "arena20": dict(grid_size=20, n_drones=20),
          "drones48": dict(grid_size=22, n_drones=48)}[board]
    jp, tp = JParams(**kw), EnvParams(**kw)
    num_envs = 8
    assert jstep.supports(jp, num_envs) and step_kernel.supports(tp,
                                                                 num_envs)
    states = jcore.reset_batch(jax.random.PRNGKey(3), jp, num_envs)
    tstates = _row_state(states)
    key = jax.random.PRNGKey(4)
    for t in range(2):
        key, act_key, step_key = jax.random.split(key, 3)
        actions = jax.random.randint(act_key, (num_envs, jp.n_drones), 0, 5)
        jst, jrew, jdone = jstep.step_batch_fused(step_key, states, actions,
                                                  jp, interpret=True)
        tst, trew, tdone = step_kernel.step_batch_fused(
            _host_key(step_key), tstates, from_jax.tensor(actions), tp)
        for f in ("ground", "air_x", "air_y", "carrying_package", "charge"):
            assert (np.asarray(getattr(jst, f))
                    == getattr(tst, f).numpy()).all(), (board, t, f)
        assert (np.asarray(jrew) == trew.numpy()).all(), (board, t)
        assert (np.asarray(jdone) == tdone.numpy()).all(), (board, t)
        states, tstates = jst, tst


def test_step_kernel_limits():
    assert step_kernel.supports(EnvParams(grid_size=22, n_drones=4), 8)
    assert not step_kernel.supports(EnvParams(grid_size=23, n_drones=4), 8)
    assert not step_kernel.supports(EnvParams(**KW), 4)
    assert not step_kernel.supports(
        EnvParams(grid_size=9, n_drones=4, packets_factor=0), 8)


@pytest.mark.parametrize("eps", [0.0, 0.5, 1.0])
def test_act_t_matches_jax(eps):
    """ε-greedy actions bitwise: greedy, mixed and random."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(hidden_layers=(16, 16)), jp)
    ag = ja.init_state(jax.random.PRNGKey(0)).replace(
        epsilon=jnp.float32(eps))
    ta = DQN(DQNConfig(hidden_layers=(16, 16)), tp, device="cpu")
    st = from_jax.dqn_state_from_jax(jax.device_get(ag))
    _, _, jobs = _env(6, jp)
    key = jax.random.PRNGKey(9)
    jact = ja.act_t(key, jobs, ag)
    tact = ta.act_t(_host_key(key), from_jax.tensor(jobs), st)
    assert tact.dtype == torch.int32
    assert (np.asarray(jact) == tact.numpy()).all()


def _jax_stream_carry(ja, jp, buf):
    rng = jax.random.PRNGKey(0)
    states, tstate, obs_t = _env(0, jp)
    template = {
        "obs": jnp.zeros((ja.obs_dim,), jnp.float32),
        "actions": jnp.array(0, jnp.int32),
        "rewards": jnp.array(0.0, jnp.float32),
        "dones": jnp.array(False, jnp.bool_),
    }
    return (rng, tstate, obs_t, ja.init_state(rng), buf.init(template),
            jnp.array(0))


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def _assert_stream_carry_equal(jc, tc, tag):
    jc = jax.device_get(jc)
    assert (np.asarray(jc[0]).astype(np.int64) == tc[0].numpy()).all(), tag
    assert int(jc[-1]) == tc[-1], tag
    _assert_tstate_equal(jc[1], tc[1], tag)
    _assert_obs_equal(jc[2], tc[2], tag)
    jb, tb = jc[4], tc[4]
    assert (int(jb.cursor), int(jb.size)) == (tb.cursor, tb.size), tag
    _assert_obs_equal(jb.storage["obs"], tb.storage["obs"], tag)
    for k in ("actions", "rewards", "dones"):
        assert (np.asarray(jb.storage[k]) == tb.storage[k].numpy()).all(), (
            tag, k)
    for r, o in zip(_flax_leaves(jc[3].params), tc[3].params.flat()):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0, atol=1e-5,
                                   err_msg=str(tag))


@pytest.mark.parametrize("engine", ["full", "fused"])
def test_stream_engine_matches_jax(engine):
    """4 ticks of the full engine or 3 of the fused one from one carry,
    resets at ticks 0 and 3, a replay of 3 env-batches (full, then
    wrapped, by tick 3)."""
    kw = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
              target_update_interval=2, gamma=0.9)
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(**kw), jp)
    ta = DQN(DQNConfig(**kw), tp, device="cpu")
    jbuf = jreplay.StreamReplay(capacity=3 * E, batch_size=BATCH, stride=E)
    tbuf = replay.StreamReplay(3 * E, BATCH, stride=E)
    jbuild, tbuild, ticks = {
        "full": (jbuild_full, train.build_train_step_full, 4),
        "fused": (jbuild_fused, train.build_train_step_fused, 3)}[engine]
    jtick = jbuild(ja, jbuf, jp, E, 1, 3, interpret=True)
    ttick = tbuild(ta, tbuf, tp, E, 3)
    jc = _jax_stream_carry(ja, jp, jbuf)
    tc = from_jax.stream_carry_from_jax(jax.device_get(jc))
    losses = []
    for t in range(ticks):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        _assert_stream_carry_equal(jc, tc, (engine, t))
        assert (np.asarray(jrew) == trew.numpy()).all(), (engine, t)
        assert np.float32(teps.item()) == np.asarray(jeps), (engine, t)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        losses.append(float(tloss))
    # The replay holds a batch from the second push on.
    assert losses[0] == -1.0 and min(losses[1:]) >= 0


def test_init_stream_carry_layout():
    tp = EnvParams(**KW)
    ta = DQN(DQNConfig(hidden_layers=(16,)), tp, device="cpu")
    buf = replay.StreamReplay(4 * E, BATCH, stride=E)
    rng, tstate, obs_t, ag, bstate, step = train.init_stream_carry(
        ta, tp, E, buf, torch.tensor([0, 7], dtype=torch.int64))
    assert rng.device.type == "cpu" and step == 0
    assert obs_t.dtype == torch.float32 and tuple(obs_t.shape) == (294, E)
    assert obs_t.is_contiguous() and obs_t.any()
    assert (bstate.cursor, bstate.size) == (0, 0)
    assert {k: v.dtype for k, v in bstate.storage.items()} == {
        "obs": torch.float32, "actions": torch.int32,
        "rewards": torch.float32, "dones": torch.bool}
    assert tuple(bstate.storage["obs"].shape) == (294, 4 * E)
    # Two drones collected: (2 obs_dim, E) observations, pushes of 2 E.
    buf2 = replay.StreamReplay(4 * E, BATCH, stride=2 * E)
    carry = train.init_stream_carry(ta, tp, E, buf2, rng, collect_drones=2)
    assert tuple(carry[2].shape) == (2 * 294, E)
    tick = train.build_train_step_full(ta, buf2, tp, E, 100, collect_drones=2)
    carry, _ = tick(carry)
    assert tuple(carry[2].shape) == (2 * 294, E) and carry[4].size == 2 * E


def _jax_engine(num_envs, memory_size, batch_size):
    """The JAX CLI's choice for a dense net on a TPU, from its own gate
    arithmetic (train.py: push_size, capacity, ring_capacity, use_ring)."""
    push_size = num_envs
    capacity = -(-memory_size // push_size) * push_size
    ring_capacity = max(capacity, 2 * push_size)
    skip = jring_skip_reasons(True, ring_capacity, push_size, batch_size, 1)
    return ("full" if skip else "ring"), skip


@pytest.mark.parametrize("num_envs,memory_size,batch_size", [
    (16384, 100_000, 8), (65536, 100_000, 8), (65536, 1_000_000, 8),
    (128, 256, 8), (128, 512, 8), (128, 513, 8), (128, 1024, 32),
    (25600, 100_000, 8), (32768, 100_000, 64)])
def test_cli_engine_choice_matches_jax_gate(num_envs, memory_size,
                                            batch_size):
    args = train.parse_args([
        "--device", "cpu", "--num_envs", str(num_envs), "--memory_size",
        str(memory_size), "--batch_size", str(batch_size)])
    expected, jskip = _jax_engine(num_envs, memory_size, batch_size)
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        expected)
    push = num_envs
    ring_capacity = max(-(-memory_size // push) * push, 2 * push)
    tskip = train.ring_skip_reasons(True, ring_capacity, push, batch_size, 1)
    assert len(tskip) == len(jskip)


def test_cli_engine_flags(caplog):
    """``--engine jnp`` runs the jnp engine at any size; ``auto`` does below
    128 envs and where the kernels' limits fail (grid 17: 289 cells), as
    the JAX gate does, and says why; ``--engine fused`` there raises,
    naming the reason."""
    args = train.parse_args(["--device", "cpu", "--engine", "jnp",
                             "--num_envs", "128", "--memory_size", "256"])
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        "jnp")
    args = train.parse_args(["--device", "cpu", "--num_envs", "64",
                             "--memory_size", "1000"])
    with caplog.at_level(logging.INFO, logger="dronerl_tpu_torch.train"):
        assert train.choose_engine(args, train.env_params_from_args(
            args)) == "jnp"
    assert "Engine: jnp" in caplog.text and "< 128" in caplog.text
    args = train.parse_args(["--device", "cpu", "--grid_size", "17",
                             "--num_envs", "128"])
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        "jnp")
    args = train.parse_args(["--device", "cpu", "--grid_size", "17",
                             "--num_envs", "128", "--engine", "fused"])
    with pytest.raises(ValueError, match="289 cells"):
        train.choose_engine(args, train.env_params_from_args(args))


def test_cli_runs_full_engine_on_cpu():
    """The issue's example: 1,024 slots > 4 x 128 chooses the full engine."""
    metrics = train.main([
        "--device", "cpu", "--num_envs", "128", "--memory_size", "1024",
        "--num_steps", "3"])
    assert metrics["engine"] == "full" and metrics["device"] == "cpu"
    assert metrics["td_loss_mean"] is not None
    assert np.isfinite(metrics["td_loss_mean"])
