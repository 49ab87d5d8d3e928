"""The jnp engine, the row-major replay and the initial nets against JAX.

* ``DQN.init_state(PRNGKey(seed))`` against the JAX ``DQN.init_state``:
  every kernel and bias of the online and the target net bitwise (flax's
  per-parameter keys, jax's truncated normal through XLA's f32 erf⁻¹),
  and ``rng.fold_in`` / ``rng.truncated_normal`` bitwise on their own;
  the trainers' initial carries hold the same nets.
* The row-major ``ReplayBuffer`` against ``dronerl_tpu.replay``: storage,
  cursor, size and samples bitwise over pushes that wrap.
* The port's jnp tick (``train.build_train_step``) against
  ``dronerl_tpu.train.build_train_step`` for 8 ticks from carries that each
  package builds from the same key (no weights carried across): rng, env
  state, observations, rewards, dones, replay and ε bitwise, except the
  observation's charge channel, within 1.3e-7 (one ULP of charge / 100,
  which XLA may turn into a reciprocal multiply); the loss
  within rtol 1e-5 and the params within atol 1e-5 (the learner's
  tolerances, as tests/test_torch_train.py).
* The CLI's engine choice against the JAX gate below 128 envs and off the
  128-lane grid, and a CLI run of the jnp engine.
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
from dronerl_tpu.train import (
    build_train_step as jbuild, fused_engine_problems as jproblems,
    init_ring_carry as jinit_ring, ring_skip_reasons as jring_skip_reasons)
from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams

KW = dict(grid_size=9, n_drones=4)
ENV_FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
CHARGE_ATOL = 1.3e-7


def _key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _assert_obs_equal(jobs, tobs, tag):
    """Row-major observations (channels last) bitwise but the charge
    channel."""
    j = np.asarray(jobs).reshape(-1, 6)
    t = tobs.numpy().reshape(-1, 6)
    ch = np.arange(6) != 4
    assert (j[:, ch] == t[:, ch]).all(), tag
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=CHARGE_ATOL,
                               err_msg=str(tag))


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def _assert_nets_bitwise(jstate, tstate, tag):
    for jtree, net in ((jstate.params, tstate.params),
                       (jstate.target_params, tstate.target_params)):
        for r, t in zip(_flax_leaves(jtree), net.flat()):
            t = t.detach().cpu().numpy()
            assert r.shape == t.shape, tag
            assert (r.view(np.int32) == t.view(np.int32)).all(), tag


# --- the initial nets --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("hidden", [(16, 16), (128, 64), (8,), (32, 16)])
def test_init_state_matches_jax(hidden, seed):
    """Online and target nets bitwise, moments zero, ε at its start."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    js = JDQN(JConfig(hidden_layers=hidden), jp).init_state(
        jax.random.PRNGKey(seed))
    ts = DQN(DQNConfig(hidden_layers=hidden), tp, device="cpu").init_state(
        rng.PRNGKey(seed))
    _assert_nets_bitwise(js, ts, (hidden, seed))
    assert ts.opt_state.count == 0
    assert all(not m.any() for m in ts.opt_state.mu + ts.opt_state.nu)
    assert float(ts.epsilon) == float(js.epsilon)


def test_fold_in_and_truncated_normal_match_jax():
    key = jax.random.PRNGKey(7)
    for data in (0, 1, 12345, 2**31, 2**32 - 1):
        assert (np.asarray(jax.random.fold_in(key, jnp.uint32(data)))
                .astype(np.int64) == rng.fold_in(_key(key), data).numpy()
                ).all(), data
    for seed, shape in ((0, (294, 128)), (3, (5000,)), (9, (64, 5))):
        k = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.truncated_normal(k, -2.0, 2.0, shape))
        out = rng.truncated_normal(_key(k), -2.0, 2.0, shape).numpy()
        assert (ref.view(np.int32) == out.view(np.int32)).all(), seed
        assert out.min() > -2.0 and out.max() < 2.0


def test_init_carries_match_jax():
    """The ring and StreamReplay carries draw their nets from the carry's
    key, as the JAX trainer does (``init_ring_carry``; the CLI's
    ``agent.init_state(rng)`` beside the reset)."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    hidden, e = (16, 16), 128
    ja = JDQN(JConfig(hidden_layers=hidden), jp)
    ta = DQN(DQNConfig(hidden_layers=hidden), tp, device="cpu")
    key = jax.random.PRNGKey(4)
    jring = jinit_ring(ja, jp, e, 2 * e, key)
    tring = train.init_ring_carry(ta, tp, e, 2 * e, _key(key))
    _assert_nets_bitwise(jring[3], tring[3], "ring")
    buf = replay.StreamReplay(2 * e, 8, stride=e)
    tstream = train.init_stream_carry(ta, tp, e, buf, _key(key))
    _assert_nets_bitwise(ja.init_state(key), tstream[3], "stream")
    tjnp = train.init_jnp_carry(ta, tp, 4, replay.ReplayBuffer(16, 8),
                                _key(key))
    _assert_nets_bitwise(ja.init_state(key), tjnp[3], "jnp")


# --- the row-major replay ----------------------------------------------------

def _template(np_mod):
    return {"obs": np_mod.zeros((6,), np_mod.float32),
            "actions": np_mod.zeros((), np_mod.int32),
            "dones": np_mod.zeros((), np_mod.bool_)}


def _assert_replay_equal(js, ts, tag):
    assert (int(js.cursor), int(js.size)) == (ts.cursor, ts.size), tag
    for name, buf in ts.storage.items():
        assert (np.asarray(js.storage[name]) == buf.numpy()).all(), (tag, name)


@pytest.mark.parametrize("capacity,n,aligned", [(10, 4, False),
                                                (12, 4, True)])
def test_replay_buffer_matches_jax(capacity, n, aligned):
    """Pushes of n (the first wrap of an unaligned ring at the third), one
    single push, and a sample after every push: bitwise."""
    r = np.random.default_rng(0)
    jbuf = jreplay.ReplayBuffer(capacity, batch_size=5, uniform_pushes=aligned)
    tbuf = replay.ReplayBuffer(capacity, batch_size=5, uniform_pushes=aligned)
    js = jbuf.init({k: jnp.asarray(v) for k, v in _template(np).items()})
    ts = tbuf.init({k: torch.from_numpy(np.asarray(v))
                    for k, v in _template(np).items()})
    _assert_replay_equal(js, ts, "init")
    key = jax.random.PRNGKey(3)
    for t in range(6):
        items = {"obs": r.random((n, 6)).astype(np.float32),
                 "actions": r.integers(0, 5, n).astype(np.int32),
                 "dones": r.random(n) < 0.5}
        js = jbuf.push_many(js, {k: jnp.asarray(v) for k, v in items.items()})
        ts = tbuf.push_many(ts, {k: torch.from_numpy(v)
                                 for k, v in items.items()})
        _assert_replay_equal(js, ts, t)
        assert bool(jbuf.can_sample(js)) == tbuf.can_sample(ts), t
        key, sample_key = jax.random.split(key)
        jsample = jbuf.sample(sample_key, js)
        tsample = tbuf.sample(_key(sample_key), ts)
        for name in items:
            assert (np.asarray(jsample[name])
                    == tsample[name].numpy()).all(), (t, name)
    one = {"obs": np.ones(6, np.float32), "actions": np.int32(3),
           "dones": np.bool_(True)}
    js = jbuf.push(js, {k: jnp.asarray(v) for k, v in one.items()})
    ts = tbuf.push(ts, {k: torch.from_numpy(np.asarray(v))
                        for k, v in one.items()})
    _assert_replay_equal(js, ts, "push")


def test_replay_buffer_cold_sample():
    """A sample of an empty buffer draws slot 0 (randint's span of 1), as
    the JAX buffer does; ``can_sample`` gates its use."""
    tbuf = replay.ReplayBuffer(8, batch_size=3)
    ts = tbuf.init({k: torch.from_numpy(np.asarray(v))
                    for k, v in _template(np).items()})
    assert not tbuf.can_sample(ts)
    out = tbuf.sample(rng.PRNGKey(0), ts)
    assert tuple(out["obs"].shape) == (3, 6) and not out["obs"].any()


# --- the jnp tick ------------------------------------------------------------

E, MEMORY, BATCH, RESET_EVERY, TICKS = 4, 64, 8, 5, 8


def _jax_carry(ja, jp, jbuf, key, k):
    states = jcore.reset_batch(key, jp, E)
    obs = jcore.observe_batch(states, jp, k).reshape(E, k, ja.obs_dim)
    template = {
        "obs": jnp.zeros((ja.obs_dim,), jnp.float32),
        "actions": jnp.array(0, jnp.int32),
        "rewards": jnp.array(0.0, jnp.float32),
        "next_obs": jnp.zeros((ja.obs_dim,), jnp.float32),
        "dones": jnp.array(False, jnp.bool_),
    }
    return (key, states, obs, ja.init_state(key), jbuf.init(template),
            jnp.array(0))


@pytest.mark.parametrize("collect_drones", [1, 2])
def test_jnp_tick_matches_jax(collect_drones):
    """8 ticks at 4 envs, memory 64, batch 8, reset every 5 (ticks 0 and
    5), ε decay and target sync every 2 ticks; one or two drones of every
    env feed the replay, which trains from the tick that fills a batch."""
    k = collect_drones
    kw = dict(hidden_layers=(16, 16), epsilon_decay=0.9,
              epsilon_decay_every=2, target_update_interval=2, gamma=0.9)
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja, ta = JDQN(JConfig(**kw), jp), DQN(DQNConfig(**kw), tp, device="cpu")
    jbuf = jreplay.ReplayBuffer(MEMORY, BATCH, uniform_pushes=True)
    tbuf = replay.ReplayBuffer(MEMORY, BATCH, uniform_pushes=True)
    jtick = jax.jit(jbuild(ja, jbuf, jp, E, k, RESET_EVERY))
    ttick = train.build_train_step(ta, tbuf, tp, E, RESET_EVERY, k)
    key = jax.random.PRNGKey(0)
    jc = _jax_carry(ja, jp, jbuf, key, k)
    tc = train.init_jnp_carry(ta, tp, E, tbuf, _key(key), k)
    losses = []
    for t in range(TICKS):
        jc, (jrew, jeps, jloss) = jtick(jc, None)
        tc, (trew, teps, tloss) = ttick(tc)
        jc = jax.device_get(jc)
        assert (np.asarray(jc[0]).astype(np.int64) == tc[0].numpy()).all(), t
        assert int(jc[-1]) == tc[-1] == t + 1
        for f in ENV_FIELDS:
            assert (np.asarray(getattr(jc[1], f))
                    == getattr(tc[1], f).numpy()).all(), (t, f)
        _assert_obs_equal(jc[2], tc[2], t)
        assert (np.asarray(jrew) == trew.numpy()).all(), t
        assert np.float32(teps.item()) == np.asarray(jeps), t
        jb, tb = jc[4], tc[4]
        assert (int(jb.cursor), int(jb.size)) == (tb.cursor, tb.size), t
        for name in ("obs", "next_obs"):
            _assert_obs_equal(jb.storage[name], tb.storage[name], (t, name))
        for name in ("actions", "rewards", "dones"):
            assert (np.asarray(jb.storage[name])
                    == tb.storage[name].numpy()).all(), (t, name)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        for r, o in zip(_flax_leaves(jc[3].params), tc[3].params.flat()):
            np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                       atol=1e-5, err_msg=str(t))
        losses.append(float(tloss))
    first = -(-BATCH // (E * k)) - 1  # the first tick that holds a batch
    assert losses[:first] == [-1.0] * first and min(losses[first:]) >= 0.0


def test_act_matches_jax():
    """Row-major ε-greedy actions bitwise at ε = 0.5."""
    jp, tp = JParams(**KW), EnvParams(**KW)
    ja = JDQN(JConfig(hidden_layers=(16, 16)), jp)
    ta = DQN(DQNConfig(hidden_layers=(16, 16)), tp, device="cpu")
    key = jax.random.PRNGKey(2)
    js = ja.init_state(key).replace(epsilon=jnp.float32(0.5))
    ts = ta.init_state(_key(key))
    ts.epsilon = torch.tensor(0.5)
    states = jcore.reset_batch(jax.random.PRNGKey(5), jp, 64)
    obs = jcore.observe_batch(states, jp, 1)[:, 0]
    act_key = jax.random.PRNGKey(6)
    jact = ja.act(act_key, obs, js)
    tact = ta.act(_key(act_key), torch.from_numpy(np.array(obs)), ts)
    assert tact.dtype == torch.int32
    assert (np.asarray(jact) == tact.numpy()).all()


# --- the engine choice -------------------------------------------------------

def _jax_engine(num_envs, memory_size, batch_size, kw=KW):
    """The JAX CLI's choice for a dense net with the card in the TPU's
    place: jnp where ``fused_engine_problems`` finds a reason other than
    the backend, else ring or full by the ring gate."""
    problems = [p for p in jproblems(JParams(**kw), num_envs)
                if not p.startswith("backend")]
    if problems:
        return "jnp"
    push = num_envs
    ring = max(-(-memory_size // push) * push, 2 * push)
    return "full" if jring_skip_reasons(True, ring, push, batch_size,
                                        1) else "ring"


@pytest.mark.parametrize("num_envs", [1, 64, 200, 256])
def test_choose_engine_matches_jax_gate(num_envs):
    args = train.parse_args(["--device", "cpu", "--num_envs", str(num_envs),
                             "--memory_size", "1000"])
    assert train.choose_engine(args, train.env_params_from_args(args)) == (
        _jax_engine(num_envs, 1000, 8))


def test_cli_runs_jnp_engine_on_cpu(tmp_path):
    """The CLI's default single env trains on the jnp engine."""
    metrics = train.main(["--device", "cpu", "--num_envs", "1",
                          "--num_steps", "20", "--skip_final_eval",
                          "--run_dir", str(tmp_path)])
    assert metrics["engine"] == "jnp" and metrics["device"] == "cpu"
    assert metrics["td_loss_mean"] is not None
    assert np.isfinite(metrics["td_loss_mean"])
    assert metrics["epsilon"] < 1.0
