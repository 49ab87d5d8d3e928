"""``replay.FeatureMajorReplay`` and ``replay.inspect_memory`` of the
PyTorch port against the JAX package's (``tests/test_replay.py``'s
cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import replay as jax_replay
from dronerl_tpu_torch import rng
from dronerl_tpu_torch import replay


def _template(obs_dim=4):
    return {"obs": torch.zeros((obs_dim,)),
            "actions": torch.zeros((), dtype=torch.int32),
            "rewards": torch.zeros(()),
            "dones": torch.zeros((), dtype=torch.bool)}


def _jax_template(obs_dim=4):
    return {"obs": jnp.zeros((obs_dim,), jnp.float32),
            "actions": jnp.array(0, jnp.int32),
            "rewards": jnp.array(0.0, jnp.float32),
            "dones": jnp.array(False, jnp.bool_)}


@pytest.mark.parametrize("uniform_pushes,n", [(False, 3), (True, 4)])
def test_feature_major_replay_matches_jax(uniform_pushes, n):
    """Pushes that wrap (or, aligned, fill the ring in whole pushes) and
    uniform samples: storage, cursor, size and the sampled columns equal
    the JAX package's bit for bit."""
    capacity, obs_dim = 8, 4
    ours = replay.FeatureMajorReplay(capacity, 5, uniform_pushes)
    theirs = jax_replay.FeatureMajorReplay(capacity, 5, uniform_pushes)
    state = ours.init(_template(obs_dim))
    jstate = theirs.init(_jax_template(obs_dim))
    data = np.random.default_rng(1)
    for i in range(5):
        batch = {"obs": data.random((obs_dim, n)).astype(np.float32),
                 "actions": data.integers(0, 5, n).astype(np.int32),
                 "rewards": data.random(n).astype(np.float32),
                 "dones": data.random(n) < 0.5}
        state = ours.push_many(state, {k: torch.from_numpy(np.asarray(v))
                                       for k, v in batch.items()})
        jstate = theirs.push_many(jstate, batch)
        assert (state.cursor, state.size) == (int(jstate.cursor),
                                              int(jstate.size))
        for name, buf in state.storage.items():
            np.testing.assert_array_equal(buf.numpy(),
                                          np.asarray(jstate.storage[name]))
        assert ours.can_sample(state) == bool(theirs.can_sample(jstate))
        got = ours.sample(rng.PRNGKey(i), state)
        want = theirs.sample(jax.random.PRNGKey(i), jstate)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def _report(inspect, state, **kw):
    lines = []
    counters = inspect(state, printer=lambda s: lines.append(str(s)), **kw)
    return counters, lines


def test_inspect_memory_row_major():
    """Two distinct states three times each: counters and the printed
    report equal the JAX package's."""
    buf = replay.ReplayBuffer(capacity=10, batch_size=4)
    jbuf = jax_replay.ReplayBuffer(capacity=10, batch_size=4)
    template = {**_template(), "next_obs": torch.zeros((4,))}
    state = buf.init(template)
    jstate = jbuf.init({**_jax_template(),
                        "next_obs": jnp.zeros((4,), jnp.float32)})
    for i in range(6):
        v = float(i % 2)
        exp = {"obs": np.full(4, v, np.float32), "actions": np.int32(i % 2),
               "rewards": np.float32(v), "next_obs": np.full(4, v + 1,
                                                            np.float32),
               "dones": np.bool_(i % 2 == 0)}
        state = buf.push(state, {k: torch.as_tensor(v) for k, v in
                                 exp.items()})
        jstate = jbuf.push(jstate, exp)
    counters, lines = _report(replay.inspect_memory, state, top_n=3)
    jcounters, jlines = _report(jax_replay.inspect_memory, jstate, top_n=3)
    assert lines == jlines
    assert counters == jcounters
    assert counters["action"][0] == 3 and counters["action"][1] == 3
    assert counters["done"][True] == 3 and counters["done"][False] == 3
    assert len(counters["state"]) == 2
    assert any("Proportion of done" in ln for ln in lines)


def test_inspect_memory_feature_major():
    """A StreamReplay (slots on the last axis) is recognised: three
    distinct observation vectors, as in JAX."""
    obs_dim, stride = 4, 2
    buf = replay.StreamReplay(capacity=8, batch_size=2, stride=stride)
    jbuf = jax_replay.StreamReplay(capacity=8, batch_size=2, stride=stride)
    state, jstate = buf.init(_template(obs_dim)), jbuf.init(
        _jax_template(obs_dim))
    for i in range(3):
        batch = {"obs": np.full((obs_dim, stride), float(i), np.float32),
                 "actions": np.full((stride,), i, np.int32),
                 "rewards": np.full((stride,), float(i), np.float32),
                 "dones": np.zeros((stride,), bool)}
        state = buf.push_many(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        jstate = jbuf.push_many(jstate, batch)
    counters, lines = _report(replay.inspect_memory, state)
    jcounters, jlines = _report(jax_replay.inspect_memory, jstate)
    assert lines == jlines and counters == jcounters
    assert sum(counters["action"].values()) == 6
    assert counters["action"][2] == 2
    assert len(counters["state"]) == 3


def test_inspect_memory_ambiguous_slot_axis():
    """obs_dim == capacity: the inference refuses, slot_axis=-1 works."""
    obs_dim = capacity = 8
    buf = replay.StreamReplay(capacity=capacity, batch_size=2, stride=2)
    state = buf.init(_template(obs_dim))
    state = buf.push_many(state, {
        "obs": torch.arange(obs_dim * 2, dtype=torch.float32).reshape(
            obs_dim, 2),
        "actions": torch.tensor([1, 2], dtype=torch.int32),
        "rewards": torch.tensor([0.5, 0.5]),
        "dones": torch.tensor([False, False])})
    with pytest.raises(ValueError, match="ambiguous"):
        replay.inspect_memory(state, printer=lambda s: None)
    counters = replay.inspect_memory(state, printer=lambda s: None,
                                     slot_axis=-1)
    assert sum(counters["action"].values()) == 2
